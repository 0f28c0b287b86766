"""The port's tests that need the card (marker ``gpu``; skipped where there is
no CUDA device).  This file imports only torch, numpy and the port, so that
it runs where JAX is not installed; ``tests/conftest.py`` sets JAX up, so
skip it there:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

The CUDA kernels are built at first use from ``eftpipe_tpu_torch/csrc/``."""

import numpy as np
import pytest
import torch

from eftpipe_tpu_torch.ops import quadform as tq
from eftpipe_tpu_torch.parallel.mcmc import MCMCDriver

MEAN = np.array([1.0, -2.0, 0.5])
SIGMA_DRIVER = np.array([0.3, 0.7, 1.1])   # tests/test_mcmc.py


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels and the samplers' device path run on the card only")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(12, 33, 10, 7), (3, 255, 80, 11), (3, 257, 80, 11),
                                   (13, 255, 80, 114), (13, 257, 80, 38)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_plain_on_card(cuda, dtype, shape):
    """float32 (3xTF32 tensor cores): rtol 2e-4 + 2e-3·max|ref| against the
    float64 plain version; float64 (float64 tensor cores): 1e-10 (an indexing
    fault fails this, rounding does not).  The ragged shape of
    tests/test_quadform.py and the flagship's N = 255 / 257 at S = 80, W·S
    (240, 1040) no multiple of the kernels' column tiles (64 and 128 columns
    of w, 32 and 64 of [zr | zi]); the layout made once (``kernel_matrices``)
    and the one made on the fly give bitwise the same result."""
    nw, n, s, bl = shape
    rng = np.random.default_rng(n)
    zr, zi, mr = (torch.as_tensor(rng.standard_normal(sh), dtype=dtype, device=cuda)
                  for sh in [(nw, n, s), (nw, n, s), (bl, n, n)])
    tol = dict(rtol=2e-4, atol=2e-3) if dtype == torch.float32 else dict(rtol=1e-10, atol=1e-10)
    tq.reset_launch_counts()
    ref = tq.qf_real_plain(zr.double(), mr.double())
    got = tq.quad_form_real(zr, mr).double()
    assert torch.allclose(got, ref, rtol=tol["rtol"], atol=tol["atol"] * float(ref.abs().max()))
    lay = tq.kernel_matrices(mr)
    assert torch.equal(tq.quad_form_real(zr, mr, lay).double(), got)
    r1, r2 = tq.cf_half_plain(mr.double(), zr.double(), zi.double())
    g1, g2 = tq.cf_half_cuda(mr, zr, zi)
    for g, r in ((g1, r1), (g2, r2)):
        assert torch.allclose(g.double(), r, rtol=tol["rtol"], atol=tol["atol"] * float(r.abs().max()))
    p1, p2 = tq.cf_half_cuda(mr, zr, zi, lay)
    assert torch.equal(p1, g1) and torch.equal(p2, g2)
    assert tq.LAUNCHES == {"qf_real": 2, "cf_half": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["stretch", "hmc"])
def test_block_stays_on_the_card(cuda, kind):
    """A block of steps on the card reads nothing back to the host, and the
    driver runs there by default."""
    mean = torch.as_tensor(MEAN, device=cuda)
    sigma = torch.as_tensor(SIGMA_DRIVER, device=cuda)

    def lp(x):
        return -0.5 * (((x - mean) / sigma) ** 2).sum(-1)

    driver = MCMCDriver(logp=lp, ndim=3, nwalkers=16, rhat_tol=-1.0, block=10,
                        sampler_kind=kind, n_leapfrog=4, warmup_steps=10)
    res = driver.run(seed=0, x0=np.zeros(3), max_steps=10)   # warmup, compiled paths
    assert res.chain.shape == (10, 16, 3) and np.all(np.isfinite(res.logps))
    gen = torch.Generator(device=cuda).manual_seed(1)
    walkers = torch.as_tensor(res.chain[-1], device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        chain, logps, acc = driver.sampler.run(gen, walkers, 5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert chain.is_cuda and chain.shape == (5, 16, 3)
    assert bool(torch.isfinite(logps).all())
