"""Port of the quadratic-form ops (eftpipe_tpu_torch/ops/quadform.py) against
the JAX module (eftpipe_tpu/ops/pallas_kernels.py): same NumPy inputs from a
seed through both sides.  On the CPU the port's wrappers take their plain
versions; the Pallas kernels run in interpret mode."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from eftpipe_tpu.ops import pallas_kernels as jk
from eftpipe_tpu_torch.ops import quadform as tq

W, N, S, BL = 12, 33, 10, 7   # the shapes of tests/test_quadform.py


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal(shape) for shape in
                 [(W, N, S), (W, N, S), (BL, N, N), (BL, N, N)])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built and run on the card only")
    return torch.device("cuda")


def t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def test_qf_real_plain_matches_xla(data):
    """float64, identical inputs: 1e-12 relative (same two einsums)."""
    zr, _, mr, _ = data
    want = np.asarray(jk.qf_real_xla(jnp.asarray(zr), jnp.asarray(mr)))
    got = tq.qf_real_plain(t(zr), t(mr)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_cf_contract_plain_matches_xla(data):
    zr, zi, mr, mi = data
    want = np.asarray(jk.cf_contract_xla(*map(jnp.asarray, data)))
    got = tq.cf_contract_plain(t(zr), t(zi), t(mr), t(mi)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    z, m = zr + 1j * zi, mr + 1j * mi
    dense = np.einsum("wns,bnm,wms->wbs", z, m, z).real
    np.testing.assert_allclose(got, dense, rtol=1e-10, atol=1e-12 * np.abs(dense).max())


@pytest.mark.parametrize("op", ["quad_form_real", "cf_contract", "quad_form"])
def test_public_ops_on_cpu_take_plain_and_keep_leading_axes(data, op):
    """Public ops: (W, N, S) and extra leading axes; equal to the JAX public
    op under vmap (1e-10, float64)."""
    zr, zi, mr, mi = data
    if op == "quad_form_real":
        got = tq.quad_form_real(t(zr), t(mr)).numpy()
        want = np.asarray(jax.vmap(lambda a: jk.quad_form_real(a, jnp.asarray(mr)))(jnp.asarray(zr)))
        got4 = tq.quad_form_real(t(zr).reshape(3, 4, N, S), t(mr)).numpy()
    else:
        fn = getattr(tq, op)
        got = fn(t(zr), t(zi), t(mr), t(mi)).numpy()
        want = np.asarray(jax.vmap(
            lambda a, b: jk.quad_form(a, b, jnp.asarray(mr), jnp.asarray(mi)))(
                jnp.asarray(zr), jnp.asarray(zi)))
        got4 = fn(t(zr).reshape(3, 4, N, S), t(zi).reshape(3, 4, N, S), t(mr), t(mi)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12 * np.abs(want).max())
    np.testing.assert_array_equal(got4.reshape(got.shape), got)


def test_qf_real_plain_matches_pallas_interpret():
    """The shapes of test_qf_real_pallas_interpret_matches_xla (non-multiple
    BL, non-128 lanes), float32.  Tolerance rtol 2e-4 + 2e-3·max|ref|: the
    Pallas kernel multiplies in three bf16 passes and sums N² terms in
    another order."""
    rng = np.random.default_rng(5)
    nw, n, s, bl, g = 8, 33, 20, 11, 4
    w = rng.standard_normal((nw, n, s)).astype(np.float32)
    m = rng.standard_normal((bl, n, n)).astype(np.float32)
    m = m + np.swapaxes(m, -1, -2)
    wg = jnp.swapaxes(jnp.asarray(w).reshape(nw // g, g, n, s), 1, 2).reshape(nw // g, n, g * s)
    pal = np.asarray(jk.qf_real_pallas(wg, jnp.asarray(m), tile_bl=8, interpret=True))
    pal = pal.reshape(nw // g, bl, g, s).transpose(0, 2, 1, 3).reshape(nw, bl, s)
    got = tq.quad_form_real(t(w, torch.float32), t(m, torch.float32)).numpy()
    np.testing.assert_allclose(got, pal, rtol=2e-4, atol=2e-3 * np.abs(pal).max())


def test_cf_half_plain_matches_pallas_interpret(data):
    """Both halves against ``_cf_half`` in interpret mode and the combined op
    against ``cf_contract_pallas`` (float32, rtol 2e-4 + 2e-3·max|ref|)."""
    zr, zi, mr, mi = (np.asarray(x, np.float32) for x in data)
    o1, o2 = jk._cf_half(jnp.asarray(mr), jnp.asarray(zr), jnp.asarray(zi), 8, True)
    g1, g2 = tq.cf_half_plain(t(mr, torch.float32), t(zr, torch.float32), t(zi, torch.float32))
    for got, want in ((g1, o1), (g2, o2)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-3 * np.abs(want).max())
    pal = np.asarray(jk.cf_contract_pallas(*map(jnp.asarray, (zr, zi, mr, mi)),
                                           tile_bl=8, interpret=True))
    got = tq.cf_contract(*(t(x, torch.float32) for x in (zr, zi, mr, mi))).numpy()
    np.testing.assert_allclose(got, pal, rtol=2e-4, atol=2e-3 * np.abs(pal).max())


@pytest.mark.parametrize("n1", [9, 33])
def test_fold_helpers_bitwise(n1):
    """Host NumPy copies: bitwise equal to the JAX package's."""
    rng = np.random.default_rng(n1)
    m = rng.standard_normal((3, n1, n1)) + 1j * rng.standard_normal((3, n1, n1))
    np.testing.assert_array_equal(tq.herm_fold_matrix(n1), jk.herm_fold_matrix(n1))
    f = tq.herm_fold(m)
    np.testing.assert_array_equal(f, jk.herm_fold(m))
    np.testing.assert_array_equal(tq.trim_nyquist(f, n1 // 2), jk.trim_nyquist(f, n1 // 2))
    # the fold is the congruence Re(Aᵀ M A)
    a = tq.herm_fold_matrix(n1)
    np.testing.assert_allclose(f, np.real(np.einsum("ni,bnm,mj->bij", a, m, a)), atol=1e-12)


@pytest.mark.parametrize("nh_full", [True, False])
def test_herm_w_matches_jax(nh_full):
    rng = np.random.default_rng(2)
    nc, s, nw = 8, 5, 3
    nh = nc + 1 if nh_full else nc
    cre, cim = rng.standard_normal((2, nw, 2 * nc + 1))
    pr, pi = rng.standard_normal((2, nh, s))
    want = np.asarray(jk.herm_w((jnp.asarray(cre), jnp.asarray(cim)),
                                (jnp.asarray(pr), jnp.asarray(pi)), nc))
    got = tq.herm_w((t(cre), t(cim)), (t(pr), t(pi)), nc)
    assert got.is_contiguous() and got.shape == (nw, 2 * nh - 1, s)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-15)


def test_gradcheck_quad_form_real():
    rng = np.random.default_rng(3)
    w = t(rng.standard_normal((3, 9, 5))).requires_grad_(True)
    m = t(rng.standard_normal((4, 9, 9)))
    assert torch.autograd.gradcheck(tq.quad_form_real, (w, m))
    # and equal to the JAX custom-JVP gradient of the same scalar
    g = torch.autograd.grad(tq.quad_form_real(w, m).sum(), w)[0].numpy()
    jm = jnp.asarray(m.numpy())
    gj = jax.grad(lambda x: jnp.sum(jax.vmap(lambda a: jk.quad_form_real(a, jm))(x)))(
        jnp.asarray(w.detach().numpy()))
    np.testing.assert_allclose(g, np.asarray(gj), rtol=1e-10, atol=1e-12)


def test_gradcheck_cf_contract():
    rng = np.random.default_rng(4)
    zr = t(rng.standard_normal((3, 9, 5))).requires_grad_(True)
    zi = t(rng.standard_normal((3, 9, 5))).requires_grad_(True)
    mr, mi = t(rng.standard_normal((4, 9, 9))), t(rng.standard_normal((4, 9, 9)))
    assert torch.autograd.gradcheck(tq.cf_contract, (zr, zi, mr, mi))


def test_wrappers_refuse_cpu_tensors_and_count_nothing(data):
    """The CUDA wrappers raise on what the kernel does not take; the public op
    on a CPU tensor launches nothing."""
    zr, zi, mr, _ = data
    tq.reset_launch_counts()
    with pytest.raises(ValueError):
        tq.qf_real_cuda(t(zr), t(mr))
    with pytest.raises(ValueError):
        tq.cf_half_cuda(t(mr), t(zr), t(zi))
    tq.quad_form_real(t(zr), t(mr))
    assert tq.LAUNCHES == {"qf_real": 0, "cf_half": 0} and not tq.LAUNCHES_BY_SHAPE


@pytest.mark.parametrize("n, multiple, n_padded", [(33, 8, 40), (255, 8, 256), (32, 8, 32)])
def test_tril_fold_keeps_the_quadratic_forms(n, multiple, n_padded):
    """The layout the kernels read: lower triangular, zero-padded, and the
    same forms as the full matrix — zᵀ L z = zᵀ M z, and both outputs of the
    half kernel (float64, 1e-12 of the largest value: the sums are reordered)."""
    rng = np.random.default_rng(5)
    m = t(rng.standard_normal((3, n, n)))
    zr, zi = t(rng.standard_normal((2, n, 4))), t(rng.standard_normal((2, n, 4)))
    low = tq.tril_fold(m, multiple)
    assert low.shape == (3, n_padded, n_padded) and low.is_contiguous()
    assert low.data_ptr() % 16 == 0
    assert torch.equal(low, torch.tril(low)) and low[:, n:, :].abs().sum() == 0
    assert torch.equal(low.diagonal(dim1=-2, dim2=-1)[:, :n], m.diagonal(dim1=-2, dim2=-1))
    pad = lambda z: torch.nn.functional.pad(z, (0, 0, 0, n_padded - n))

    def close(got, want):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12 * float(want.abs().max()))

    close(tq.qf_real_plain(pad(zr), low), tq.qf_real_plain(zr, m))
    for got, want in zip(tq.cf_half_plain(low, pad(zr), pad(zi)), tq.cf_half_plain(m, zr, zi)):
        close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_plain_on_card(cuda, data, dtype):
    """float32: rtol 2e-4 + 2e-3·max|ref| against the float64 plain version;
    float64: 1e-10 (an indexing fault fails this, rounding does not)."""
    zr, zi, mr, _ = (torch.as_tensor(x, dtype=dtype, device=cuda) for x in data)
    tol = dict(rtol=2e-4, atol=2e-3) if dtype == torch.float32 else dict(rtol=1e-10, atol=1e-10)
    tq.reset_launch_counts()
    ref = tq.qf_real_plain(zr.double(), mr.double())
    got = tq.quad_form_real(zr, mr).double()
    assert torch.allclose(got, ref, rtol=tol["rtol"], atol=tol["atol"] * float(ref.abs().max()))
    r1, r2 = tq.cf_half_plain(mr.double(), zr.double(), zi.double())
    g1, g2 = tq.cf_half_cuda(mr, zr, zi)
    for g, r in ((g1, r1), (g2, r2)):
        assert torch.allclose(g.double(), r, rtol=tol["rtol"], atol=tol["atol"] * float(r.abs().max()))
    assert tq.LAUNCHES == {"qf_real": 1, "cf_half": 1}
