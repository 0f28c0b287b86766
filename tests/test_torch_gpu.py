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


@pytest.mark.gpu
def test_recomb_scan_matches_plain_on_card(cuda):
    """``recomb_scan`` (one thread per cosmology walks the Peebles/T_M
    recurrence) against its plain step loop on the same card inputs: three
    cosmologies on a 1024-point grid, relative error ≤ 1e-10 (FMA contraction
    and the card's pow/exp, ~1 ulp an operation); one launch; a backward
    through the kernel raises (it differentiates in forward mode only)."""
    from eftpipe_tpu_torch.boltzmann import _kernels, thermo

    par = thermo.CosmoParams(
        omega_b=torch.tensor([0.0224, 0.020, 0.027], dtype=torch.float64, device=cuda),
        omega_cdm=torch.tensor([0.12, 0.08, 0.25], dtype=torch.float64, device=cuda),
        h=torch.tensor([0.68, 0.6, 0.8], dtype=torch.float64, device=cuda),
        ln10As=3.044, ns=0.9649, m_ncdm=0.02, n_ur=0.00641, deg_ncdm=3.0)
    bg = thermo.background_tables(par, n_grid=1024)
    ins = thermo.recomb_inputs(thermo.as_batch(par), bg)
    dlna = float(bg.lna[1] - bg.lna[0])
    _kernels.reset_launch_counts()
    got = thermo.recomb_scan(*ins, dlna)
    assert _kernels.LAUNCHES["recomb_scan"] == 1
    ref = thermo.recomb_scan_plain(*ins, dlna)
    for g, r in zip(got, ref):
        assert float(((g - r).abs() / r.abs()).max()) <= 1e-10
    x_h, _, _ = thermo.recomb_scan(ins[0].clone().requires_grad_(), *ins[1:], dlna)
    with pytest.raises(NotImplementedError, match="no reverse mode"):
        x_h.sum().backward()


def seeded_dual(par, rng):
    """``par`` (float64 (W,) fields) with a seeded tangent on each of the six
    table fields, inside the caller's ``forward_ad.dual_level()``."""
    from torch.autograd import forward_ad
    from eftpipe_tpu_torch.boltzmann import einstein_boltzmann as eb

    scale = dict(omega_b=1e-3, omega_cdm=1e-2, h=1e-2, m_ncdm=1e-2, n_ur=1e-2, yhe=1e-2)
    return par._replace(**{n: forward_ad.make_dual(
        getattr(par, n).contiguous(),
        scale[n] * torch.as_tensor(rng.standard_normal(par.h.shape[0]), dtype=torch.float64,
                                   device=par.h.device)) for n in eb.TABLE_FIELDS})


def rel_tangent_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.gpu
def test_recomb_scan_jvp_matches_plain_on_card(cuda):
    """``recomb_scan_jvp`` (the tangent kernel, through ``recomb_scan``
    under forward AD) against forward AD of the plain step loop, three
    cosmologies on a 512-point grid, a seeded tangent in the six table
    fields: tangents within 1e-9 of their largest |value|; one launch of
    the tangent kernel and none of the forward kernel (the tangent kernel
    gives the primal too)."""
    from torch.autograd import forward_ad
    from eftpipe_tpu_torch.boltzmann import _kernels, thermo
    from eftpipe_tpu_torch.boltzmann.dual import DenseTangents

    par = thermo.as_batch(thermo.CosmoParams(
        omega_b=torch.tensor([0.0224, 0.020, 0.027], dtype=torch.float64, device=cuda),
        omega_cdm=torch.tensor([0.12, 0.08, 0.25], dtype=torch.float64, device=cuda),
        h=torch.tensor([0.68, 0.6, 0.8], dtype=torch.float64, device=cuda),
        ln10As=3.044, ns=0.9649, m_ncdm=0.02, n_ur=0.00641, deg_ncdm=3.0))
    with forward_ad.dual_level(), DenseTangents():
        dpar = seeded_dual(par, np.random.default_rng(4))
        bg = thermo.background_tables(dpar, n_grid=512)
        ins = thermo.recomb_inputs(dpar, bg)
        dlna = float(forward_ad.unpack_dual(bg.lna).primal[1]
                     - forward_ad.unpack_dual(bg.lna).primal[0])
        _kernels.reset_launch_counts()
        got = [forward_ad.unpack_dual(o) for o in thermo.recomb_scan(*ins, dlna)]
        assert _kernels.LAUNCHES == dict(eb_solve=0, recomb_scan=0, eb_solve_jvp=0,
                                         recomb_scan_jvp=1, eb_solve_jvp2=0,
                                         recomb_scan_jvp2=0)
        ref = [forward_ad.unpack_dual(o) for o in thermo.recomb_scan_plain(*ins, dlna)]
    for g, r in zip(got, ref):
        assert torch.isfinite(r.tangent).all() and float(r.tangent.abs().max()) > 0
        assert rel_tangent_err(g.tangent, r.tangent) <= 1e-9
        assert float(((g.primal - r.primal).abs() / r.primal.abs()).max()) <= 1e-10


@pytest.mark.gpu
def test_recomb_scan_across_the_saha_boundary_on_card(cuda):
    """The recurrence's kernels on a batch whose rows leave the Saha block
    at different steps, so that the warp's threads part there (ω_b at the
    training box's two ends, a fiducial row beside them; on a 1024-point
    grid, where their blocks end at steps 662 and 661: at 512 points the
    box's ends leave it at the same step), and the first Peebles step (θ = 1)
    falls on a different step in each: ``recomb_scan`` against its plain
    loop (relative error ≤ 1e-10), ``recomb_scan_jvp`` against forward AD of
    the plain loop (a seeded tangent in the six table fields; ≤ 1e-9 of the
    largest tangent)."""
    from torch.autograd import forward_ad
    from eftpipe_tpu_torch.boltzmann import einstein_boltzmann as eb, thermo
    from eftpipe_tpu_torch.boltzmann.dual import DenseTangents

    lo, hi = eb.BOX_BOUNDS["omega_b"]
    f64 = dict(dtype=torch.float64, device=cuda)
    par = thermo.as_batch(thermo.CosmoParams(
        omega_b=torch.tensor([lo, hi, 0.0224], **f64), omega_cdm=torch.full((3,), 0.12, **f64),
        h=torch.full((3,), 0.68, **f64), ln10As=3.044, ns=0.9649, m_ncdm=0.02, n_ur=0.00641,
        deg_ncdm=3.0))
    bg = thermo.background_tables(par, n_grid=1024)
    ins = thermo.recomb_inputs(par, bg)
    dlna = thermo.scan_step(bg)
    ends = [int((~(ins[3][w] > 0.999)).nonzero()[0]) for w in range(3)]
    assert ends[0] != ends[1]
    got = thermo.recomb_scan(*ins, dlna)
    for g, r in zip(got, thermo.recomb_scan_plain(*ins, dlna)):
        assert float(((g - r).abs() / r.abs()).max()) <= 1e-10
    with forward_ad.dual_level(), DenseTangents():
        dpar = seeded_dual(par, np.random.default_rng(5))
        dins = thermo.recomb_inputs(dpar, thermo.background_tables(dpar, n_grid=1024))
        dgot = [forward_ad.unpack_dual(o) for o in thermo.recomb_scan(*dins, dlna)]
        ref = [forward_ad.unpack_dual(o) for o in thermo.recomb_scan_plain(*dins, dlna)]
    for g, r in zip(dgot, ref):
        assert torch.isfinite(r.tangent).all() and float(r.tangent.abs().max()) > 0
        assert rel_tangent_err(g.tangent, r.tangent) <= 1e-9


@pytest.mark.gpu
def test_eb_solve_matches_plain_on_card(cuda):
    """``eb_solve`` (one warp per (cosmology, mode), each mode's unpadded
    schedule) against the plain step loop on the padded buckets: two
    cosmologies, five modes on coarse schedules with TCA and post-TCA steps,
    δ_m, δ_cb and ζ_ini within 1e-9 of their largest |value|; one launch."""
    from eftpipe_tpu_torch.boltzmann import _kernels, einstein_boltzmann as eb, thermo

    par = eb.stack_params([thermo.CosmoParams(omega_b=0.0224, omega_cdm=0.12, h=0.68,
                                              ln10As=3.044, ns=0.9649, deg_ncdm=3.0),
                           thermo.CosmoParams(omega_b=0.023, omega_cdm=0.125, h=0.69,
                                              ln10As=3.0, ns=0.96, deg_ncdm=3.0)], cuda)
    bg = thermo.background_tables(par, n_grid=2048)
    th = thermo.thermo_tables(par, bg, n_fine=4096)
    tab = eb.make_tables(par, bg, th)
    hb, ht = eb.host_tables(bg, th)
    ks = np.array([1e-4, 2e-3, 0.01, 0.05, 0.2])
    lna_out = np.unique(np.log(1.0 / (1.0 + np.array([1.0, 0.5, 0.0]))))
    raw, rm = eb.build_schedule(ks, hb, ht, lna_out, pad=False, phase_acc=0.5, dlna_max=0.1)
    buckets = []
    for idx in eb.bucket_indices([g.size for g in raw]):
        grids = eb._pad_grids([raw[i] for i in idx])
        masks = eb._pad_masks([rm[i] for i in idx])
        buckets.append((idx, grids, masks, eb.out_indices(grids, lna_out)))
    assert any(m.any() for m in rm) and not all(m.all() for m in rm)
    _kernels.reset_launch_counts()
    with torch.no_grad():
        got = eb.eb_solve(tab, ks, buckets)
    assert _kernels.LAUNCHES["eb_solve"] == 1
    ref = [eb.eb_solve_plain(tab, ks[b[0]], b[1], b[2], b[3]) for b in buckets]
    sel = torch.as_tensor(np.concatenate([b[0] for b in buckets]), device=cuda)
    for name in ("delta_m", "delta_cb", "zeta_ini"):
        r = torch.cat([getattr(o, name) for o in ref], -1)
        g = getattr(got, name)[..., sel]
        assert float((g - r).abs().max() / r.abs().max()) <= 1e-9, name


# seven modes: an odd number of warps at odd W, no multiple of the warps a block
RAGGED_K = np.array([1e-4, 5e-4, 2e-3, 5e-3, 0.01, 0.03, 0.08])


def ragged_solve_inputs(cuda, nw):
    """``nw`` seeded cosmologies' tables on the card and coarse lockstep
    buckets of ``RAGGED_K`` (built on the envelope of their tables): seven
    modes, whose tight coupling ends at different steps."""
    from eftpipe_tpu_torch.boltzmann import einstein_boltzmann as eb, thermo

    rng = np.random.default_rng(nw)
    par = eb.stack_params([thermo.CosmoParams(
        omega_b=0.0224 * (1 + 0.05 * rng.standard_normal()),
        omega_cdm=0.12 * (1 + 0.1 * rng.standard_normal()), h=0.68 + 0.03 * rng.standard_normal(),
        ln10As=3.044, ns=0.9649, m_ncdm=0.02 * rng.random(), deg_ncdm=3.0)
        for _ in range(nw)], cuda)
    with torch.no_grad():
        tab, buckets, _ = cut_buckets(eb, thermo, par, RAGGED_K, phase_acc=0.5, dlna_max=0.1)
    return tab, buckets


@pytest.mark.gpu
@pytest.mark.parametrize("nw", [1, 3, 5])
def test_eb_solve_ragged_batches_match_plain_on_card(cuda, nw):
    """``eb_solve`` at ragged shapes: W = 1, 3, 5 cosmologies, seven modes
    (W·7 warps, no multiple of the two warps a block), the TCA switch at a
    different step in each schedule; δ_m, δ_cb and ζ_ini within 1e-9 of
    their largest |value| of the plain step loop; one launch."""
    from eftpipe_tpu_torch.boltzmann import _kernels, einstein_boltzmann as eb

    tab, buckets = ragged_solve_inputs(cuda, nw)
    switches = [int(np.argmin(m[j])) for _, _, m, _ in buckets for j in range(m.shape[0])]
    assert len(set(switches)) > 1 and min(switches) > 0
    _kernels.reset_launch_counts()
    with torch.no_grad():
        got = eb.eb_solve(tab, RAGGED_K, buckets)
    assert _kernels.LAUNCHES == dict(eb_solve=1, recomb_scan=0, eb_solve_jvp=0, recomb_scan_jvp=0,
                                     eb_solve_jvp2=0, recomb_scan_jvp2=0)
    ref = [eb.eb_solve_plain(tab, RAGGED_K[b[0]], b[1], b[2], b[3]) for b in buckets]
    sel = torch.as_tensor(np.concatenate([b[0] for b in buckets]), device=cuda)
    for name in ("delta_m", "delta_cb", "zeta_ini"):
        r = torch.cat([getattr(o, name) for o in ref], -1)
        g = getattr(got, name)[..., sel]
        assert torch.isfinite(g).all() and g.shape[0] == nw, name
        assert float((g - r).abs().max() / r.abs().max()) <= 1e-9, name


@pytest.mark.gpu
def test_eb_solve_is_repeatable_and_batch_invariant_on_card(cuda):
    """``eb_solve`` gives the same bits on a second call, and a cosmology
    gives the same bits alone (W=1) as in slot 2 of W=5 (its warps read only
    its own table; the metric's sums keep one order); so does the tangent
    kernel, value and tangent."""
    from eftpipe_tpu_torch.boltzmann import einstein_boltzmann as eb

    tab, buckets = ragged_solve_inputs(cuda, 5)
    dsched = eb.kernel_schedule(RAGGED_K, buckets).to(cuda)
    nk = RAGGED_K.size
    alone = eb.EBTables(tab.lna, tab.dlna, None, tab.stacked[2:3].contiguous())
    names = ("delta_m", "delta_cb", "zeta_ini")
    batch = eb.eb_solve_cuda(tab, dsched, nk)
    again = eb.eb_solve_cuda(tab, dsched, nk)
    one = eb.eb_solve_cuda(alone, dsched, nk)
    d_st = torch.as_tensor(np.random.default_rng(7).standard_normal(tuple(tab.stacked.shape)),
                           device=cuda) * tab.stacked
    jb = eb.eb_solve_jvp_cuda(tab, d_st, dsched, nk)
    j1 = eb.eb_solve_jvp_cuda(alone, d_st[2:3].contiguous(), dsched, nk)
    for name in names:
        assert torch.equal(getattr(batch, name), getattr(again, name)), name
        assert torch.equal(getattr(one, name)[0], getattr(batch, name)[2]), name
        for part in (0, 1):
            assert torch.equal(getattr(j1[part], name)[0], getattr(jb[part], name)[2]), name


def cut_buckets(eb, thermo, par, ks, n_grid=2048, n_fine=4096, phase_acc=0.9, dlna_max=0.2):
    """Tables of ``par`` and coarse lockstep buckets of the modes ``ks`` (TCA
    and post-TCA steps) built from them."""
    bg = thermo.background_tables(par, n_grid=n_grid)
    th = thermo.thermo_tables(par, bg, n_fine=n_fine)
    tab = eb.make_tables(par, bg, th)
    hb, ht = eb.host_tables(bg, th)
    lna_out = np.unique(np.log(1.0 / (1.0 + np.array([1.0, 0.5, 0.0]))))
    raw, rm = eb.build_schedule(ks, hb, ht, lna_out, pad=False, phase_acc=phase_acc,
                                dlna_max=dlna_max)
    buckets = []
    for idx in eb.bucket_indices([g.size for g in raw]):
        grids = eb._pad_grids([raw[i] for i in idx])
        masks = eb._pad_masks([rm[i] for i in idx])
        buckets.append((idx, grids, masks, eb.out_indices(grids, lna_out)))
    assert any(m.any() for m in rm) and not all(m.all() for m in rm)
    return tab, buckets, lna_out


@pytest.mark.gpu
def test_eb_solve_jvp_matches_plain_on_card(cuda):
    """``eb_solve_jvp`` (through ``eb_solve`` under forward AD) against
    forward AD of the plain step loop on the padded buckets: two
    cosmologies, three modes on coarse schedules with TCA and post-TCA steps,
    a seeded tangent in the six table fields; the tangents of δ_m, δ_cb and
    ζ_ini within 1e-9 of their largest |value|; one launch of the tangent
    kernel and none of the forward kernel (the tangent kernel gives the
    primal too)."""
    from torch.autograd import forward_ad
    from eftpipe_tpu_torch.boltzmann import _kernels, einstein_boltzmann as eb, thermo
    from eftpipe_tpu_torch.boltzmann.dual import DenseTangents

    par = eb.stack_params([thermo.CosmoParams(omega_b=0.0224, omega_cdm=0.12, h=0.68,
                                              ln10As=3.044, ns=0.9649, deg_ncdm=3.0),
                           thermo.CosmoParams(omega_b=0.023, omega_cdm=0.125, h=0.69,
                                              ln10As=3.0, ns=0.96, deg_ncdm=3.0)], cuda)
    ks = np.array([1e-4, 2e-3, 0.02])
    with torch.no_grad():
        _, buckets, _ = cut_buckets(eb, thermo, par, ks)
    with forward_ad.dual_level(), DenseTangents():
        dpar = seeded_dual(par, np.random.default_rng(5))
        bg = thermo.background_tables(dpar, n_grid=2048)
        tab = eb.make_tables(dpar, bg, thermo.thermo_tables(dpar, bg, n_fine=4096))
        _kernels.reset_launch_counts()
        got = eb.eb_solve(tab, ks, buckets)
        assert _kernels.LAUNCHES["eb_solve"] == 0 and _kernels.LAUNCHES["eb_solve_jvp"] == 1
        ref = [eb.eb_solve_plain(tab, ks[b[0]], b[1], b[2], b[3]) for b in buckets]
        sel = torch.as_tensor(np.concatenate([b[0] for b in buckets]), device=cuda)
        for name in ("delta_m", "delta_cb", "zeta_ini"):
            r = forward_ad.unpack_dual(torch.cat([getattr(o, name) for o in ref], -1)).tangent
            g = forward_ad.unpack_dual(getattr(got, name)).tangent[..., sel]
            assert torch.isfinite(r).all() and float(r.abs().max()) > 0, name
            assert rel_tangent_err(g, r) <= 1e-9, name


@pytest.mark.gpu
def test_solver_gradient_on_card_matches_plain_autograd(cuda):
    """The solver's gradient on the card (the route of forward-mode tangent
    kernels, ``_SolverTables``) against reverse autograd of the plain
    versions on the CPU, on a cut solver (three modes, coarse schedules,
    the tables on a 512-point grid with the recombination on it): a seeded
    loss of every output of ``EBSolver`` in the six table fields, ln10As and
    n_s at W=2, rtol 1e-8; the card's outputs with the gradient equal those
    without it bit for bit; the value and gradient launches each of the four
    kernels once (the primal pass the forward kernels, the tangent pass only
    the tangent kernels)."""
    import functools

    from eftpipe_tpu_torch.boltzmann import _kernels, einstein_boltzmann as eb, thermo
    from eftpipe_tpu_torch.convert import eb_solver_from_numpy

    fields = eb.TABLE_FIELDS + ("ln10As", "ns")
    rows = dict(omega_b=[0.0224, 0.023], omega_cdm=[0.12, 0.125], h=[0.68, 0.69],
                ln10As=[3.044, 3.0], ns=[0.9649, 0.96], m_ncdm=[0.02, 0.03],
                n_ur=[0.00641, 0.00641], yhe=[0.2454, 0.25])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(eb, "background_tables", functools.partial(thermo.background_tables,
                                                              n_grid=512))
        mp.setattr(eb, "thermo_tables", functools.partial(thermo.thermo_tables, n_fine=0))
        ks = np.array([1e-4, 1e-3, 0.01])
        with torch.no_grad():
            par0 = eb.stack_params([thermo.CosmoParams(**{k: v[0] for k, v in rows.items()},
                                                       deg_ncdm=3.0)], "cpu")
            bg = eb.background_tables(par0)
            hb, ht = eb.host_tables(bg, eb.thermo_tables(par0, bg))
        raw, rm = eb.build_schedule(ks, hb[0], ht[0], np.log([1 / 1.5]), pad=False,
                                    phase_acc=0.9, dlna_max=0.2)
        grids, masks = eb._pad_grids(raw), eb._pad_masks(rm)
        sched = dict(k_mpc=ks, z_out=[0.5], lna_out=np.log([1 / 1.5]), dlna_f=0.02,
                     growth_stencil=False,
                     buckets=[(np.arange(ks.size), grids, masks,
                               eb.out_indices(grids, np.log([1 / 1.5])))])
        rng = np.random.default_rng(6)
        weights = None

        def value_and_grad(device):
            nonlocal weights
            solver = eb_solver_from_numpy(sched, device=device)
            leaves = {k: torch.tensor(v, dtype=torch.float64, device=device,
                                      requires_grad=k in fields) for k, v in rows.items()}
            lp = solver(thermo.CosmoParams(**leaves, deg_ncdm=3.0))
            outs = [lp.pk, lp.pk_cb, lp.sigma8, lp.h_of_z, lp.da_of_z, lp.rs_drag]
            if weights is None:
                weights = [rng.standard_normal(o.shape) / float(o.detach().abs().mean())
                           for o in outs]
            loss = sum((torch.as_tensor(w, device=device) * o).sum()
                       for w, o in zip(weights, outs))
            grads = torch.autograd.grad(loss, [leaves[k] for k in fields])
            launches = dict(_kernels.LAUNCHES)
            with torch.no_grad():
                ref = solver(thermo.CosmoParams(**leaves, deg_ncdm=3.0))
            return outs, ref, [g.cpu() for g in grads], launches

        _, _, want, _ = value_and_grad("cpu")
        _kernels.reset_launch_counts()
        outs, ref, got, launches = value_and_grad(cuda)
    assert launches == dict(eb_solve=1, recomb_scan=1, eb_solve_jvp=1, recomb_scan_jvp=1,
                            eb_solve_jvp2=0, recomb_scan_jvp2=0)
    for o, r in zip(outs, [ref.pk, ref.pk_cb, ref.sigma8, ref.h_of_z, ref.da_of_z,
                           ref.rs_drag]):
        assert torch.equal(o.detach(), r)
    for name, g, w in zip(fields, got, want):
        assert torch.isfinite(w).all() and float(w.abs().max()) > 0, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-8,
                                   atol=1e-8 * float(w.abs().max()), err_msg=name)


def pair_jet(par, names=("omega_cdm", "h")):
    """The pair rows of ``par`` in ``names`` (``jet.pair_rows``), as the
    solver's second-order pass seeds them: (every field's rows, the jet of
    the ``names`` fields)."""
    from eftpipe_tpu_torch.boltzmann import jet, thermo

    values = {n: getattr(par, n) for n in thermo.CosmoParams._fields[:-1]}
    return jet.pair_rows(values, names, par.h)


def rel_part_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.gpu
def test_recomb_scan_jvp2_matches_plain_on_card(cuda):
    """``recomb_scan_jvp2`` (the hyper-dual kernel) against the plain step
    loop on hyper-dual operands on the host: three cosmologies on a
    512-point grid, their pair rows in (ω_cdm, h), the inputs' jets those of
    the stage before the recurrence (``jet.jet_call``); every part within
    1e-9 of its largest |value|; the value and the first-order parts within
    1e-12 of the forward and the tangent kernels' on the same rows; one
    launch."""
    from eftpipe_tpu_torch.boltzmann import _kernels, jet, thermo

    par = thermo.as_batch(thermo.CosmoParams(
        omega_b=torch.tensor([0.0224, 0.020, 0.027], dtype=torch.float64, device=cuda),
        omega_cdm=torch.tensor([0.12, 0.08, 0.25], dtype=torch.float64, device=cuda),
        h=torch.tensor([0.68, 0.6, 0.8], dtype=torch.float64, device=cuda),
        ln10As=3.044, ns=0.9649, m_ncdm=0.02, n_ur=0.00641, deg_ncdm=3.0))
    rows, pj = pair_jet(par)
    base = thermo.CosmoParams(**rows, deg_ncdm=3.0)

    def stage(ocdm, h):
        p = base._replace(omega_cdm=ocdm, h=h)
        return thermo.recomb_inputs(p, thermo.background_tables(p, n_grid=512))

    ins = jet.jet_call(stage, pj)
    dlna = thermo.scan_step(thermo.background_tables(base, n_grid=512))
    _kernels.reset_launch_counts()
    got = thermo.recomb_scan_jvp2(ins, dlna)
    assert _kernels.LAUNCHES["recomb_scan_jvp2"] == 1 and sum(_kernels.LAUNCHES.values()) == 1
    want = thermo.recomb_scan_jvp2_plain(jet.Jet(*(tuple(t.cpu() for t in p) for p in ins)), dlna)
    for part in range(4):
        for g, w in zip(got[part], want[part]):
            assert torch.isfinite(w).all() and float(w.abs().max()) > 0, part
            assert rel_part_err(g.cpu(), w) <= 1e-9, part
    fwd = thermo.recomb_scan_cuda(*(t.contiguous() for t in ins.v), dlna)
    _, dual = thermo.recomb_scan_jvp_cuda([t.contiguous() for t in ins.v],
                                          [t.contiguous() for t in ins.a], dlna)
    for g, f in zip(got.v, fwd):
        assert float(((g - f).abs() / f.abs()).max()) <= 1e-12
    for g, d in zip(got.a, dual):
        assert rel_part_err(g, d) <= 1e-12


@pytest.mark.gpu
def test_eb_solve_jvp2_matches_plain_on_card(cuda):
    """``eb_solve_jvp2`` (the hyper-dual kernel, one warp a row and mode)
    against ``eb_solve_plain`` on hyper-dual tables on the host: the two
    cosmologies of the tangent kernel's test, three modes on coarse
    schedules with TCA and post-TCA steps, seeded parts of the tables;
    every part of δ_m, δ_cb and ζ_ini within 1e-9 of its largest |value|;
    the value and the first-order part within 1e-12 of the forward and the
    tangent kernels'; one launch."""
    from eftpipe_tpu_torch.boltzmann import _kernels, einstein_boltzmann as eb, thermo

    par = eb.stack_params([thermo.CosmoParams(omega_b=0.0224, omega_cdm=0.12, h=0.68,
                                              ln10As=3.044, ns=0.9649, deg_ncdm=3.0),
                           thermo.CosmoParams(omega_b=0.023, omega_cdm=0.125, h=0.69,
                                              ln10As=3.0, ns=0.96, deg_ncdm=3.0)], cuda)
    ks = np.array([1e-4, 2e-3, 0.02])
    with torch.no_grad():
        tab, buckets, _ = cut_buckets(eb, thermo, par, ks)
    rng = np.random.default_rng(11)
    st = tab.stacked
    parts = tuple(s * st * torch.as_tensor(rng.standard_normal(tuple(st.shape)), device=cuda)
                  for s in (1e-2, 2e-2, 1e-3))
    dsched = eb.kernel_schedule(ks, buckets).to(cuda)
    _kernels.reset_launch_counts()
    got = eb.eb_solve_jvp2(tab, parts, ks, buckets, dsched)
    assert _kernels.LAUNCHES["eb_solve_jvp2"] == 1 and sum(_kernels.LAUNCHES.values()) == 1
    host = eb.EBTables(tab.lna.cpu(), tab.dlna.cpu(), None, st.cpu())
    want = eb.eb_solve_jvp2(host, tuple(p.cpu() for p in parts), ks, buckets)
    for part in range(4):
        for g, w in zip(got[part], want[part]):
            assert torch.isfinite(w).all() and float(w.abs().max()) > 0, part
            assert rel_part_err(g.cpu(), w) <= 1e-9, part
    fwd = eb.eb_solve_cuda(tab, dsched, ks.size)
    _, dual = eb.eb_solve_jvp_cuda(tab, parts[0].contiguous(), dsched, ks.size)
    for g, f, d, a in zip(got.v, fwd, dual, got.a):
        assert rel_part_err(g, f) <= 1e-12 and rel_part_err(a, d) <= 1e-12


@pytest.mark.gpu
def test_solver_hessian_on_card_matches_plain_autograd(cuda):
    """The solver's second derivative on the card (the double backward of
    ``_SolverTables``: the jet pass with the hyper-dual kernels) against
    reverse-over-reverse autograd of the plain versions on the CPU, on the
    cut solver of the gradient's test: a seeded loss of every output of
    ``EBSolver``, nonlinear in them, in ω_cdm, h, ln10As and n_s at W=2
    (a seeded combination of the gradient's components differentiated
    once more), rtol 1e-8; the gradient with its graph equals the one
    without it bit for bit; one Hessian launches each of the six kernels
    once."""
    import functools

    from eftpipe_tpu_torch.boltzmann import _kernels, einstein_boltzmann as eb, thermo
    from eftpipe_tpu_torch.convert import eb_solver_from_numpy

    fields = ("omega_cdm", "h", "ln10As", "ns")
    rows = dict(omega_b=[0.0224, 0.023], omega_cdm=[0.12, 0.125], h=[0.68, 0.69],
                ln10As=[3.044, 3.0], ns=[0.9649, 0.96], m_ncdm=[0.02, 0.03],
                n_ur=[0.00641, 0.00641], yhe=[0.2454, 0.25])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(eb, "background_tables", functools.partial(thermo.background_tables,
                                                              n_grid=512))
        mp.setattr(eb, "thermo_tables", functools.partial(thermo.thermo_tables, n_fine=0))
        ks = np.array([1e-4, 1e-3, 0.01])
        with torch.no_grad():
            par0 = eb.stack_params([thermo.CosmoParams(**{k: v[0] for k, v in rows.items()},
                                                       deg_ncdm=3.0)], "cpu")
            bg = eb.background_tables(par0)
            hb, ht = eb.host_tables(bg, eb.thermo_tables(par0, bg))
        raw, rm = eb.build_schedule(ks, hb[0], ht[0], np.log([1 / 1.5]), pad=False,
                                    phase_acc=0.9, dlna_max=0.2)
        grids, masks = eb._pad_grids(raw), eb._pad_masks(rm)
        sched = dict(k_mpc=ks, z_out=[0.5], lna_out=np.log([1 / 1.5]), dlna_f=0.02,
                     growth_stencil=False,
                     buckets=[(np.arange(ks.size), grids, masks,
                               eb.out_indices(grids, np.log([1 / 1.5])))])
        rng = np.random.default_rng(16)
        u = rng.standard_normal(len(fields))
        weights = None

        def hessian(device):
            nonlocal weights
            solver = eb_solver_from_numpy(sched, device=device)
            leaves = {k: torch.tensor(v, dtype=torch.float64, device=device,
                                      requires_grad=k in fields) for k, v in rows.items()}
            lp = solver(thermo.CosmoParams(**leaves, deg_ncdm=3.0))
            outs = [lp.pk, lp.pk_cb, lp.sigma8, lp.h_of_z, lp.da_of_z, lp.rs_drag]
            if weights is None:
                weights = [rng.standard_normal(o.shape) / float(o.detach().abs().mean())
                           for o in outs]
            lin = sum((torch.as_tensor(w, device=device) * o).sum()
                      for w, o in zip(weights, outs))
            loss = lin + 0.5 * lin ** 2
            xs = [leaves[k] for k in fields]
            g0 = torch.autograd.grad(loss, xs, retain_graph=True)
            g = torch.autograd.grad(loss, xs, create_graph=True)
            assert all(torch.equal(a, b.detach()) for a, b in zip(g0, g))
            h = torch.autograd.grad(sum(c * gi.sum() for c, gi in zip(u, g)), xs)
            return [t.cpu() for t in h], dict(_kernels.LAUNCHES)

        want, _ = hessian("cpu")
        _kernels.reset_launch_counts()
        got, launches = hessian(cuda)
    assert launches == dict(eb_solve=1, recomb_scan=1, eb_solve_jvp=1, recomb_scan_jvp=1,
                            eb_solve_jvp2=1, recomb_scan_jvp2=1)
    for name, g, w in zip(fields, got, want):
        assert torch.isfinite(w).all() and float(w.abs().max()) > 0, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-8,
                                   atol=1e-8 * float(w.abs().max()), err_msg=name)


@pytest.mark.gpu
def test_batched_recipe_solve_equals_single_solves(cuda):
    """The training recipe's solver (the 8-corner envelope of the 3-D box,
    288 k × 13 z): a W=4 batch gives each cosmology the stored samples
    (log T_m, log T_cb, log r_drag) of its own W=1 solve, bit for bit."""
    from eftpipe_tpu_torch.boltzmann import einstein_boltzmann as eb
    from eftpipe_tpu_torch.tools import train_solver_emulator as tool

    design = tool.sample_design(8, 0.4)
    with torch.no_grad():
        solver = tool.design_solver(design, device=cuda)
        assert solver.device.type == "cuda"

        def samples(rows):
            x = torch.as_tensor(design["x"][rows], dtype=torch.float64, device=cuda)
            lp = solver(eb.box_params(x[:, 0], x[:, 1], x[:, 2], tool.NEUTRINO["m_ncdm"],
                                      device=cuda))
            assert lp.pk.is_cuda
            return (*eb.log_transfers(lp), torch.log(lp.rs_drag))

        batched = samples([0, 1, 2, 3])
        for i in range(4):
            for b, s in zip(batched, samples([i])):
                assert torch.isfinite(b[i]).all()
                assert torch.equal(b[i], s[0])


@pytest.mark.gpu
def test_one_rank_nccl_mesh_equals_no_mesh(cuda):
    """A one-rank NCCL group on the card: the stretch sampler under
    ``walker_mesh()`` takes the steps of the sampler without it, bit for
    bit."""
    import socket

    import torch.distributed as dist
    from eftpipe_tpu_torch.parallel.mesh import walker_mesh
    from eftpipe_tpu_torch.parallel.sampler import EnsembleSampler

    mean = torch.as_tensor(MEAN, device=cuda)
    sigma = torch.as_tensor(SIGMA_DRIVER, device=cuda)

    def lp(x):
        return -0.5 * (((x - mean) / sigma) ** 2).sum(-1)

    x0 = mean + 0.1 * torch.randn((16, 3), generator=torch.Generator().manual_seed(0),
                                  dtype=torch.float64).to(cuda)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        mesh = walker_mesh()
        got = EnsembleSampler(logp=lp, nwalkers=16, ndim=3, mesh=mesh).run(
            torch.Generator(device=cuda).manual_seed(1), x0, nsteps=5)
    finally:
        dist.destroy_process_group()
    want = EnsembleSampler(logp=lp, nwalkers=16, ndim=3).run(
        torch.Generator(device=cuda).manual_seed(1), x0, nsteps=5)
    assert mesh.collectives == 1 + 2 * 5
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)


@pytest.mark.gpu
def test_transfer_training_keeps_its_parameters_on_the_card(cuda):
    from eftpipe_tpu_torch.boltzmann.emulator import train_transfer_emulator

    k = np.logspace(-4, 0.3, 50)
    emu = train_transfer_emulator(k, n_samples=64, width=16, depth=2, steps=5,
                                  dtype=torch.float32, device=cuda)
    assert all(t.is_cuda and t.dtype == torch.float32 for layer in emu.params
               for t in layer.values())
    t = emu(torch.tensor([[0.0223, 0.118, 0.69, 0.965]], dtype=torch.float32, device=cuda))
    assert t.is_cuda and t.shape == (1, k.size) and bool(torch.isfinite(t).all())
