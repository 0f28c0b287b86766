"""The port's Einstein-Boltzmann solver (``boltzmann/thermo.py``,
``boltzmann/einstein_boltzmann.py``) against the JAX package's, float64, on
identical NumPy inputs: the background and thermodynamic tables, the step
schedule (bit for bit), the right-hand side, one RK4 step, short solves of
low-k modes on schedules coarsened through the JAX ``build_schedule``'s own
options, the ``solver`` provider on a solver cut to a handful of modes the
same way in both packages, the derivative of δ_m in ω_cdm (autograd against
JAX's), and an analysis on the ``solver`` provider.  Then the gradient's
forward-mode route, the card's (``einstein_boltzmann._SolverTables``), run
here over the plain versions under forward AD: its tangent against JAX's,
its gradient against reverse autograd of the plain path, an analysis'
∇logp through it.  Then its second derivative (ROADMAP A8.2): the jet pass
(``EBSolver.table_hessians``, the recurrences on ``jet.HyperDual`` operands)
against JAX's forward-over-forward derivative, the Function's double
backward against reverse-over-reverse autograd of the plain path, an
analysis' Hessian through it, the jet helpers and the refusal of a third
derivative.

On the CPU the kernels' plain versions run (``recomb_scan_plain``,
``eb_solve_plain``).  The recombination recurrence is a Python step loop
there (~1 ms a step), so the solves use ``n_fine=0`` (the recurrence on the
background grid) in both packages: each solver module's ``thermo_tables``
is given ``n_fine=0``, and its ``background_tables`` a ``CUT_GRID``-point
grid, for the tests that build solvers.  The JAX references are jitted
(eager, each call dispatches and compiles its operations one by one)."""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from eftpipe_tpu.boltzmann import thermo as jt, einstein_boltzmann as je
from eftpipe_tpu.models.config import EFTConfig as JConfig
from eftpipe_tpu_torch.boltzmann import thermo as tt, einstein_boltzmann as te
from eftpipe_tpu_torch.boltzmann import jet as tj
from eftpipe_tpu_torch.boltzmann.dual import DenseTangents
from eftpipe_tpu_torch.convert import eb_solver_from_numpy
from eftpipe_tpu_torch.models.config import EFTConfig as TConfig

COSMOS = [
    dict(omega_b=0.02237, omega_cdm=0.12, h=0.6736, ln10As=3.044, ns=0.9649, m_ncdm=0.02,
         n_ur=0.00641, yhe=0.2454),
    dict(omega_b=0.025, omega_cdm=0.16, h=0.70, ln10As=3.0, ns=0.96, m_ncdm=0.0,
         n_ur=0.00641, yhe=0.2454),
]
DEG = 3.0
# the cut solver: a few low-k modes on a coarse schedule (phase steps ×4,
# ln-a steps ≤ 0.2), identical in both packages
CUT_K = np.array([1e-4, 1e-3, 2e-3, 3e-3])
CUT_OPTS = dict(phase_acc=0.9, dlna_max=0.2)
CUT_GRID = 512  # the background grid of the cut solves, the recombination on it
COARSE_GRID = 128  # the same for the analysis through the gradient's route
# the JAX tables, jitted: compiled once per grid (eager, each call dispatches
# and compiles its ops one by one)
JBG = jax.jit(jt.background_tables, static_argnames=("lna_min", "n_grid"))
JTH = jax.jit(jt.thermo_tables, static_argnames=("n_fine",))
PARAMS = [dict(omega_b=0.0224, omega_cdm=0.12, h=0.68, ln10As=3.05, ns=0.965),
          dict(omega_b=0.022, omega_cdm=0.14, h=0.70, ln10As=3.0, ns=0.97)]


def jpar(c):
    return jt.CosmoParams(**{k: jnp.asarray(v) for k, v in c.items()}, deg_ncdm=DEG)


def tpar(cs):
    return tt.CosmoParams(**{k: torch.tensor([c[k] for c in cs], dtype=torch.float64)
                             for k in cs[0]}, deg_ncdm=DEG)


def t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def close(got, want, rtol, name=""):
    """|got − want| ≤ rtol (|want| + max|want|): relative, with the table's
    scale as the floor where a table crosses zero."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max(),
                               err_msg=name)


def port_tables(tab):
    """The JAX ``EBTables`` as the port's, one cosmology."""
    return te.EBTables(lna=t(tab.lna), dlna=t(tab.dlna), tau=t(tab.tau)[None],
                       stacked=t(tab.stacked)[None])


@pytest.fixture(scope="module")
def jax_tables():
    """The JAX tables of the first cosmology on the 4096-point grid, the
    recombination on it (n_fine=0)."""
    p = jpar(COSMOS[0])
    bg = JBG(p)
    th = JTH(p, bg, n_fine=0)
    return p, bg, th, je.make_tables(p, bg, th)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------
def test_background_tables_match_jax():
    got = tt.background_tables(tpar(COSMOS), n_grid=4096)
    for i, c in enumerate(COSMOS):
        want = JBG(jpar(c), n_grid=4096)
        for f in want._fields:
            g = getattr(got, f).numpy()
            close(g if f == "lna" else g[i], getattr(want, f), 1e-12, f)


def test_thermo_tables_match_jax():
    par = tpar(COSMOS)
    got = tt.thermo_tables(par, tt.background_tables(par, n_grid=2048), n_fine=0)
    for i, c in enumerate(COSMOS):
        p = jpar(c)
        want = JTH(p, JBG(p, n_grid=2048), n_fine=0)
        for f in want._fields:
            g = getattr(got, f).numpy()
            close(g if f == "lna" else g[i], getattr(want, f), 1e-10, f)


def test_recomb_fine_grid_interpolation():
    """``thermo_tables`` with a fine grid: the recurrence there, the tables
    interpolated back (a small fine grid keeps the plain loop short)."""
    par = tpar(COSMOS[:1])
    bg = tt.background_tables(par, n_grid=CUT_GRID)
    got = tt.thermo_tables(par, bg, n_fine=2 * CUT_GRID)
    p = jpar(COSMOS[0])
    want = JTH(p, JBG(p, n_grid=CUT_GRID), n_fine=2 * CUT_GRID)
    for f in ("xe", "tm", "dkappa", "cs2", "rs", "rs_drag", "z_drag", "tau_rec"):
        close(getattr(got, f).numpy()[0], getattr(want, f), 1e-10, f)


# ---------------------------------------------------------------------------
# the schedule: host NumPy, bit for bit from the same tables
# ---------------------------------------------------------------------------
def test_build_schedule_bitwise(jax_tables):
    _, bg, th, _ = jax_tables
    k = te.solver_k_grid(1.6)
    assert np.array_equal(k, je.solver_k_grid(1.6))
    lna_out = np.unique(np.log(1.0 / (1.0 + np.array([1.0, 0.7, 0.3]))))
    # one cosmology, and the envelope form (a list of tables)
    for b, h in ((bg, th), ([bg, bg], [th, th])):
        gj, mj = je.build_schedule(k, b, h, lna_out, pad=False)
        gt, mt = te.build_schedule(k, b, h, lna_out, pad=False)
        assert len(gj) == len(gt)
        for a, c in zip(gj, gt):
            np.testing.assert_array_equal(a, c)
        for a, c in zip(mj, mt):
            np.testing.assert_array_equal(a, c)
    lengths = [g.size for g in gj]
    bj, bt = je.bucket_indices(lengths), te.bucket_indices(lengths)
    assert len(bj) == len(bt)
    for a, c in zip(bj, bt):
        np.testing.assert_array_equal(a, c)
        grids = je._pad_grids([gj[i] for i in a])
        np.testing.assert_array_equal(grids, te._pad_grids([gt[i] for i in c]))
        np.testing.assert_array_equal(je._pad_masks([mj[i] for i in a]),
                                      te._pad_masks([mt[i] for i in c]))
        np.testing.assert_array_equal(je.out_indices(grids, lna_out),
                                      te.out_indices(grids, lna_out))
    # the port's own host copy of its tables gives the same grids
    par = tpar(COSMOS[:1])
    tbg = tt.background_tables(par, n_grid=CUT_GRID)
    hb, ht = te.host_tables(tbg, tt.thermo_tables(par, tbg, n_fine=0))
    p = jpar(COSMOS[0])
    jbg = JBG(p, n_grid=CUT_GRID)
    g1, _ = je.build_schedule(k[:8], jbg, JTH(p, jbg, n_fine=0), lna_out, pad=False)
    g2, _ = te.build_schedule(k[:8], hb[0], ht[0], lna_out, pad=False)
    assert [a.size for a in g1] == [a.size for a in g2]


def test_kernel_schedule_reproduces_the_buckets(jax_tables):
    """The kernel's flattened schedule (each mode unpadded, longest first,
    outputs clamped to the mode's end) integrates exactly what the padded
    buckets do: the padding is no-op steps."""
    _, bg, th, tab = jax_tables
    lna_out = np.unique(np.log(1.0 / (1.0 + np.array([0.5, 0.0]))))
    raw, rm = je.build_schedule(CUT_K, bg, th, lna_out, pad=False, **CUT_OPTS)
    grids, masks = je._pad_grids(raw), je._pad_masks(rm)
    oidx = je.out_indices(grids, lna_out)
    sched = te.kernel_schedule(CUT_K, [(np.arange(CUT_K.size), grids, masks, oidx)])
    assert list(sched.steps) == sorted((g.size - 1 for g in raw), reverse=True)
    assert np.array_equal(np.sort(sched.order), np.arange(CUT_K.size))
    ttab = port_tables(tab)
    padded = te.eb_solve_plain(ttab, CUT_K, grids, masks, oidx)
    for j, kid in enumerate(sched.order):
        lo, hi = sched.offsets[j], sched.offsets[j + 1]
        one = te.eb_solve_plain(ttab, CUT_K[kid:kid + 1], sched.lna[None, lo:hi],
                                sched.tca[None, lo:hi].astype(bool),
                                sched.out_idx[j][:, None])
        assert torch.equal(one.delta_m[..., 0], padded.delta_m[..., kid])
        assert torch.equal(one.zeta_ini[..., 0], padded.zeta_ini[..., kid])


def test_interp_loglog_matches_jax():
    k = np.geomspace(1e-4, 1.0, 40)
    pk = 2e4 * k / (1 + (k / 0.02) ** 2.5)
    k_new = np.geomspace(2e-4, 0.9, 17)
    np.testing.assert_array_equal(te.interp_loglog(k_new, k, pk), je.interp_loglog(k_new, k, pk))


# ---------------------------------------------------------------------------
# the right-hand side and one step
# ---------------------------------------------------------------------------
@jax.jit
def jax_pointwise(tab, y, k, lna, tca):
    """The JAX right-hand side at one state, with the TCA projection, δ_m and
    ζ there (``tca`` enters through ``jnp.where``: one compile for both)."""
    bgv = je._bgv_at(tab, lna)
    return (je._rhs(y, k, je._tau_at(tab, lna), bgv, tca), je._tca_project(y, k, bgv),
            je._delta_m(y, k, bgv), je._zeta(y, k, bgv))


@pytest.mark.parametrize("k", [1e-3, 0.05, 0.8])
def test_rhs_matches_jax(jax_tables, k):
    _, _, _, tab = jax_tables
    ttab = port_tables(tab)
    rng = np.random.default_rng(int(k * 1e4))
    for lna in (-12.0, -7.0, -2.0):
        y = rng.standard_normal(te.NSTATE)
        bgv, tau = te._bgv_tau(ttab, t([lna]))
        for tca in (True, False):
            want, proj, dm, zeta = jax_pointwise(tab, jnp.asarray(y), k, lna, tca)
            got = te._rhs(t(y)[None, None], t([k]), tau, bgv, torch.tensor([tca]))[0, 0]
            close(got.numpy(), want, 1e-12, f"rhs lna={lna} tca={tca}")
        close(te._tca_project(t(y)[None, None], t([k]), bgv)[0, 0].numpy(), proj, 1e-12,
              "tca_project")
        for a, b in zip(te._delta_m(t(y)[None, None], t([k]), bgv), dm):
            close(a.numpy()[0, 0], b, 1e-12, "delta_m")
        close(te._zeta(t(y)[None, None], t([k]), bgv).numpy()[0, 0], zeta, 1e-12, "zeta")
    yj, zj = jax.jit(je._ic_and_zeta)(tab, k, -14.0)
    yt, zt = te._ic_and_zeta(ttab, t([k]), t([-14.0]))
    close(yt[0, 0].numpy(), yj, 1e-12, "ic")
    close(zt[0, 0].numpy(), zj, 1e-12, "zeta_ini")


def test_rk4_advance_matches_jax(jax_tables):
    _, _, _, tab = jax_tables
    ttab = port_tables(tab)
    rng = np.random.default_rng(5)
    ks = np.array([1e-3, 0.05, 0.8])
    y = rng.standard_normal((ks.size, te.NSTATE))
    la, lb = -9.0, -8.98
    step = jax.jit(je._rk4_advance)
    for tca in (True, False):
        got, _ = te._rk4_advance(t(y)[None], t(ks), ttab, t([la] * 3), t([lb] * 3),
                                 torch.tensor([tca] * 3), torch.tensor([tca] * 3))
        for i, k in enumerate(ks):
            want, _ = step(jnp.asarray(y[i]), k, tab, la, lb, tca, tca)
            close(got[0, i].numpy(), want, 1e-12, f"rk4 k={k} tca={tca}")


# ---------------------------------------------------------------------------
# short solves
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cut_solvers():
    """A JAX ``EBSolver`` (one output z) cut to ``CUT_K`` on the coarse
    schedule, and the port's solver carried across from it by
    ``eb_solver_from_numpy``; both solver modules' tables on the
    ``CUT_GRID``-point grid, the recombination on it, for the module's
    remaining tests."""
    with pytest.MonkeyPatch.context() as mp:
        for mod, tmod in ((je, jt), (te, tt)):
            bg_fn = functools.partial(tmod.background_tables, n_grid=CUT_GRID)
            th_fn = functools.partial(tmod.thermo_tables, n_fine=0)
            if mod is je:  # compiled once for every cosmology (eager, each call recompiles)
                bg_fn, th_fn = jax.jit(bg_fn), jax.jit(th_fn)
            mp.setattr(mod, "background_tables", bg_fn)
            mp.setattr(mod, "thermo_tables", th_fn)
        js = je.EBSolver(z_out=[0.5], kmax=0.05)
        # the JAX solver's fiducial cosmology: its schedule's tables
        fid = jt.CosmoParams(**{k: jnp.asarray(v) for k, v in te.FIDUCIAL.items()})
        bg = je.background_tables(fid)
        th = je.thermo_tables(fid, bg)
        raw, rm = je.build_schedule(CUT_K, bg, th, js.lna_out, pad=False, **CUT_OPTS)
        js.k_mpc = CUT_K
        js.buckets = []
        for idx in je.bucket_indices([g.size for g in raw]):
            grids = je._pad_grids([raw[i] for i in idx])
            masks = je._pad_masks([rm[i] for i in idx])
            js.buckets.append((idx, grids, masks, je.out_indices(grids, js.lna_out)))
        ts = eb_solver_from_numpy(dict(
            k_mpc=js.k_mpc, z_out=js.z_out, lna_out=js.lna_out, dlna_f=js.dlna_f,
            growth_stencil=js.growth_stencil, buckets=js.buckets), device="cpu")
        yield js, ts


@pytest.fixture(scope="module")
def jax_cut_jets(cut_solvers):
    """The JAX solve of the cut solver's bucket at the first cosmology, from
    its ω_cdm and h through the background, the recombination recurrence
    and the tables, with its derivative in ω_cdm and the mixed second
    derivative in ω_cdm and h: one jitted ``jax.jvp`` (in h) of a
    ``jax.jvp`` (in ω_cdm).  For one input, forward mode gives the number
    ``jax.grad`` does; its trace and compile take half as long as the
    reverse-mode scan's.  Returns the tables, the solve, the solve's tangent
    in ω_cdm and its mixed part."""
    js, _ = cut_solvers
    ((_, grids, masks, oi),) = js.buckets
    p0 = jpar(COSMOS[0])

    def solve(ocdm, h):
        p = p0._replace(omega_cdm=ocdm, h=h)
        bg = jt.background_tables(p, n_grid=CUT_GRID)
        tab = je.make_tables(p, bg, jt.thermo_tables(p, bg, n_fine=0))
        return tab, je.solve_perturbations(p, tab, jnp.asarray(js.k_mpc), jnp.asarray(grids),
                                           jnp.asarray(masks), jnp.asarray(oi))

    def in_ocdm(x, y):
        return jax.jvp(lambda o: solve(o, y), (x,), (jnp.ones_like(x),))

    x, y = jnp.asarray(COSMOS[0]["omega_cdm"]), jnp.asarray(COSMOS[0]["h"])
    ((tab, out), (_, dout)), (_, (_, d2out)) = jax.jit(lambda x, y: jax.jvp(
        lambda h: in_ocdm(x, h), (y,), (jnp.ones_like(y),)))(x, y)
    return tab, out, dout, d2out


@pytest.fixture(scope="module")
def jax_cut_solve(jax_cut_jets):
    """The tables, the solve and the solve's tangent in ω_cdm of
    ``jax_cut_jets``."""
    return jax_cut_jets[:3]


def test_solve_and_zeta_track_match_jax(cut_solvers, jax_cut_solve):
    """The cut solver's bucket (its low-k modes on the coarse schedule), on
    the tables its solves use."""
    js, _ = cut_solvers
    ((_, grids, masks, oi),) = js.buckets
    ks = js.k_mpc
    assert masks.any() and not masks.all()  # TCA and post-TCA steps
    tab, want, _ = jax_cut_solve
    got = te.solve_perturbations(None, port_tables(tab), ks, grids, masks, oi)
    close(got.delta_m[0].numpy(), want.delta_m, 1e-9, "delta_m")
    close(got.delta_cb[0].numpy(), want.delta_cb, 1e-9, "delta_cb")
    close(got.zeta_ini[0].numpy(), want.zeta_ini, 1e-9, "zeta_ini")
    zj = je.zeta_track(tab, ks[1], jnp.asarray(grids[1]), jnp.asarray(masks[1]))
    zt = te.zeta_track(port_tables(tab), ks[1], grids[1], masks[1])
    close(zt[0].numpy(), zj, 1e-9, "zeta_track")


def test_solver_provider_matches_jax(cut_solvers):
    js, ts = cut_solvers
    kw = dict(da_fid=1.2, h_fid=1.3, rdrag_fid=147.0, h0_fid=0.68)
    pj = je.SolverProvider(JConfig(nl=2, no=2), 0.5, solver=js, **kw)
    pt = te.SolverProvider(TConfig(nl=2, no=2), 0.5, solver=ts, **kw)
    params = {k: torch.tensor([p[k] for p in PARAMS], dtype=torch.float64) for k in PARAMS[0]}
    got_in, got_der = pt.inputs(params), pt.derived(params)
    assert got_in.plin.dtype == torch.float64 and got_in.plin.shape == (2, TConfig().kin.size)
    for i, p in enumerate(PARAMS):
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        want_in, want_der = pj.inputs(jp), pj.derived(jp)
        for f in ("plin", "f", "qperp", "qpar"):
            close(getattr(got_in, f)[i].numpy(), getattr(want_in, f), 1e-8, f)
        for f, v in want_der.items():
            close(got_der[f][i].numpy(), v, 1e-8, f)


def test_solve_gradient_matches_jax_grad(cut_solvers, jax_cut_solve):
    """d(δ_m / ζ_ini) / d ω_cdm of the cut solve, summed over its modes,
    through the background, the recombination recurrence, the tables and
    the solve: autograd of the plain versions against JAX's derivative
    (``jax_cut_solve``)."""
    js, _ = cut_solvers
    ((_, grids, masks, oi),) = js.buckets
    _, o, do = jax_cut_solve
    want = jnp.sum(do.delta_m[0] / o.zeta_ini - o.delta_m[0] * do.zeta_ini / o.zeta_ini ** 2)
    c = COSMOS[0]
    ocdm = torch.tensor([c["omega_cdm"]], dtype=torch.float64, requires_grad=True)
    par = tpar([c])._replace(omega_cdm=ocdm)
    bg = tt.background_tables(par, n_grid=CUT_GRID)
    tab = te.make_tables(par, bg, tt.thermo_tables(par, bg, n_fine=0))
    out = te.solve_perturbations(None, tab, js.k_mpc, grids, masks, oi)
    (got,) = torch.autograd.grad((out.delta_m[0, 0] / out.zeta_ini[0]).sum(), ocdm)
    assert np.isfinite(float(want)) and float(want) != 0.0
    np.testing.assert_allclose(got.numpy()[0], float(want), rtol=1e-7)


def solver_analysis_info(ts, tmp_path) -> dict:
    """A port-only config on ``boltzmann: {name: solver}`` (the cut solver
    ``ts`` passed in the block), sampling ω_cdm, h and b1, with its data and
    covariance files written to ``tmp_path``."""
    kout = np.round(np.arange(0.01, 0.2049, 0.005), 6)
    np.savetxt(tmp_path / "data.txt", np.column_stack([kout, 2e4 / (1 + 30 * kout), 8e3 * kout]),
               header="k P0 P2")
    np.savetxt(tmp_path / "cov.txt", np.eye(2 * kout.size) * 25.0)
    return {
        "theory": {"tracers": {"LRG": {
            "z": 0.5, "nd": 5e-5, "ls": [0, 2], "with_IRresum": True,
            "with_APeffect": {"Om_AP": 0.31},
            "boltzmann": {"name": "solver", "solver": ts, "om_fid": 0.31}}}},
        "params": {"omega_b": 0.02237, "ns": 0.9649, "ln10As": 3.044,
                   "omega_cdm": {"prior": {"min": 0.10, "max": 0.14}, "ref": 0.12},
                   "h": {"prior": {"min": 0.62, "max": 0.72}, "ref": 0.6777},
                   "LRG_b1": {"prior": {"min": 1.0, "max": 4.0}, "ref": 2.2},
                   "LRG_b2": 0.8, "LRG_b4": 0.8},
        "likelihood": {"tracers": ["LRG"], "cov": str(tmp_path / "cov.txt"), "binned": True,
                       "data": {"LRG": {"path": str(tmp_path / "data.txt"), "ls": [0, 2],
                                        "kmin": 0.02, "kmax": 0.2}},
                       "marg": {"LRG_": {"b3": {"loc": 0, "scale": 2}}}},
    }


def solver_analysis_thetas(an) -> np.ndarray:
    """Two points: θ₀ and θ₀ scaled by 1 + 1e-3."""
    theta0 = np.asarray(an.space.theta0())
    return theta0[None] * (1.0 + 1e-3 * np.array([[0.0] * theta0.size, [1.0] * theta0.size]))


def test_analysis_on_the_solver_provider(cut_solvers, tmp_path):
    """A port-only config-driven analysis on ``boltzmann: {name: solver}``
    (the cut solver passed in the block, narrow loop widths): ``logp`` at W=2
    is finite, in the analysis' float32 (the solve in float64)."""
    import eftpipe_tpu_torch.api.orchestrate as torch_orch

    _, ts = cut_solvers
    info = solver_analysis_info(ts, tmp_path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_orch, "EFTConfig", functools.partial(TConfig, nfft_loop=64, nkin=80))
        an = torch_orch.Analysis.from_config(info, dtype=torch.float32, device="cpu",
                                             quadform="plain")
        assert isinstance(an.providers["LRG"], te.SolverProvider)
        assert np.array_equal(an.providers["LRG"].solver.k_mpc, ts.k_mpc)  # (a copy)
        lp = an.logp(torch.as_tensor(solver_analysis_thetas(an), dtype=torch.float32))
    assert lp.dtype == torch.float32 and lp.shape == (2,)
    assert torch.isfinite(lp).all(), lp


# ---------------------------------------------------------------------------
# the gradient's forward-mode route: the card's, here over the plain versions
# ---------------------------------------------------------------------------
def on_the_tangent_route(par) -> bool:
    """``einstein_boltzmann._tangent_route`` without its ``is_cuda``: the
    route the card takes, forced on the CPU."""
    return torch.is_grad_enabled() and any(getattr(par, n).requires_grad for n in te.TABLE_FIELDS)


@pytest.fixture(scope="module")
def solver_tangents(cut_solvers):
    """The cut solver's table part at the two cosmologies through the
    gradient's Function, reached by its private name: the Jacobian in the
    six table fields (``table_tangents``: one pass under forward AD on 12
    rows, here through the plain versions) and the Function's outputs,
    whose graph ends in its backward."""
    _, ts = cut_solvers
    par = tpar(COSMOS)
    fields = [getattr(par, n).clone().requires_grad_() for n in te.TABLE_FIELDS]
    jac = ts.table_tangents(par, te.TABLE_FIELDS)
    out = te._SolverTables.apply(ts, par, jac, te.TABLE_FIELDS, *fields)
    return par, fields, jac, out


def test_solver_tangent_matches_jax_jvp(solver_tangents, jax_cut_solve):
    """The route's tangent in ω_cdm at the first cosmology against
    ``jax.jvp`` of the JAX cut solve (``jax_cut_solve``), every mode and
    output time of δ_m, δ_cb and ζ_ini."""
    _, _, jac, _ = solver_tangents
    _, _, dout = jax_cut_solve
    p = te.TABLE_FIELDS.index("omega_cdm")
    for i, name in enumerate(("delta_m", "delta_cb", "zeta_ini")):
        assert np.isfinite(getattr(dout, name)).all() and np.abs(getattr(dout, name)).max() > 0
        close(jac[i][0, p].numpy(), getattr(dout, name), 1e-7, name)


def test_solver_gradient_matches_plain_reverse(cut_solvers, solver_tangents):
    """The Function's gradient in the six table fields at W=2 (its backward
    contracts the tangents with a seeded cotangent of every output) against
    reverse autograd of the plain table part; its outputs are the plain
    ones bit for bit."""
    _, ts = cut_solvers
    par, fields, _, out = solver_tangents
    rng = np.random.default_rng(3)
    weights = [torch.as_tensor(rng.standard_normal(o.shape)) / o.detach().abs().mean()
               for o in out]

    def loss(outs):
        return sum((w * o).sum() for w, o in zip(weights, outs))

    got = torch.autograd.grad(loss(out), fields, retain_graph=True)
    leaves = [getattr(par, n).clone().requires_grad_() for n in te.TABLE_FIELDS]
    plain = ts.table_part(par._replace(**dict(zip(te.TABLE_FIELDS, leaves))))
    for a, b in zip(out, plain):
        assert torch.equal(a, b.detach())
    want = torch.autograd.grad(loss(plain), leaves)
    for name, g, w in zip(te.TABLE_FIELDS, got, want):
        assert torch.isfinite(w).all() and w.abs().max() > 0, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10,
                                   atol=1e-10 * float(w.abs().max()), err_msg=name)


def coarse_solver(ts) -> te.EBSolver:
    """``ts`` cut further for the analysis' gradient (the route's cost is
    per operation, so per step): its two lowest modes on a schedule of ln-a
    steps ≤ 1, the tables on a ``COARSE_GRID``-point grid (the caller's
    patch of ``te.background_tables``)."""
    fid = te.stack_params([tt.CosmoParams(**te.FIDUCIAL)], "cpu")
    bg, th, _ = ts.tables(fid)
    hb, ht = te.host_tables(bg, th)
    k = CUT_K[:2]
    raw, rm = te.build_schedule(k, hb[0], ht[0], ts.lna_out, pad=False, phase_acc=0.9,
                                dlna_max=1.0)
    grids, masks = te._pad_grids(raw), te._pad_masks(rm)
    return eb_solver_from_numpy(dict(
        k_mpc=k, z_out=ts.z_out, lna_out=ts.lna_out, dlna_f=ts.dlna_f,
        growth_stencil=ts.growth_stencil,
        buckets=[(np.arange(k.size), grids, masks, te.out_indices(grids, ts.lna_out))]),
        device="cpu")


def test_analysis_gradient_through_the_tangent_route(cut_solvers, tmp_path):
    """∇logp of a float64 analysis on the solver provider through the
    gradient's Function (its predicate forced, the card's route) against
    plain autograd: rtol 1e-8; the two ``logp`` are equal bit for bit.  The
    solver is ``coarse_solver``'s."""
    import eftpipe_tpu_torch.api.orchestrate as torch_orch

    _, ts = cut_solvers
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(te, "background_tables",
                   functools.partial(tt.background_tables, n_grid=COARSE_GRID))
        mp.setattr(torch_orch, "EFTConfig", functools.partial(TConfig, nfft_loop=64, nkin=80))
        an = torch_orch.Analysis.from_config(solver_analysis_info(coarse_solver(ts), tmp_path),
                                             dtype=torch.float64, device="cpu", quadform="plain")
        thetas = solver_analysis_thetas(an)

        def value_and_grad():
            x = torch.as_tensor(thetas).requires_grad_()
            lp = an.logp(x)
            (g,) = torch.autograd.grad(lp.sum(), x)
            return lp.detach(), g

        want = value_and_grad()
        mp.setattr(te, "_tangent_route", on_the_tangent_route)
        got = value_and_grad()
    assert torch.isfinite(want[0]).all() and torch.isfinite(want[1]).all()
    assert torch.equal(got[0], want[0])
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=1e-8,
                               atol=1e-8 * float(want[1].abs().max()))


# ---------------------------------------------------------------------------
# the second derivative (ROADMAP A8.2): the jet pass, the card's route here
# over the plain recurrences on hyper-dual operands
# ---------------------------------------------------------------------------
HESS_FIELDS = ("omega_cdm", "h")


def test_solver_hessian_matches_jax_jvp_of_jvp(cut_solvers, jax_cut_jets):
    """The route's mixed second derivative ∂²/∂ω_cdm∂h of δ_m, δ_cb and ζ_ini
    at the first cosmology (``EBSolver.table_hessians``: one pass on its
    three pair rows) against JAX's forward-over-forward derivative of its cut
    solve (``jax_cut_jets``), every mode and output time, rtol 1e-7;
    symmetric in the two fields bit for bit.  ζ_ini's mixed part is rounding
    in both (~1e-21 here, ∝ k²: the O(x²) terms of the adiabatic ζ cancel,
    x = kτ at the start), so it is held to ζ_ini's own scale over ω_cdm·h."""
    _, ts = cut_solvers
    _, out, _, d2out = jax_cut_jets
    hess = ts.table_hessians(tpar(COSMOS[:1]), HESS_FIELDS)
    assert len(hess) == 7
    for i, name in enumerate(("delta_m", "delta_cb", "zeta_ini")):
        want = np.asarray(getattr(d2out, name))
        assert np.isfinite(want).all() and np.abs(want).max() > 0, name
        assert hess[i].shape == (1, 2, 2, *want.shape), name
        assert torch.equal(hess[i][:, 0, 1], hess[i][:, 1, 0]), name
        scale = np.abs(want).max()
        if name == "zeta_ini":
            scale = np.abs(out.zeta_ini).max() / (COSMOS[0]["omega_cdm"] * COSMOS[0]["h"])
        np.testing.assert_allclose(hess[i][0, 0, 1].numpy(), want, rtol=1e-7,
                                   atol=1e-7 * scale, err_msg=name)


def test_solver_double_backward_matches_plain_reverse_over_reverse(cut_solvers):
    """The gradient's Function differentiated twice (``create_graph=True``,
    then a backward of a seeded combination of the gradient's components) in
    ω_cdm and h at W=2, of a seeded loss of every output that is nonlinear
    in them (so the incoming gradient depends on the fields too), against
    reverse-over-reverse autograd of the plain table part: rtol 1e-9; the
    gradient with its graph equals the one without it bit for bit.  The
    solver is ``coarse_solver``'s."""
    _, ts = cut_solvers
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(te, "background_tables",
                   functools.partial(tt.background_tables, n_grid=COARSE_GRID))
        double_backward_against_plain(coarse_solver(ts))


def double_backward_against_plain(ts):
    par = tpar(COSMOS)
    rng = np.random.default_rng(3)
    u = torch.as_tensor(rng.standard_normal(len(HESS_FIELDS)))
    weights = None

    def loss(outs):
        lin = sum((w * o).sum() for w, o in zip(weights, outs))
        return lin + 0.5 * lin ** 2

    def second(outs, leaves):
        g = torch.autograd.grad(loss(outs), leaves, create_graph=True)
        return g, torch.autograd.grad(sum(c * gi.sum() for c, gi in zip(u, g)), leaves)

    fields = [getattr(par, n).clone().requires_grad_() for n in HESS_FIELDS]
    jac = ts.table_tangents(par, HESS_FIELDS)
    out = te._SolverTables.apply(ts, par, jac, HESS_FIELDS, *fields)
    weights = [torch.as_tensor(rng.standard_normal(o.shape)) / o.detach().abs().mean()
               for o in out]
    g0 = torch.autograd.grad(loss(out), fields, retain_graph=True)
    g_got, got = second(out, fields)
    assert all(torch.equal(a, b.detach()) for a, b in zip(g0, g_got))
    leaves = [getattr(par, n).clone().requires_grad_() for n in HESS_FIELDS]
    g_want, want = second(ts.table_part(par._replace(**dict(zip(HESS_FIELDS, leaves)))), leaves)
    for name, a, b in zip(HESS_FIELDS, g_got, g_want):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-9,
                                   atol=1e-9 * float(b.abs().max()), err_msg=name)
    for name, h, w in zip(HESS_FIELDS, got, want):
        assert torch.isfinite(w).all() and w.abs().max() > 0, name
        np.testing.assert_allclose(h.numpy(), w.numpy(), rtol=1e-9,
                                   atol=1e-9 * float(w.abs().max()), err_msg=name)


def test_analysis_hessian_through_the_tangent_route(cut_solvers, tmp_path):
    """``Analysis._hessian`` (the Laplace covariance's) of a float64 analysis
    on the solver provider through the card's route (its predicate forced:
    the first derivative by forward AD, the second by the jet pass) against
    the plain path's double backward: rtol 1e-8 (``logp`` and ∇logp through
    the route: ``test_analysis_gradient_through_the_tangent_route``; with the
    gradient's graph, bit for bit the same:
    ``test_solver_double_backward_matches_plain_reverse_over_reverse``).  The
    solver is ``coarse_solver``'s."""
    import eftpipe_tpu_torch.api.orchestrate as torch_orch

    _, ts = cut_solvers
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(te, "background_tables",
                   functools.partial(tt.background_tables, n_grid=COARSE_GRID))
        mp.setattr(torch_orch, "EFTConfig", functools.partial(TConfig, nfft_loop=64, nkin=80))
        an = torch_orch.Analysis.from_config(solver_analysis_info(coarse_solver(ts), tmp_path),
                                             dtype=torch.float64, device="cpu", quadform="plain")
        theta0 = np.asarray(an.space.theta0())
        want = an._hessian(theta0)
        mp.setattr(te, "_tangent_route", on_the_tangent_route)
        got = an._hessian(theta0)
    assert np.isfinite(want).all() and want.shape == (theta0.size,) * 2
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8 * np.abs(want).max())


def test_jet_helpers():
    """``jet.jet_call`` (nested ``torch.func.jvp``) and ``jet.HyperDual`` on a
    stage of known closed form, f(x, y) = (x² y, eˣ √y / x): the value, both
    first-order parts and the mixed part f''[u_p, u_q] + f'·u_pq; and the
    layout of ``pair_rows`` and ``hessian_of`` (W=2, P=3: six pairs a
    cosmology, (0,0), (0,1), (0,2), (1,1), (1,2), (2,2))."""
    rng = np.random.default_rng(8)
    x, y, xa, ya, xb, yb, xab, yab = (torch.as_tensor(rng.uniform(0.5, 2.0, 5))
                                      for _ in range(8))

    def f(x, y):
        return x ** 2 * y, torch.exp(x) * torch.sqrt(y) / x

    # closed form: gradients and Hessians of both components
    e, r = torch.exp(x), torch.sqrt(y)
    grads = [(2 * x * y, x ** 2), (e * r * (x - 1) / x ** 2, e / (2 * r * x))]
    hesss = [((2 * y, 2 * x), (2 * x, 0 * x)),
             ((e * r * (x ** 2 - 2 * x + 2) / x ** 3, e * (x - 1) / (2 * r * x ** 2)),
              (e * (x - 1) / (2 * r * x ** 2), -e / (4 * r ** 3 * x)))]
    u, ua, ub, uab = (x, y), (xa, ya), (xb, yb), (xab, yab)
    want = [(fi, gx * xa + gy * ya, gx * xb + gy * yb,
             sum(hij * ui * vj for hi, ui in zip(h, ua) for hij, vj in zip(hi, ub))
             + gx * xab + gy * yab)
            for fi, (gx, gy), h in zip(f(x, y), grads, hesss)]
    nested = tj.jet_call(f, tj.Jet(u, ua, ub, uab))
    hd = tj.as_jet(f(*tj.hyper(tj.Jet(u, ua, ub, uab))))
    for got in (nested, hd):
        for k in range(2):
            for part in range(4):
                np.testing.assert_allclose(got[part][k].numpy(), want[k][part].numpy(),
                                           rtol=1e-13, err_msg=f"output {k} part {part}")
    values = {"h": torch.tensor([0.6, 0.7], dtype=torch.float64),
              "omega_b": torch.tensor([0.02, 0.03], dtype=torch.float64),
              "ns": torch.tensor([0.9, 1.0], dtype=torch.float64)}
    rows, jet = tj.pair_rows(values, ("h", "omega_b", "ns"), values["h"])
    pr = tj.pairs(3)
    assert pr == [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    assert torch.equal(rows["h"], torch.tensor([0.6] * 6 + [0.7] * 6, dtype=torch.float64))
    for i in range(3):
        assert torch.equal(jet.v[i], rows[("h", "omega_b", "ns")[i]])
        assert jet.a[i].tolist() == [float(p == i) for p, _ in pr] * 2
        assert jet.b[i].tolist() == [float(q == i) for _, q in pr] * 2
        assert not jet.ab[i].any()
    mixed = torch.arange(12, dtype=torch.float64)[:, None] * torch.ones(1, 4)
    h = tj.hessian_of(mixed, 2, 3)
    assert h.shape == (2, 3, 3, 4) and torch.equal(h, h.transpose(1, 2))
    for w in range(2):
        for k, (p, q) in enumerate(pr):
            assert float(h[w, p, q, 0]) == 6 * w + k


def test_third_derivative_through_the_solver_raises_naming_the_order():
    """The gradient's Function differentiates twice (its Hessian from the
    solver's ``table_hessians``, here a stand-in's) and no more: a backward
    of the gradient with ``create_graph=True`` (a third derivative) raises,
    naming the order, rather than leave the solver's third derivative out."""
    import types

    h = torch.tensor([0.5, 2.0], dtype=torch.float64, requires_grad=True)
    stand_in = types.SimpleNamespace(
        table_part=lambda par: (par.h ** 3,),
        table_hessians=lambda par, names: [6.0 * par.h[:, None, None]])
    par = types.SimpleNamespace(h=h.detach(), _replace=lambda **kw: types.SimpleNamespace(**kw))
    (out,) = te._SolverTables.apply(stand_in, par, [3.0 * h.detach()[:, None] ** 2], ("h",), h)
    (g,) = torch.autograd.grad(out.sum(), h, create_graph=True)
    assert torch.equal(g.detach(), 3.0 * h.detach() ** 2)
    (hh,) = torch.autograd.grad(g.sum(), h, retain_graph=True)
    assert torch.equal(hh, 6.0 * h.detach())
    with pytest.raises(NotImplementedError, match="third derivative"):
        torch.autograd.grad(g.sum(), h, create_graph=True)


@pytest.mark.parametrize("tca", [True, False])
def test_dense_tangents_change_no_number(jax_tables, tca):
    """The dual pass's torch-function mode (``boltzmann/dual.py``: number
    arithmetic on the ``Scalar`` overloads, dense zero tangents) gives plain
    forward AD's primal and tangent bit for bit: one RK4 step with its TCA
    projection, a tangent on the state and on the tables."""
    from torch.autograd import forward_ad

    _, _, _, tab = jax_tables
    ttab = port_tables(tab)
    rng = np.random.default_rng(9)
    ks = np.array([1e-3, 0.05])
    y = t(rng.standard_normal((1, ks.size, te.NSTATE)))
    dy, dst = t(rng.standard_normal(y.shape)), t(rng.standard_normal(ttab.stacked.shape))
    mask = torch.tensor([tca] * ks.size)

    def step():
        dual = ttab._replace(stacked=forward_ad.make_dual(ttab.stacked, dst))
        out, _ = te._rk4_advance(forward_ad.make_dual(y, dy), t(ks), dual, t([-9.0] * 2),
                                 t([-8.98] * 2), mask, mask)
        return forward_ad.unpack_dual(out)

    with forward_ad.dual_level():
        want = step()
        with DenseTangents():
            got = step()
    assert want.tangent is not None and torch.isfinite(want.tangent).all()
    assert torch.equal(got.primal, want.primal) and torch.equal(got.tangent, want.tangent)
