"""The port's remaining survey-geometry stages (integral constraint, fiber
collisions) and a whole pipeline with window + icc + fiber, or with a window
matrix, against the JAX package on identical NumPy inputs, float64: host
tables ≤ 1e-12 relative, every stage prefix at rtol 1e-10, and the goldens
of the reference implementation where they exist."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from eftpipe_tpu.models import fiber as jfib, icc as jicc, pipeline as jpipe
from eftpipe_tpu.models.config import EFTConfig as JConfig
from eftpipe_tpu.ops import fftlog2d as jf2d
from eftpipe_tpu_torch.convert import pipeline_from_numpy
from eftpipe_tpu_torch.models import fiber as tfib, icc as ticc, pipeline as tpipe
from eftpipe_tpu_torch.models.config import EFTConfig as TConfig
from eftpipe_tpu_torch.ops import fftlog2d as tf2d

from test_fiber import _PS
from test_icc_window_e2e import PSHOT, F, synthetic_files
from test_torch_models import (APEFFECT, NARROW, assert_birds_close, inputs_numpy,
                               jax_inputs, torch_inputs)
from test_torch_window import assert_rel, both_birds, seeded_bird
from test_window_matrix import florian_matrix  # noqa: F401  (fixture)

GOLDENS = __import__("pathlib").Path(__file__).parent / "goldens"


@pytest.fixture(autouse=True)
def dense_jax(monkeypatch):
    monkeypatch.setenv("EFTPIPE_TPU_LOWRANK", "0")
    monkeypatch.setenv("EFTPIPE_TPU_PALLAS", "0")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return synthetic_files(tmp_path_factory.mktemp("stages"))


@pytest.fixture(scope="module")
def files_nl3(tmp_path_factory):
    """Mask, SN and IC tables with three multipoles (an nl=3 tracer), from a
    seeded generator, in the layout of :func:`synthetic_files`."""
    tmp = tmp_path_factory.mktemp("stages_nl3")
    rng = np.random.default_rng(2024)
    s = np.geomspace(1.0, 4000.0, 600)
    roll = 1.0 / (1.0 + (s / 350.0) ** 3)
    mask, sn, ic = tmp / "mask.txt", tmp / "sn.txt", tmp / "ic.npy"
    np.savetxt(mask, np.column_stack([s, roll, 0.06 * roll, 0.02 * roll]))
    np.savetxt(sn, np.column_stack([s, roll**2, 0.05 * roll**2, 0.01 * roll**2]))
    sg = np.geomspace(2.0, 1500.0, 60)
    g = 1.0 / (1.0 + (sg / 300.0) ** 2)
    rows = []
    for il1 in range(3):
        for il2 in range(3):
            amp = (1.0 + 0.05 * rng.standard_normal()) / (1.0 + il1 + il2)
            rows += [[2.0 * il1, 2.0 * il2, s1, s2, amp * g1 * g2]
                     for s1, g1 in zip(sg, g) for s2, g2 in zip(sg, g)]
    np.save(ic, np.asarray(rows))
    return mask, sn, ic


# ---------------------------------------------------------------------------
# integral constraint
# ---------------------------------------------------------------------------

def test_icc_helpers_match_jax_and_goldens():
    p = np.array([-2.0 + 0.3j, -2.5 - 1.0j, -1.7 + 2.2j])
    gold = np.load(GOLDENS / "icc_bessel_matrix.npz")
    for ell in (0, 2, 4):
        np.testing.assert_array_equal(tf2d.bessel_matrix(p, ell), jf2d.bessel_matrix(p, ell))
        np.testing.assert_allclose(tf2d.bessel_matrix(p, ell), gold[f"l{ell}"], rtol=1e-12)

    # the panel reshuffle of tests/test_icc.py
    rng = np.random.default_rng(0)
    rows = [[a, b, x, y, rng.normal()] for a in (0.0, 2.0) for b in (0.0, 2.0, 4.0)
            for x in np.linspace(1, 10, 4) for y in np.linspace(1, 20, 5)]
    arr = np.array(rows)
    shuffled = arr[rng.permutation(arr.shape[0])]
    ours, meta = ticc.ic_panel_to_ndarray(shuffled)
    np.testing.assert_array_equal(ours, np.load(GOLDENS / "icc_panel_ndarray.npz")["panel"])
    np.testing.assert_array_equal(ticc.ic_panel_to_ndarray(arr, inorder=True)[0], ours)
    jours, jmeta = jicc.ic_panel_to_ndarray(shuffled)
    np.testing.assert_array_equal(ours, jours)
    assert all(np.array_equal(meta[k], jmeta[k]) for k in jmeta)
    with pytest.raises(ValueError, match="rows"):
        ticc.ic_panel_to_ndarray(shuffled[1:])

    # shot-noise part, as tests/test_icc.py
    s = np.geomspace(0.1, 3000.0, 300)
    w2 = np.stack([np.exp(-((np.log(s / 300)) ** 2)), 0.3 * np.exp(-((np.log(s / 200)) ** 2))])
    psn = ticc.compute_psn(TConfig(nl=2, no=2), s, w2, na=2)
    assert_rel(psn, jicc.compute_psn(JConfig(nl=2, no=2), s, w2, na=2), name="psn")
    want = np.load(GOLDENS / "icc_psn.npz")["psn"]
    np.testing.assert_allclose(psn, want, rtol=1e-6, atol=1e-9 * np.abs(want).max())

    # the 2-D FFTLog on a separable table
    sg = np.geomspace(0.5, 400.0, 60)
    table = np.outer(np.exp(-np.log(sg / 50.0) ** 2), np.exp(-np.log(sg / 80.0) ** 2))
    kw = dict(nx=128, ny=128, xmin=1e-3, xmax=sg[-1], ymin=1e-3, ymax=sg[-1],
              xbias=-2.0, ybias=-2.0)
    k = np.array([0.05, 0.1, 0.2])
    args = dict(k1=k, k2=k[:2], l1=2, l2=0, window=1.0)
    assert_rel(tf2d.HostFFTLog2D(**kw).spherical_transform(sg, sg, table, **args),
               jf2d.HostFFTLog2D(**kw).spherical_transform(sg, sg, table, **args), name="2d")


def test_icc_tables_match_jax_and_cache(files, tmp_path):
    _, sn, ic = files
    kw = dict(pshot=PSHOT, icc_configspace_sn_file=sn, icc_configspace_ic_file=ic,
              nmax=512, nxmax=128, nymax=128)
    tab = ticc.build_icc_tables(TConfig(nl=2, no=2), cache_dir=tmp_path / "t", **kw)
    jtab = jicc.build_icc_tables(JConfig(nl=2, no=2), cache_dir=tmp_path / "j", **kw)
    for key in ("wmat", "wal", "psn", "p"):
        assert_rel(tab[key], jtab[key], name=key)
    assert tab["meta"] == jtab["meta"]
    names = sorted(p.name for p in (tmp_path / "t").glob("icc_*.npz"))
    assert names and names == sorted(p.name for p in (tmp_path / "j").glob("icc_*.npz"))
    again = ticc.build_icc_tables(TConfig(nl=2, no=2), cache_dir=tmp_path / "t", **kw)
    np.testing.assert_array_equal(again["wmat"], tab["wmat"])
    with pytest.raises(ValueError, match="requires"):
        ticc.build_icc_tables(TConfig(nl=2, no=2), pshot=PSHOT)
    # a text IC table reads like the .npy one
    txt = tmp_path / "ic.txt"
    np.savetxt(txt, np.load(ic), header="l1 l2 s1 s2 value")
    np.testing.assert_array_equal(ticc.read_ic_file(txt), np.load(ic))


def test_window_with_icc_matches_golden(files):
    """The coupled window (W − W_icc, P_icc) after the loop engine at W=1
    against the reference implementation's golden (tests/test_icc_window_e2e.py)."""
    mask, sn, ic = files
    cfg = TConfig(nl=2, no=2)
    pipe = tpipe.TracerPipeline.build(
        cfg, with_irresum=False, device="cpu",
        window=dict(window_configspace_file=mask, nmax=1024),
        icc=dict(pshot=PSHOT, icc_configspace_sn_file=sn, icc_configspace_ic_file=ic,
                 nmax=1024, nxmax=512, nymax=512))
    from test_icc_window_e2e import _plin

    plin = np.array(_plin(JConfig(nl=2, no=2))[1])
    one = torch.ones(1, dtype=torch.float64)
    bird = pipe.compute_bird(tpipe.CosmoInputs(plin=torch.as_tensor(plin)[None], f=F * one,
                                               qperp=one, qpar=one))
    gold = np.load(GOLDENS / "icc_window_e2e.npz")
    for ref_name, name in (("P11l", "p11l"), ("Ploopl", "ploopl"), ("Pctl", "pctl"),
                           ("Pstl", "pstl"), ("Picc", "picc")):
        a = gold[ref_name]
        np.testing.assert_allclose(getattr(bird, name).numpy()[0], a, rtol=5e-6,
                                   atol=1e-8 * np.abs(a).max(), err_msg=ref_name)


# ---------------------------------------------------------------------------
# fiber collisions
# ---------------------------------------------------------------------------

def test_fiber_tables_match_jax_and_golden():
    kw = dict(fs=0.6, dfc=0.43 / 0.6777, ktrust=0.25)
    cfg = TConfig(nl=3, no=3)
    ft = tfib.build_fiber_tables(cfg, **kw)
    jft = jfib.build_fiber_tables(JConfig(nl=3, no=3), **kw)
    assert_rel(ft["fmat"], jft["fmat"], name="fmat")
    gold = np.load(GOLDENS / "fiber_corrections.npz")
    got = np.einsum("apkj,pnj->ank", ft["fmat"], _PS)
    np.testing.assert_allclose(got, gold["dpcorr"], rtol=1e-7,
                               atol=1e-10 * np.abs(gold["dpcorr"]).max())
    np.testing.assert_allclose(tfib.dp_uncorr(gold["k"], 0.6, 0.43 / 0.6777), gold["dpuncorr"],
                               rtol=1e-12)
    x = np.linspace(0.1, 0.9, 7)
    for l, lp in ((2, 0), (4, 0), (4, 2), (6, 0), (6, 2), (6, 4), (2, 2)):
        np.testing.assert_array_equal(tfib.hllp(l, lp, x), jfib.hllp(l, lp, x))


@pytest.mark.parametrize("fiber_st", [False, True])
def test_apply_fiber_matches_jax(fiber_st):
    cfg = TConfig(nl=3, no=3)
    kw = dict(fs=0.6, dfc=0.63, fiber_st=fiber_st)
    ft = tfib.build_fiber_tables(cfg, **kw)
    jft = jfib.build_fiber_tables(JConfig(nl=3, no=3), **kw)
    jbird, tbird = both_birds(seeded_bird(cfg, seed=9))
    want = jax.vmap(lambda b: jfib.apply_fiber(jft, JConfig(nl=3, no=3), b))(jbird)
    got = tfib.apply_fiber(tfib.fiber_tables_to(ft, "cpu", torch.float64), cfg, tbird)
    for field in want._fields:
        assert_rel(getattr(got, field).numpy(), getattr(want, field), rtol=1e-10, name=field)
    assert torch.equal(got.pstl, tbird.pstl) != fiber_st


# ---------------------------------------------------------------------------
# whole pipelines
# ---------------------------------------------------------------------------

def stage_options(files, wm_path):
    mask, sn, ic = files
    return {
        "window+icc+fiber": dict(
            window=dict(window_configspace_file=mask, nmax=512),
            icc=dict(pshot=PSHOT, icc_configspace_sn_file=sn, icc_configspace_ic_file=ic,
                     nmax=512, nxmax=128, nymax=128),
            fiber=dict(fs=0.6, dfc=0.43 / 0.6777, ktrust=0.25)),
        "window_matrix": dict(
            window_matrix=dict(path=wm_path, ells=[0, 2, 4], kmin=0.01, kmax=0.2,
                               window_st=True)),
    }


@pytest.fixture(scope="module", params=["window+icc+fiber", "window_matrix"])
def staged(request, files_nl3, florian_matrix):  # noqa: F811
    nl = 3
    opts = stage_options(files_nl3, florian_matrix)[request.param]
    jp = jpipe.TracerPipeline.build(JConfig(nl=nl, no=nl, **NARROW), zeff=0.7,
                                    with_irresum=True, apeffect=dict(APEFFECT), **opts)
    tp = tpipe.TracerPipeline.build(TConfig(nl=nl, no=nl, **NARROW), zeff=0.7,
                                    with_irresum=True, apeffect=dict(APEFFECT), device="cpu",
                                    dtype=torch.float64, **opts)
    return request.param, jp, tp, inputs_numpy(tp.cfg, seed=4)


STOPS = {"window+icc+fiber": ["APeffect", "window", None],
         "window_matrix": ["APeffect", "window", "window_matrix", None]}


def test_staged_pipeline_prefixes_match_jax(staged):
    """Every stage prefix (stop_after) and the full bird against the JAX
    pipeline's, and the port's snapshots against the same prefixes."""
    label, jp, tp, x = staged
    want = {}
    for stop in STOPS[label]:
        want[stop] = jax.vmap(lambda ci: jp.compute_bird(ci, stop_after=stop))(jax_inputs(x))
        assert_birds_close(tp.compute_bird(torch_inputs(x), stop_after=stop), want[stop])
    bird, snaps = tp.compute_bird(torch_inputs(x), with_snapshots=True)
    assert list(snaps) == ["nonlinear", "IRresum", "APeffect"] + (
        ["window", "fiber"] if label == "window+icc+fiber" else ["window_matrix"])
    assert_birds_close(bird, want[None])
    for name in ("APeffect", "window", "window_matrix"):
        if name in snaps:
            assert_birds_close(snaps[name], want[name])


def test_pipeline_from_numpy_carries_stage_state(staged):
    """The JAX pipeline's window / window-matrix / fiber / icc state as NumPy
    through ``convert.pipeline_from_numpy``: the same bird as the port's own
    build."""
    _, jp, tp, x = staged

    def plain(tree):
        if dataclasses.is_dataclass(tree):
            return {f.name: plain(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
        if isinstance(tree, dict):
            return {k: plain(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(plain(v) for v in tree)
        return np.asarray(tree) if isinstance(tree, jnp.ndarray) else tree

    state = {k: plain(getattr(jp, k)) for k in ("nt", "bt", "rt", "at", "wt", "wmt", "ft")}
    if jp.nt["plan_cf"] is jp.nt["plan_pk"]:
        state["nt"]["plan_cf"] = None
    carried = pipeline_from_numpy(tp.cfg, state, device="cpu", dtype=torch.float64, zeff=0.7)
    assert (carried.wt is None, carried.wmt is None, carried.ft is None) == (
        tp.wt is None, tp.wmt is None, tp.ft is None)
    want = tp.compute_bird(torch_inputs(x))
    got = carried.compute_bird(torch_inputs(x))
    for field in want._fields:
        np.testing.assert_allclose(getattr(got, field).numpy(), getattr(want, field).numpy(),
                                   rtol=1e-12, atol=1e-14 * float(getattr(want, field).abs().max()),
                                   err_msg=field)


def test_staged_float32_close_to_float64(staged, files_nl3, florian_matrix):  # noqa: F811
    """float32 stages against float64 on the same µ quadrature: every P-side
    field within 1e-4 of its largest entry."""
    label, _, tp, x = staged
    t32 = tpipe.TracerPipeline.build(tp.cfg, zeff=0.7, with_irresum=True,
                                     apeffect=dict(APEFFECT), device="cpu", dtype=torch.float32,
                                     **stage_options(files_nl3, florian_matrix)[label])
    t64 = dataclasses.replace(tp, at={**tp.at, "mu": tp.at["mu_gl"], "proj": tp.at["proj_gl"]})
    a = t32.compute_bird(torch_inputs(x, torch.float32))
    b = t64.compute_bird(torch_inputs(x))
    assert a.p11l.dtype == torch.float32
    for field in ("p11l", "ploopl", "pctl", "pstl", "picc"):
        want = getattr(b, field).numpy()
        if not np.abs(want).max():
            continue
        np.testing.assert_allclose(getattr(a, field).double().numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=f"{label}:{field}")
