"""Pipeline stages of the port against the eager JAX functions on a narrow
configuration (nfft_loop=64, nkin=80): identical NumPy inputs from a seed,
float64, rtol 1e-10 (+ 1e-12 of the largest entry, for entries that cancel).
The JAX side runs its DENSE quadratic forms (EFTPIPE_TPU_LOWRANK=0)."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from eftpipe_tpu.models.config import EFTConfig as JConfig
from eftpipe_tpu.models import pipeline as jpipe, nonlinear as jnl
from eftpipe_tpu_torch.models.config import EFTConfig as TConfig
from eftpipe_tpu_torch.models import pipeline as tpipe, nonlinear as tnl, bird as tbird
from eftpipe_tpu_torch.models import resum as tresum, ap as tap, transforms as ttr
from eftpipe_tpu_torch.convert import pipeline_from_numpy

NARROW = dict(nfft_loop=64, nkin=80)
APEFFECT = dict(om_ap=0.31, z_ap=0.7, rdrag_ap=147.66, hubble_ap=0.6777)
KOUT = np.arange(0.02, 0.2049, 0.01)
W = 3
RTOL = 1e-10


@pytest.fixture(autouse=True)
def dense_jax(monkeypatch):
    monkeypatch.setenv("EFTPIPE_TPU_LOWRANK", "0")
    monkeypatch.setenv("EFTPIPE_TPU_PALLAS", "0")


def inputs_numpy(cfg, seed=0):
    rng = np.random.default_rng(seed)
    k = cfg.kin
    base = 2e4 * (k / 0.05) ** 0.96 / (1.0 + (k / 0.05) ** 2.8)
    plin = base[None, :] * (1.0 + 0.05 * rng.standard_normal((W, 1))) * (
        1.0 + 0.02 * np.sin(3 * np.log(k))[None, :] * rng.standard_normal((W, 1)))
    return dict(plin=plin, f=0.8 + 0.05 * rng.standard_normal(W),
                qperp=1.0 + 0.02 * rng.standard_normal(W),
                qpar=1.0 + 0.02 * rng.standard_normal(W))


@pytest.fixture(scope="module", params=[2, 3], ids=["nl2", "nl3"])
def both(request):
    nl = request.param
    jcfg = JConfig(nl=nl, no=nl, **NARROW)
    tcfg = TConfig(nl=nl, no=nl, **NARROW)
    jp = jpipe.TracerPipeline.build(jcfg, zeff=0.7, with_irresum=True, apeffect=dict(APEFFECT))
    tp = tpipe.TracerPipeline.build(tcfg, zeff=0.7, with_irresum=True, apeffect=dict(APEFFECT),
                                    device="cpu", dtype=torch.float64)
    return jp, tp, inputs_numpy(tcfg, seed=nl)


def jax_inputs(x):
    return jpipe.CosmoInputs(**{k: jnp.asarray(v) for k, v in x.items()})


def torch_inputs(x, dtype=torch.float64):
    return tpipe.CosmoInputs(**{k: torch.as_tensor(v, dtype=dtype) for k, v in x.items()})


def assert_close(got, want, rtol=RTOL, scale_atol=1e-12, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=scale_atol * np.abs(want).max(),
                               err_msg=name)


def assert_birds_close(tb, jb, **kw):
    for field in jb._fields:
        assert_close(getattr(tb, field).numpy(), getattr(jb, field), name=field, **kw)


def _flat(tree, prefix=""):
    """Flatten a Phase-A table tree to {path: array/scalar}."""
    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def test_phase_a_tables_match_jax_tables(both):
    """The port's own host-built tables against the JAX package's: ≤ 1e-14
    relative (bitwise where the code is a copy)."""
    jp, tp, _ = both
    cfg = tp.cfg
    ours = dict(nt=tnl.nonlinear_tables_numpy(cfg), bt=tbird.bird_tables_numpy(cfg),
                rt=tresum.resum_tables_numpy(cfg), at=tap.ap_tables_numpy(cfg, **APEFFECT))
    theirs = dict(nt=jp.nt, bt=jp.bt, rt=jp.rt, at=jp.at)
    n = 0
    for name in ours:
        a, b = _flat(ours[name]), _flat(theirs[name])
        missing = set(a) - set(b)
        assert not missing, (name, missing)
        for key, va in a.items():
            if isinstance(va, np.ndarray):
                np.testing.assert_allclose(va, np.asarray(b[key]), rtol=1e-14, atol=0,
                                           err_msg=f"{name}.{key}")
                n += 1
            else:
                assert va == b[key] or (va is None and b[key] is None), (name, key)
    assert n > 40
    bo, bj = ttr.build_binning_matrix(cfg, KOUT), jp.binning_tables(KOUT)
    for key in bo:
        np.testing.assert_array_equal(bo[key], bj[key])


def test_nonlinear_pscf_matches_jax(both):
    jp, tp, x = both
    want = jax.vmap(lambda p: jnl.nonlinear_pscf(jp.nt, jp.cfg, p))(jnp.asarray(x["plin"]))
    got = tnl.nonlinear_pscf(tp.nt, tp.cfg, torch.as_tensor(x["plin"]))
    assert set(got) == set(want) == {"p22", "p13_kernel", "c11", "cct", "cct_nnlo", "c22", "c13"}
    for key in want:
        assert_close(got[key].numpy(), want[key], name=key)
    plain = tnl.nonlinear_pscf(tp.nt, tp.cfg, torch.as_tensor(x["plin"]), quadform="plain")
    for key in want:
        assert_close(plain[key].numpy(), got[key].numpy(), rtol=1e-13, name=key)
    with pytest.raises(ValueError):
        tnl.nonlinear_pscf(tp.nt, tp.cfg, torch.as_tensor(x["plin"]), quadform="einsum")


@pytest.mark.parametrize("stage", ["nonlinear", "IRresum", "APeffect"])
def test_stage_prefix_matches_jax(both, stage):
    jp, tp, x = both
    want = jax.vmap(lambda ci: jp.compute_bird(ci, stop_after=stage))(jax_inputs(x))
    got = tp.compute_bird(torch_inputs(x), stop_after=stage)
    assert_birds_close(got, want)


def test_snapshots_and_binned_product_match_jax(both):
    jp, tp, x = both
    jbin, tbin = jp.binning_tables(KOUT), tp.binning_tables(KOUT)

    def jrun(ci):
        bird, snaps = jp.compute_bird(ci, with_snapshots=True)
        return snaps, jp.product(bird, binning=jbin)[2]

    jsnaps, jprod = jax.vmap(jrun)(jax_inputs(x))
    bird, snaps = tp.compute_bird(torch_inputs(x), with_snapshots=True)
    ls, kret, prod = tp.product(bird, binning=tbin)
    assert list(snaps) == ["nonlinear", "IRresum", "APeffect"]
    assert set(jsnaps) == set(snaps)
    for name in snaps:
        assert_birds_close(snaps[name], jsnaps[name])
    assert_birds_close(prod, jprod)
    assert ls == [2 * i for i in range(tp.cfg.no)] and prod.p11l.shape[-1] == KOUT.size
    assert tp.product_info(binning=tbin)[2] == KOUT.size


def test_pipeline_from_numpy_carries_jax_state(both):
    """The JAX package's Phase-A state, extracted as NumPy, through
    ``convert.pipeline_from_numpy``: same outputs as the JAX pipeline."""
    jp, tp, x = both

    def plain(tree):
        if dataclasses.is_dataclass(tree):
            return {f.name: plain(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
        if isinstance(tree, dict):
            return {k: plain(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(plain(v) for v in tree)
        return tree

    nt = plain(jp.nt)
    if jp.nt["plan_cf"] is jp.nt["plan_pk"]:
        nt["plan_cf"] = None
    carried = pipeline_from_numpy(
        tp.cfg, dict(nt=nt, bt=plain(jp.bt), rt=plain(jp.rt), at=plain(jp.at)),
        device="cpu", dtype=torch.float64, zeff=0.7)
    assert carried.nt["plan_cf"] is carried.nt["plan_pk"]
    want = jax.vmap(jp.compute_bird)(jax_inputs(x))
    assert_birds_close(carried.compute_bird(torch_inputs(x)), want)


def test_float32_pipeline_close_to_float64(both):
    """float32 (Gauss–Legendre-16 AP quadrature) against float64 (200-point
    trapezoid): the multipoles that enter the likelihood agree to 2e-3 of
    their largest value on this narrow configuration."""
    _, tp, x = both
    t32 = tpipe.TracerPipeline.build(tp.cfg, zeff=0.7, with_irresum=True,
                                     apeffect=dict(APEFFECT), device="cpu", dtype=torch.float32)
    a = t32.compute_bird(torch_inputs(x, torch.float32))
    b = tp.compute_bird(torch_inputs(x))
    assert a.p11l.dtype == torch.float32
    for field in ("p11l", "ploopl", "pctl"):
        got, want = getattr(a, field).double().numpy(), getattr(b, field).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3 * np.abs(want).max(), err_msg=field)


def test_fold_ab_reference_matches_folded(both):
    """The complex form on the unfolded matrices (``cf_contract``) equals the
    folded real form (``quad_form_real``): 1e-10 of the largest entry."""
    _, tp, x = both
    m = tnl.complex_cf_matrices(tp.cfg, ell_index=1)
    mc = (torch.as_tensor(np.ascontiguousarray(m.real)), torch.as_tensor(np.ascontiguousarray(m.imag)))
    ref, folded = tnl.cf_loop_complex(tp.nt, tp.cfg, torch.as_tensor(x["plin"]), mc, ell_index=1)
    assert ref.shape == folded.shape == (W, 38, tp.cfg.ns)
    assert_close(ref.numpy(), folded.numpy(), rtol=1e-9, scale_atol=1e-10)


@pytest.mark.parametrize("option", ["window", "window_matrix", "icc", "fiber"])
def test_unported_stages_raise(option):
    """Every survey-geometry stage is ported: each reaches its host builder
    (which refuses an unknown keyword), the dotted window-builder extension
    point too: it resolves the builder it names, which gets the keywords."""
    with pytest.raises(TypeError, match="unexpected keyword argument 'x'"):
        tpipe.TracerPipeline.build(TConfig(**NARROW), device="cpu", **{option: dict(x=1)})
    if option == "window":
        with pytest.raises(TypeError, match="unexpected keyword argument 'x'"):
            tpipe.TracerPipeline.build(
                TConfig(**NARROW), device="cpu",
                window=dict(builder="eftpipe_tpu_torch.models.window.build_window_tables", x=1))
        with pytest.raises(ModuleNotFoundError):
            tpipe.TracerPipeline.build(TConfig(**NARROW), device="cpu",
                                       window=dict(builder="no_such_pkg.fn"))


def test_chained_and_premix_raise(both):
    """Chained products, the frozen template and the premixed CF loop are
    ported (their parity tests: ``test_torch_orchestrate.py``,
    ``test_torch_lowrank.py``): the (channel, f-power)-premixed loop
    ``cloop_grp`` of a dense ``nonlinear_pscf`` output assembles as in the
    JAX package (float64, rtol 1e-10)."""
    from eftpipe_tpu.models import bird as jbird

    jp, tp, x = both
    assert tp.product_info(chained=True)[0] == jp.product_info(chained=True)[0] \
        == [2 * i for i in range(tp.cfg.no - 1)]
    frozen = dataclasses.replace(tp).freeze_template(x["plin"][0])
    assert frozen.frozen["nl_out"]["p22"].shape[0] == 1 and tp.frozen is None
    out = tnl.nonlinear_pscf(tp.nt, tp.cfg, torch.as_tensor(x["plin"]))
    grp = np.random.default_rng(5).standard_normal((W, 22, tp.cfg.nl, tp.cfg.ns))
    premixed = {k: v.numpy() for k, v in out.items() if k not in ("c22", "c13")}
    premixed["cloop_grp"] = grp
    want = jax.vmap(lambda o, p, f: jbird.assemble_bird(jp.bt, jp.cfg, o, p, f))(
        {k: jnp.asarray(v) for k, v in premixed.items()}, jnp.asarray(x["plin"]),
        jnp.asarray(x["f"]))
    got = tbird.assemble_bird(tp.bt, tp.cfg, {k: torch.as_tensor(v) for k, v in premixed.items()},
                              torch.as_tensor(x["plin"]), torch.as_tensor(x["f"]))
    assert_birds_close(got, want)


def test_ap_and_binning_helpers_match_jax():
    from eftpipe_tpu.models import ap as jap, transforms as jtr

    at = tap.ap_tables_numpy(TConfig(**NARROW), **APEFFECT)
    jat = jap.build_ap_tables(JConfig(**NARROW), **APEFFECT)
    assert tap.ap_params(at, 1.3, 0.9) == jap.ap_params(jat, 1.3, 0.9)
    assert tap.alperp_alpara(at, 1.3, 0.9, 150.0, 0.7) == jap.alperp_alpara(jat, 1.3, 0.9, 150.0, 0.7)
    assert tap.lcdm_da(0.31, 0.7) == jap.lcdm_da(0.31, 0.7)
    assert tap.ap_quadrature(at, torch.float32)[0].shape == (16,)
    assert tap.ap_quadrature(at, torch.float64)[0].shape == (200,)
    no_gl = tap.ap_tables_numpy(TConfig(**NARROW), n_gl=0, **APEFFECT)
    assert tap.ap_quadrature(no_gl, torch.float32)[0].shape == (200,)
    gl = tap.ap_tables_numpy(TConfig(**NARROW), quadrature="gauss_legendre", **APEFFECT)
    for dtype in (torch.float32, torch.float64):
        np.testing.assert_array_equal(tap.ap_quadrature(gl, dtype)[0], at["mu_gl"])
        np.testing.assert_array_equal(tap.ap_quadrature(gl, dtype)[1], at["proj_gl"])
    for bad in (dict(quadrature="midpoint"), dict(quadrature="gauss_legendre", n_gl=0)):
        with pytest.raises(ValueError):
            tap.ap_tables_numpy(TConfig(**NARROW), **bad, **APEFFECT)
    with pytest.raises(ValueError):
        tap.ap_tables_numpy(TConfig(**NARROW))
    kout = np.arange(0.0125, 0.2, 0.005)
    for a, b in zip(ttr.infer_kedges(kout), jtr.infer_kedges(kout)):
        np.testing.assert_array_equal(a, b)
    ours = ttr.build_binning_matrix(TConfig(**NARROW), kout, kstart=0.0, kend=0.3, nbins=60)
    theirs = jtr.build_binning_matrix(JConfig(**NARROW), kout, kstart=0.0, kend=0.3, nbins=60)
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key])
    with pytest.raises(ValueError):
        ttr.build_binning_matrix(TConfig(**NARROW), kout, kstart=0.0)
    with pytest.raises(ValueError):
        ttr.infer_kedges(np.geomspace(0.001, 0.2, 20))
