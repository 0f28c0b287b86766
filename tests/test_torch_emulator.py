"""The port's solver emulator (run-time half) against the JAX package's on the
same artifact and identical seeded parameter batches, float64: raw outputs,
the provider's cosmology inputs (sliced and full paths) at rtol 1e-10 on both
flagship tracers' redshifts, the validity box, the load-time metadata checks,
the 4-input (sampled Σm_ν) artifact and the derived quantities."""

import hashlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from eftpipe_tpu.boltzmann import emulator as je
from eftpipe_tpu.models.config import EFTConfig as JConfig
from eftpipe_tpu.models.window import MetaInfoError as JMetaInfoError
from eftpipe_tpu_torch.boltzmann import emulator as te
from eftpipe_tpu_torch.convert import emulator_from_numpy
from eftpipe_tpu_torch.models.ap import lcdm_da, lcdm_hubble
from eftpipe_tpu_torch.models.config import EFTConfig as TConfig
from eftpipe_tpu_torch.models.window import MetaInfoError

FID = dict(omega_b=0.02237, omega_cdm=0.1200, h=0.6777, ln10As=3.044, ns=0.9649)
OM_FID = (FID["omega_b"] + FID["omega_cdm"]) / FID["h"] ** 2
MNU4D = je.DEFAULT_PK_ARTIFACT.parent / "pk_emulator_mnu4d.npz"
RTOL = 1e-10
W = 6


@pytest.fixture(autouse=True)
def sliced_jax(monkeypatch):
    monkeypatch.delenv("EFTPIPE_TPU_EMU_SLICE", raising=False)


@pytest.fixture(scope="module")
def emus():
    return te.PkEmulator.load(te.DEFAULT_PK_ARTIFACT), je.PkEmulator.load(je.DEFAULT_PK_ARTIFACT)


def seeded_params(w=W, seed=0, scale=0.02, extra=None):
    rng = np.random.default_rng(seed)
    base = dict(FID, **(extra or {}))
    return {k: v * (1.0 + scale * rng.standard_normal(w)) for k, v in base.items()}


def as_torch(params, dtype=torch.float64):
    return {k: torch.as_tensor(v, dtype=dtype) for k, v in params.items()}


def as_jax(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def providers(emus, zeff, **kw):
    temu, jemu = emus
    fid = dict(da_fid=lcdm_da(OM_FID, zeff), h_fid=lcdm_hubble(OM_FID, zeff))
    return (te.SolverEmulatorProvider(cfg=TConfig(), zeff=zeff, emulator=temu, **fid, **kw),
            je.SolverEmulatorProvider(cfg=JConfig(), zeff=zeff, emulator=jemu, **fid, **kw))


def jvmap(fn):
    """The JAX function over the walker axis, compiled once (cheaper on the
    CPU than op-by-op dispatch)."""
    return jax.jit(jax.vmap(fn))


def assert_inputs_close(got, want, rtol=RTOL):
    for field in want._fields:
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.shape == w.shape, field
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=field)


def test_artifact_is_the_jax_packages_byte_for_byte(emus):
    digest = [hashlib.sha256(p.read_bytes()).hexdigest()
              for p in (te.DEFAULT_PK_ARTIFACT, je.DEFAULT_PK_ARTIFACT)]
    assert digest[0] == digest[1]
    assert te.DEFAULT_PK_ARTIFACT.parent.parent.name == "boltzmann"
    assert "eftpipe_tpu_torch" in te.DEFAULT_PK_ARTIFACT.parts
    temu, jemu = emus
    for name in ("coeffs", "y_mean", "x_mean", "x_std", "kgrid", "z_grid", "bounds_lo",
                 "coeffs_in", "blend_margin"):
        np.testing.assert_array_equal(getattr(temu, name), getattr(jemu, name), err_msg=name)
    assert (temu.degree, temu.degree_in, temu.input_names, temu.meta) == (
        jemu.degree, jemu.degree_in, jemu.input_names, jemu.meta)
    assert temu.mnu_total() == jemu.mnu_total()
    for a, b in zip(temu.box(), jemu.box()):
        np.testing.assert_array_equal(a, b)


def test_poly_design_term_order():
    rng = np.random.default_rng(1)
    xn = rng.standard_normal((4, 3))
    got = te._poly_design(torch.as_tensor(xn), 5, {}).numpy()
    want = np.asarray(je._poly_design(jnp.asarray(xn), 5))
    np.testing.assert_allclose(got, want, rtol=1e-14)
    assert te.poly_exponents(3, 8).shape == (165, 3)


def test_raw_full_and_sliced_match_jax(emus):
    """The ridge with its inner-ridge smoothstep blend, full and column-sliced:
    points inside the inner box, in its blend margin and outside it."""
    temu, jemu = emus
    lo, hi = temu.box()
    rng = np.random.default_rng(2)
    x = np.concatenate([
        np.array([[FID["omega_b"], FID["omega_cdm"], FID["h"]]]) * (1 + 0.01 * rng.standard_normal((3, 3))),
        lo + (hi - lo) * rng.random((5, 3)),
        temu.blend_hi[None] + 0.5 * temu.blend_margin[None] * rng.random((2, 3)),
    ])
    want = np.asarray(jvmap(jemu.raw)(jnp.asarray(x)))
    got = temu.raw(torch.as_tensor(x))
    assert got.shape == want.shape == (x.shape[0], temu.coeffs.shape[1])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    cols = np.sort(rng.choice(want.shape[1], 300, replace=False))
    sl = temu.raw(torch.as_tensor(x), cols=cols).numpy()
    np.testing.assert_allclose(sl, got.numpy()[:, cols], rtol=1e-13, atol=1e-13)
    tm, tcb, rd = temu.unpack(got)
    assert tm.shape == tcb.shape == (x.shape[0], temu.z_grid.size, temu.kgrid.size)
    np.testing.assert_array_equal(rd.numpy(), got.numpy()[:, -1])


@pytest.mark.parametrize("zeff", [0.70, 0.845])
def test_provider_inputs_match_jax(emus, zeff):
    """Both flagship tracers' redshifts: the sliced provider and the full
    path (``sliced=False``, the JAX package's ``EFTPIPE_TPU_EMU_SLICE=0``)
    against ``jax.vmap(provider.inputs)``."""
    tprov, jprov = providers(emus, zeff)
    params = seeded_params(seed=int(zeff * 100))
    want = jvmap(jprov.inputs)(as_jax(params))
    got = tprov.inputs(as_torch(params))
    assert got.plin.shape == (W, 200) and got.f.shape == (W,)
    assert_inputs_close(got, want)
    assert_inputs_close(tprov.inputs(as_torch(params), sliced=False), want)


@pytest.mark.parametrize("use_cb, zeff", [(True, 0.70), (False, 1.4), (True, 0.0)])
def test_sliced_equals_full_path(emus, use_cb, zeff):
    """cb spectra, and redshifts past either end of the emulator's z grid
    (the log-P blend extrapolates, the growth stencil clamps)."""
    tprov, _ = providers(emus, zeff, use_cb=use_cb)
    params = seeded_params(seed=3)
    a = tprov.inputs(as_torch(params))
    b = tprov.inputs(as_torch(params), sliced=False)
    for field in a._fields:
        np.testing.assert_allclose(getattr(a, field).numpy(), getattr(b, field).numpy(),
                                   rtol=1e-10, atol=0, err_msg=field)
    off = te.SolverEmulatorProvider(cfg=TConfig(), zeff=zeff, emulator=tprov.emulator,
                                    use_ap=False).inputs(as_torch(params))
    assert torch.equal(off.qperp, torch.ones(W, dtype=torch.float64))


def test_validity_box(emus):
    tprov, jprov = providers(emus, 0.70)
    lo, hi = tprov.emulator.box()
    params = seeded_params(w=4, seed=4, scale=0.0)
    params["h"] = np.array([FID["h"], hi[2] * 1.01, lo[2] * 0.99, FID["h"]])
    params["omega_cdm"][3] = hi[1] * 1.05
    got = tprov.validity_logp(as_torch(params)).numpy()
    np.testing.assert_array_equal(got, [0.0, -np.inf, -np.inf, -np.inf])
    np.testing.assert_array_equal(got, np.asarray(jvmap(jprov.validity_logp)(as_jax(params))))
    np.testing.assert_array_equal(tprov.in_box(as_torch(params)).numpy(), [True, False, False, False])
    # out-of-box points are evaluated at the box edge (finite), as in the JAX package
    # (ω_cdm enters P_lin only through the emulator)
    edge = dict(params, omega_cdm=np.clip(params["omega_cdm"], lo[1], hi[1]))
    a, b = tprov.inputs(as_torch(params)), tprov.inputs(as_torch(edge))
    np.testing.assert_array_equal(a.plin.numpy()[3], b.plin.numpy()[3])
    assert torch.isfinite(a.plin).all() and not torch.equal(a.plin[0], a.plin[1])
    clamp = te.SolverEmulatorProvider(cfg=TConfig(), zeff=0.7, emulator=tprov.emulator,
                                      out_of_box="clamp")
    assert not clamp.validity_logp(as_torch(params)).any()


def test_load_metadata_checks():
    cfg = TConfig()
    prov = te.SolverEmulatorProvider.load(cfg=cfg, zeff=0.7, mnu=0.06)
    assert prov.emulator.mnu_total() == pytest.approx(0.06, rel=1e-6)
    for kw in (dict(mnu=0.1), dict(n_ur=prov.emulator.n_ur + 1.0),
               dict(yhe=prov.emulator.yhe + 0.01)):
        with pytest.raises(MetaInfoError, match="trained at"):
            te.SolverEmulatorProvider.load(cfg=cfg, zeff=0.7, **kw)
        with pytest.raises(JMetaInfoError, match="trained at"):
            je.SolverEmulatorProvider.load(cfg=JConfig(), zeff=0.7, **kw)
    # an emulator input that is neither sampled nor fixed
    with pytest.raises(KeyError, match="neither sampled nor fixed"):
        prov.inputs(as_torch({k: v for k, v in seeded_params(w=2).items() if k != "omega_b"}))


@pytest.mark.skipif(not MNU4D.exists(), reason="the JAX package's 4-input artifact is absent")
def test_four_input_artifact_matches_jax():
    """The sampled-Σm_ν artifact of the JAX package, read by path: per-species
    mass sampled, total mass sampled, mass fixed at load."""
    cfg, jcfg = TConfig(nl=2, no=2), JConfig(nl=2, no=2)
    zeff = 0.7
    fid = dict(da_fid=lcdm_da(OM_FID, zeff), h_fid=lcdm_hubble(OM_FID, zeff))
    tprov = te.SolverEmulatorProvider.load(cfg=cfg, zeff=zeff, path=MNU4D, **fid)
    jprov = je.SolverEmulatorProvider.load(cfg=jcfg, zeff=zeff, path=MNU4D, **fid)
    assert tprov.emulator.input_names == ("omega_b", "omega_cdm", "h", "m_ncdm")
    params = seeded_params(seed=6, extra=dict(m_ncdm=0.02))
    assert_inputs_close(tprov.inputs(as_torch(params)), jvmap(jprov.inputs)(as_jax(params)))
    total = {k: v for k, v in params.items() if k != "m_ncdm"}
    total["mnu"] = params["m_ncdm"] * 3.0
    assert_inputs_close(tprov.inputs(as_torch(total)), tprov.inputs(as_torch(params)), rtol=1e-12)
    with pytest.raises(KeyError):
        tprov.inputs(as_torch(seeded_params(seed=6)))
    fixed = te.SolverEmulatorProvider.load(cfg=cfg, zeff=zeff, path=MNU4D, mnu=0.06, **fid)
    jfixed = je.SolverEmulatorProvider.load(cfg=jcfg, zeff=zeff, path=MNU4D, mnu=0.06, **fid)
    assert fixed.mnu_fixed == pytest.approx(0.02) == jfixed.mnu_fixed
    base = seeded_params(seed=7)
    assert_inputs_close(fixed.inputs(as_torch(base)),
                        tprov.inputs(as_torch(dict(base, m_ncdm=np.full(W, 0.02)))), rtol=1e-13)
    with pytest.raises(MetaInfoError, match="covers m_ncdm"):
        te.SolverEmulatorProvider.load(cfg=cfg, zeff=zeff, path=MNU4D, mnu=30.0)
    # the background follows the sampled mass
    e = [float(tprov._background(as_torch(dict(base, mnu=np.full(W, m))))[0][0])
         for m in (0.0, 0.3)]
    assert e[1] > e[0]
    np.testing.assert_array_equal(
        tprov.validity_logp(as_torch(dict(base, m_ncdm=np.full(W, 1e3)))).numpy(), -np.inf)


def test_derived_matches_jax(emus):
    tprov, jprov = providers(emus, 0.70, rdrag_fid=147.09, h0_fid=67.77)
    params = seeded_params(seed=8)
    got = tprov.derived(as_torch(params))
    want = jvmap(jprov.derived)(as_jax(params))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=RTOL,
                                   err_msg=key)
    assert got["sigma8_z"].shape == (W,) and (got["rdrag"] > 100).all()


def test_emulator_from_numpy_carries_the_jax_emulator(emus):
    """``convert.emulator_from_numpy`` on the JAX emulator's fields gives the
    same provider inputs as the port's own load."""
    temu, jemu = emus
    carried = emulator_from_numpy(dict(vars(jemu)))
    tprov = te.SolverEmulatorProvider(cfg=TConfig(), zeff=0.845, emulator=temu)
    cprov = te.SolverEmulatorProvider(cfg=TConfig(), zeff=0.845, emulator=carried)
    params = as_torch(seeded_params(seed=9))
    a, b = cprov.inputs(params), tprov.inputs(params)
    for field in a._fields:
        assert torch.equal(getattr(a, field), getattr(b, field)), field
    with pytest.raises(ValueError, match="unknown"):
        emulator_from_numpy(dict(vars(jemu), bogus=1))


def test_float32_inputs_stay_float32(emus):
    tprov, _ = providers(emus, 0.70)
    params = seeded_params(seed=10)
    p32 = tprov.inputs(as_torch(params, torch.float32))
    p64 = tprov.inputs(as_torch(params))
    assert p32.plin.dtype == torch.float32 and p32.f.dtype == torch.float32
    np.testing.assert_allclose(p32.plin.double().numpy(), p64.plin.numpy(), rtol=2e-3)


def test_template_and_tabulated_providers_match_jax(tmp_path):
    """``boltzmann/providers.py``: a P_lin template read from a file (with and
    without h units) and sampled f, α⊥, α∥, A; and pass-through tables."""
    from eftpipe_tpu.boltzmann import providers as jp
    from eftpipe_tpu_torch.boltzmann import providers as tp

    k = np.geomspace(1e-4, 5.0, 300)
    path = tmp_path / "plin.txt"
    np.savetxt(path, np.column_stack([k, 2e4 * (k / 0.05) ** 0.96 / (1 + (k / 0.05) ** 2.8)]))
    params = seeded_params(w=3, seed=11, extra=dict(f=0.8, alperp=1.0, alpara=1.0, A=1.0))
    for kw in (dict(), dict(with_hubble_unit=False, h=0.6777)):
        tprov = tp.FixedTemplateProvider.from_file(TConfig(), path, **kw)
        jprov = jp.FixedTemplateProvider.from_file(JConfig(), path, **kw)
        np.testing.assert_array_equal(tprov.plin, jprov.plin)
        assert_inputs_close(tprov.inputs(as_torch(params)), jax.vmap(jprov.inputs)(as_jax(params)))
    bare = tprov.inputs(as_torch({"f": params["f"]}))
    assert torch.equal(bare.qperp, torch.ones(3, dtype=torch.float64))
    np.testing.assert_array_equal(bare.plin.numpy(), np.broadcast_to(tprov.plin, (3, 200)))

    tab = {"plin": np.abs(np.random.default_rng(12).standard_normal((3, 200))), "f": params["f"],
           "qpar": params["alpara"]}
    got = tp.TabulatedProvider(cfg=TConfig()).inputs(as_torch(tab))
    want = jax.vmap(jp.TabulatedProvider(cfg=JConfig()).inputs)(as_jax(tab))
    assert_inputs_close(got, want)
    np.testing.assert_allclose(tp.resample_loglog(k, k**-1.5, np.array([1e-5, 10.0])),
                               jp.resample_loglog(k, k**-1.5, np.array([1e-5, 10.0])), rtol=1e-14)
