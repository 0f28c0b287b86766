"""The low-rank / premixed route of the port (``quadform="lowrank"``) against
the JAX package, which takes that route by itself for float32 evaluation.

* the factors and the premix tables: bitwise against the JAX builders (the
  port's copies run the same NumPy operations in the same order);
* ``quad_form_lowrank`` in float64 against ``qf_lowrank_xla`` (rtol 1e-12),
  its gradient against ``jax.grad``, ``gradcheck`` and a double backward;
* the loop engine + ``assemble_bird`` in float32 on both sides, premix on
  and off, and in float64 against the port's own dense route within the
  truncation envelope of ``tests/test_lowrank.py`` (2e-4 of max);
* a narrow full-shape ``Analysis`` on the route in float32 against JAX's
  float32 ``Analysis.logp``; the CLI's dtype (float32 unless
  ``--dtype float64``) and route switches.

Narrow widths (``nfft_loop=64``, ``nkin=80``) throughout; the JAX switches
are set with ``monkeypatch`` only."""

import functools
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import eftpipe_tpu.api.orchestrate as jorch
import eftpipe_tpu_torch.api.orchestrate as torch_orch
from eftpipe_tpu.models.config import EFTConfig as JConfig
from eftpipe_tpu.models import nonlinear as jnl, bird as jbird
from eftpipe_tpu.ops import pallas_kernels as jpk
from eftpipe_tpu_torch import to_device
from eftpipe_tpu_torch.models.config import EFTConfig as TConfig
from eftpipe_tpu_torch.models import nonlinear as tnl, bird as tbird
from eftpipe_tpu_torch.ops import quadform as tqf

NARROW = dict(nfft_loop=64, nkin=80)
W = 3
# float32 against float32: the two packages round the same arithmetic in
# other orders (XLA's fused einsums, torch's matmuls); the FFTLog and the
# squares' signed sums carry a condition number of ~100 (cct_nnlo, cloopl),
# so ~1e-5 of each field's largest entry (measured ≤ 7e-6), with margin
F32_REL = 5e-5
# the truncation envelope of the shipping 1e-5 cut against the dense form
# (tests/test_lowrank.py:189-230)
TRUNC_REL = 2e-4


@pytest.fixture(autouse=True)
def jax_lowrank(monkeypatch):
    """The JAX package's float32 route: low-rank on, the default cut, the
    premixed CF loop (a test turns the premix off where it says so)."""
    monkeypatch.setenv("EFTPIPE_TPU_LOWRANK", "1")
    monkeypatch.delenv("EFTPIPE_TPU_LOWRANK_TOL", raising=False)
    monkeypatch.setenv("EFTPIPE_TPU_CF_PREMIX", "1")
    monkeypatch.setenv("EFTPIPE_TPU_PALLAS", "0")


def _decaying_matrices(rng, bl=6, n=63, decay=0.5):
    """Random matrices with exponentially decaying symmetric spectra and a
    small skew part (``tests/test_lowrank.py::_decaying_matrices``)."""
    lam = np.exp(-decay * np.arange(n)) * rng.standard_normal((bl, n))
    qmat = np.linalg.qr(rng.standard_normal((bl, n, n)))[0]
    sym = np.einsum("bij,bj,bkj->bik", qmat, lam, qmat)
    skew = 1e-3 * rng.standard_normal((bl, n, n))
    return sym + (skew - np.swapaxes(skew, -1, -2))


def plin_batch(cfg, seed, nw=W):
    rng = np.random.default_rng(seed)
    k = cfg.kin
    base = 2e4 * (k / 0.05) ** 0.96 / (1.0 + (k / 0.05) ** 2.8)
    plin = base[None, :] * (1.0 + 0.05 * rng.standard_normal((nw, 1))) * (
        1.0 + 0.02 * np.sin(3 * np.log(k))[None, :] * rng.standard_normal((nw, 1)))
    return plin, 0.8 + 0.05 * rng.standard_normal(nw)


@pytest.fixture(scope="module", params=[2, 3], ids=["nl2", "nl3"])
def tables(request):
    """Host tables of both packages at one narrow config (JAX: its default
    1e-5 cut, set here without touching the environment of other tests)."""
    nl = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("EFTPIPE_TPU_LOWRANK_TOL", raising=False)
        jcfg, tcfg = JConfig(nl=nl, no=nl, **NARROW), TConfig(nl=nl, no=nl, **NARROW)
        jnt, jbt = jnl.build_nonlinear_tables(jcfg), jbird.build_bird_tables(jcfg)
    tnt = tnl.nonlinear_tables_numpy(tcfg, lowrank_tol=tnl.LOWRANK_TOL)
    return jcfg, tcfg, jnt, jbt, tnt, tbird.bird_tables_numpy(tcfg)


# ----------------------------------------------------------------------
# host tables, bitwise
# ----------------------------------------------------------------------
@pytest.mark.parametrize("tol, whiten", [(1e-8, False), (1e-5, True), (1e-2, True), (0.0, False)])
def test_lowrank_factors_match_jax_on_random_matrices(tol, whiten):
    rng = np.random.default_rng(7)
    m = _decaying_matrices(rng)
    wh = np.exp(-0.05 * np.arange(m.shape[-1])) if whiten else None
    ours = tqf.lowrank_factors(m, tol=tol, whiten=wh)
    theirs = jpk.lowrank_factors(m, tol=tol, whiten=wh)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert ours[0].shape[0] % 128 == 0
    assert tqf.lowrank_rank(ours[1]) == int(np.count_nonzero(theirs[1]))


def test_lowrank_tables_match_jax(tables):
    """The factors of the narrow config's folds, the whitening profiles and
    the premix tables: bitwise the JAX builders'."""
    jcfg, tcfg, jnt, jbt, tnt, tbt = tables
    assert set(tnt["lowrank"]) == set(jnt["lowrank"])
    for key, value in tnt["lowrank"].items():
        np.testing.assert_array_equal(value, jnt["lowrank"][key], err_msg=key)
    for plan in ("plan_pk", "plan_cf"):
        ours = tnl._fid_coef_mag(tnt[plan], tcfg.kin)
        np.testing.assert_array_equal(ours, jnl._fid_coef_mag(jnt[plan], jcfg.kin))
        np.testing.assert_array_equal(tnl._whiten_dofs(ours, tnt["nc"]),
                                      jnl._whiten_dofs(ours, jnt["nc"]))
    keys, onehot, pexp, members = tbird.loop_cp_groups()
    jkeys, jonehot, jpexp, jmembers = jbird.loop_cp_groups()
    assert keys == jkeys and members == jmembers and len(keys) == 22
    np.testing.assert_array_equal(onehot, jonehot)
    np.testing.assert_array_equal(pexp, jpexp)
    for nl in (1, 2, 3):
        np.testing.assert_array_equal(tbird.cf_group_map(nl), jbird.cf_group_map(nl))
    for key in ("cp_onehot", "cp_pexp"):
        np.testing.assert_array_equal(tbt[key], jbt[key])


def test_lowrank_cut_and_cache_keys(tmp_path, monkeypatch):
    """The cut is part of the factors' identity: another tol gives the JAX
    factors of that tol, a cache file is reused only at its own cut and
    recipe version, and the dense tables hold no factors."""
    cfg = TConfig(nl=2, no=2, **NARROW)
    monkeypatch.setenv("EFTPIPE_TPU_LOWRANK_TOL", "1e-4")
    jnt = jnl.build_nonlinear_tables(JConfig(nl=2, no=2, **NARROW))
    coarse = tnl.lowrank_tables_numpy(cfg, 1e-4)
    for key, value in coarse.items():
        np.testing.assert_array_equal(value, jnt["lowrank"][key], err_msg=key)
    fine = tnl.lowrank_tables_numpy(cfg, 1e-5)
    assert tqf.lowrank_rank(coarse["scfg"]) < tqf.lowrank_rank(fine["scfg"])
    assert "lowrank" not in tnl.nonlinear_tables_numpy(cfg)

    tnl._LOWRANK_MEMO.clear()
    written = tnl.lowrank_tables_numpy(cfg, 1e-4, cache_dir=tmp_path)
    (cache,) = tmp_path.glob("lowrank_*.npz")
    with np.load(cache) as z:
        assert int(z["lr_version"]) == tnl.LOWRANK_VERSION
        stale = {k: 0.0 * z[k] for k in written}
    np.savez(cache, lr_version=np.array(tnl.LOWRANK_VERSION - 1), **stale)
    tnl._LOWRANK_MEMO.clear()
    rebuilt = tnl.lowrank_tables_numpy(cfg, 1e-4, cache_dir=tmp_path)
    tnl._LOWRANK_MEMO.clear()
    reread = tnl.lowrank_tables_numpy(cfg, 1e-4, cache_dir=tmp_path)
    for key in written:
        np.testing.assert_array_equal(rebuilt[key], written[key])
        np.testing.assert_array_equal(reread[key], written[key])
    tnl.lowrank_tables_numpy(cfg, 1e-5, cache_dir=tmp_path)
    assert len(list(tmp_path.glob("lowrank_*.npz"))) == 2


# ----------------------------------------------------------------------
# the op
# ----------------------------------------------------------------------
def test_quad_form_lowrank_matches_jax():
    """float64: the forward against ``qf_lowrank_xla`` per walker (rtol
    1e-12) and against the dense form at a tight cut, the gradient against
    ``jax.grad``; autograd's gradient passes ``gradcheck`` and a double
    backward (``laplace_cov``'s Hessian) runs."""
    rng = np.random.default_rng(11)
    m = _decaying_matrices(rng, bl=5, n=31)
    q, smat = tqf.lowrank_factors(m, tol=1e-10)
    w = rng.standard_normal((4, 31, 6))
    want = jax.vmap(lambda x: jpk.qf_lowrank_xla(x, jnp.asarray(q), jnp.asarray(smat)))(
        jnp.asarray(w))
    tq, ts = torch.as_tensor(q), torch.as_tensor(smat)
    got = tqf.quad_form_lowrank(torch.as_tensor(w), tq, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(want)).max())
    dense = tqf.qf_real_plain(torch.as_tensor(w), torch.as_tensor(m)).numpy()
    np.testing.assert_allclose(got.numpy(), dense, rtol=0, atol=1e-7 * np.abs(dense).max())
    # leading axes beyond the walker axis, and chunks over walkers
    nested = tqf.quad_form_lowrank(torch.as_tensor(w.reshape(2, 2, 31, 6)), tq, ts)
    np.testing.assert_array_equal(nested.reshape(got.shape).numpy(), got.numpy())

    g = rng.standard_normal(got.shape)
    jgrad = jax.grad(lambda x: jnp.sum(jnp.asarray(g) * jax.vmap(
        lambda xi: jpk.quad_form_lowrank(xi, jnp.asarray(q), jnp.asarray(smat)))(x)))(
        jnp.asarray(w))
    x = torch.as_tensor(w).requires_grad_(True)
    (tgrad,) = torch.autograd.grad((torch.as_tensor(g) * tqf.quad_form_lowrank(x, tq, ts)).sum(), x)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(jgrad)).max())
    small = torch.as_tensor(w[:2, :, :2]).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda y: tqf.quad_form_lowrank(y, tq, ts), (small,))
    assert torch.autograd.gradgradcheck(lambda y: tqf.quad_form_lowrank(y, tq, ts), (small,))


def test_quad_form_lowrank_chunks_over_walkers(monkeypatch):
    """The walker chunks that bound Y give the unchunked result."""
    rng = np.random.default_rng(12)
    q, smat = (torch.as_tensor(a) for a in tqf.lowrank_factors(_decaying_matrices(rng), 1e-8))
    w = torch.as_tensor(rng.standard_normal((5, 63, 4)))
    whole = tqf.quad_form_lowrank(w, q, smat)
    monkeypatch.setattr(tqf, "_PLAIN_V_BYTES", 2 * q.shape[0] * 4 * 8)
    np.testing.assert_allclose(tqf.quad_form_lowrank(w, q, smat).numpy(), whole.numpy(),
                               rtol=1e-15, atol=0)


# ----------------------------------------------------------------------
# the loop engine and the bird
# ----------------------------------------------------------------------
@pytest.mark.parametrize("premix", [True, False], ids=["premix", "per-structure"])
def test_lowrank_loop_float32_matches_jax(tables, premix, monkeypatch):
    """``nonlinear_pscf`` + ``assemble_bird`` on the route, float32 on both
    sides (JAX's float32 path is its low-rank route): every output within
    ``F32_REL`` of its largest entry; the keys are pinned (ROADMAP C1)."""
    jcfg, tcfg, jnt, jbt, tnt, tbt = tables
    monkeypatch.setenv("EFTPIPE_TPU_CF_PREMIX", "1" if premix else "0")
    plin, f = plin_batch(tcfg, seed=tcfg.nl)
    f32 = torch.float32
    p32, f_32 = jnp.asarray(plin, jnp.float32), jnp.asarray(f, jnp.float32)
    jout = jax.vmap(lambda p: jnl.nonlinear_pscf(jnt, jcfg, p))(p32)
    jb = jax.vmap(lambda o, p, ff: jbird.assemble_bird(jbt, jcfg, o, p, ff))(jout, p32, f_32)
    nt = tnl.nonlinear_tables_to(tnt, "cpu", f32)
    tp = torch.as_tensor(plin, dtype=f32)
    tout = tnl.nonlinear_pscf(nt, tcfg, tp, quadform="lowrank", cf_premix=premix)
    tb = tbird.assemble_bird(to_device(tbt, "cpu", f32), tcfg, tout, tp,
                             torch.as_tensor(f, dtype=f32))
    loop_keys = {"cloop_grp"} if premix else {"c22", "c13"}
    assert set(tout) == set(jout) == {"p22", "p13_kernel", "c11", "cct", "cct_nnlo"} | loop_keys
    for key in jout:
        assert tout[key].dtype == f32
        b = np.asarray(jout[key], np.float64)
        np.testing.assert_allclose(tout[key].double().numpy(), b, rtol=0,
                                   atol=F32_REL * np.abs(b).max(), err_msg=key)
    for field in jb._fields:
        b = np.asarray(getattr(jb, field), np.float64)
        np.testing.assert_allclose(getattr(tb, field).double().numpy(), b, rtol=0,
                                   atol=F32_REL * np.abs(b).max(), err_msg=field)


@pytest.mark.parametrize("premix", [True, False], ids=["premix", "per-structure"])
def test_lowrank_loop_float64_within_truncation_of_dense(tables, premix):
    """float64 route against the port's own float64 dense route: the
    truncation alone.  The CF loop and the linear terms hold the 2e-4
    envelope at the shipping cut; P22 does not (6e-4 to 1.1e-3 of its
    largest entry here, 5.7e-4 at the default widths: the reason two JAX
    tests fail, ROADMAP C0) and is held to 2e-3 there, and to 2e-4 at a
    1e-7 cut."""
    _, tcfg, _, _, tnt, tbt = tables
    plin, f = plin_batch(tcfg, seed=10 + tcfg.nl)
    bt = to_device(tbt, "cpu", torch.float64)
    tp, tf = torch.as_tensor(plin), torch.as_tensor(f)
    nt = tnl.nonlinear_tables_to(tnt, "cpu", torch.float64)
    dense = tbird.assemble_bird(bt, tcfg, tnl.nonlinear_pscf(nt, tcfg, tp), tp, tf)

    def route(tables64):
        out = tnl.nonlinear_pscf(tables64, tcfg, tp, quadform="lowrank", cf_premix=premix)
        return tbird.assemble_bird(bt, tcfg, out, tp, tf)

    def rel(a, b):
        return float(np.abs(a.numpy() - b.numpy()).max() / np.abs(b.numpy()).max())

    shipping = route(nt)
    for field in ("cloopl", "c11", "p11l", "pctl"):
        assert rel(getattr(shipping, field), getattr(dense, field)) <= TRUNC_REL, field
    assert 0.0 < rel(shipping.cloopl, dense.cloopl)
    assert TRUNC_REL < rel(shipping.ploopl, dense.ploopl) <= 2e-3
    tight = route(tnl.nonlinear_tables_to(
        dict(tnt, lowrank=tnl.lowrank_tables_numpy(tcfg, 1e-7)), "cpu", torch.float64))
    for field in ("ploopl", "cloopl"):
        assert rel(getattr(tight, field), getattr(dense, field)) <= TRUNC_REL, field
    with pytest.raises(ValueError, match="lowrank_tol"):
        tnl.nonlinear_pscf(tnl.nonlinear_tables_to(tnl.nonlinear_tables_numpy(tcfg), "cpu",
                                                   torch.float64), tcfg, tp, quadform="lowrank")


def test_pipeline_and_frozen_template_on_the_route(tables):
    """``TracerPipeline.build(quadform="lowrank")`` holds the factors and
    its frozen template keeps the premixed loop; an unknown route is
    refused at build."""
    from eftpipe_tpu_torch.models.pipeline import TracerPipeline, CosmoInputs

    _, tcfg, _, _, _, _ = tables
    pipe = TracerPipeline.build(tcfg, zeff=0.7, device="cpu", quadform="lowrank")
    assert set(pipe.nt["lowrank"]) == {"q22", "s22", "qcf", "scf", "qcfg", "scfg"}
    plin, f = plin_batch(tcfg, seed=3)
    x = CosmoInputs(plin=torch.as_tensor(plin), f=torch.as_tensor(f))
    live = pipe.compute_bird(x)
    frozen = TracerPipeline.build(tcfg, zeff=0.7, device="cpu", quadform="lowrank")
    frozen.freeze_template(plin[0])
    assert "cloop_grp" in frozen.frozen["nl_out"]
    one = CosmoInputs(plin=torch.as_tensor(plin[:1]), f=torch.as_tensor(f[:1]))
    want = live.cloopl[:1].numpy()
    np.testing.assert_allclose(frozen.compute_bird(one).cloopl.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    with pytest.raises(ValueError, match="quadform"):
        TracerPipeline.build(tcfg, device="cpu", quadform="einsum")


# ----------------------------------------------------------------------
# a narrow full-shape analysis on the route
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def narrow_analyses():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jorch, "EFTConfig", functools.partial(JConfig, **NARROW))
        mp.setattr(torch_orch, "EFTConfig", functools.partial(TConfig, **NARROW))
        yield


def test_lowrank_analysis_logp_matches_jax_float32(tmp_path, narrow_analyses, monkeypatch):
    """``Analysis.from_config(..., quadform="lowrank")`` in float32 on the
    narrow full-shape config of ``test_torch_orchestrate.py`` (EH98, AP,
    unbinned interpolated LRG, chained east-coast ELG, Jeffreys) against the
    JAX package's float32 ``Analysis.logp`` (its own low-rank, premixed
    route) per walker at the accuracy gate's scatter (1e-3 around θ₀):
    |Δlogp| ≤ 0.02, the float32 budget (measured ≤ 5e-3: two float32
    evaluations of the same function, rounded in other orders; each is ~1
    off float64 here, by the float32 AP quadrature); ``rebuilt`` keeps the
    route."""
    from test_torch_orchestrate import KOUT, full_shape_config, seeded, write_multipoles

    th = torch_orch.Analysis.from_config(full_shape_config(tmp_path, with_like=False),
                                         device="cpu")
    fid = {"omega_cdm": 0.12, "h": 0.6777, "LRG_b1": 2.2, "LRG_b2": 0.78, "LRG_b4": 0.78,
           "ELG_b1": 1.3}
    itp = th.nonlinear_Plk_interpolator("LRG", fid)
    write_multipoles(tmp_path / "data_LRG.txt", KOUT, itp([0, 2], KOUT).numpy(), [0, 2])
    ls, _, plk = th.nonlinear_Plk_grid("ELG", fid, chained=True, binned=True, kout=KOUT)
    write_multipoles(tmp_path / "data_ELG.txt", KOUT, plk.numpy(), ls)
    np.savetxt(tmp_path / "cov.txt", np.diag(np.full(4 * KOUT.size, 40.0) ** 2))
    info = full_shape_config(tmp_path)
    tan = torch_orch.Analysis.from_config(info, dtype=torch.float32, device="cpu",
                                          quadform="lowrank")
    assert all(p.quadform == "lowrank" and p.cf_premix for p in tan.pipelines.values())
    jan = jorch.Analysis.from_config(info, dtype=jnp.float32)
    thetas = seeded(tan.space.theta0(), 8, seed=9, rel=1e-3)
    want = np.asarray(jax.jit(jax.vmap(jan.logp))(jnp.asarray(thetas, jnp.float32)), np.float64)
    assert np.all(np.isfinite(want))
    got = tan.logp(thetas)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.double().numpy(), want, rtol=0, atol=0.02)
    again = tan.rebuilt()
    assert (again.quadform, again.lowrank_tol, again.cf_premix, again.dtype) == \
        ("lowrank", tnl.LOWRANK_TOL, True, torch.float32)


# ----------------------------------------------------------------------
# the CLI's dtype and route (ROADMAP C3)
# ----------------------------------------------------------------------
class _Built(Exception):
    pass


@pytest.mark.parametrize("argv, want", [
    ([], dict(dtype=torch.float32, quadform="kernel", lowrank_tol=1e-5, cf_premix=True)),
    (["--dtype", "float64"], dict(dtype=torch.float64, quadform="kernel")),
    (["--quadform", "lowrank", "--lowrank-tol", "1e-4", "--no-cf-premix"],
     dict(dtype=torch.float32, quadform="lowrank", lowrank_tol=1e-4, cf_premix=False)),
])
@pytest.mark.parametrize("command", ["run", "bestfit"])
def test_cli_builds_in_float32_unless_asked(tmp_path, monkeypatch, command, argv, want):
    """``run`` and ``bestfit`` build their analysis in float32 (the JAX
    CLI's dtype) unless given ``--dtype float64``, on the route asked for."""
    from eftpipe_tpu_torch.cli import main

    seen = {}

    def from_config(src, **kwargs):
        seen.update(kwargs, src=src)
        raise _Built

    monkeypatch.setattr(torch_orch.Analysis, "from_config", staticmethod(from_config))
    cfg = tmp_path / "run.json"
    cfg.write_text(json.dumps({"theory": {"tracers": {}}}))
    extra = ["--chains", str(tmp_path / "ch")] if command == "bestfit" else []
    with pytest.raises(_Built):
        main([command, str(cfg), "--device", "cpu", *extra, *argv])
    assert seen["src"] == str(cfg) and seen["device"] == "cpu"
    for key, value in want.items():
        assert seen[key] == value, key
