"""The config-driven analysis of the port (``api/orchestrate.py`` and what it
runs: chained multipoles, the east-coast basis, cross spectra, unbinned and
interpolated data, frozen templates, expression priors, products, chains,
bestfit, CLI) against the JAX package: identical NumPy inputs, float64,
rtol 1e-10 per stage and 1e-8 for ``logp`` unless a test says otherwise.

Small widths (``nfft_loop=64``, ``nkin=80``) for everything built from a
config: ``EFTConfig`` is narrowed in both orchestration modules for the
length of this module.  The two golden tests build their pipelines at the
goldens' own (default) widths, in the port only.  JAX jits ``vmap`` of its
``logp`` at these small widths (seconds; op-by-op eager dispatch of the same
graph takes six times longer), never a production posterior."""

import copy
import dataclasses
import functools
import json
import subprocess
import sys
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import eftpipe_tpu.api.orchestrate as jorch
import eftpipe_tpu_torch.api.orchestrate as torch_orch
from eftpipe_tpu.models.config import EFTConfig as JConfig
from eftpipe_tpu.models.bird import BirdState as JBird
from eftpipe_tpu.models import transforms as jtr
from eftpipe_tpu.likelihood import parambasis as jpb
from eftpipe_tpu_torch.models.config import EFTConfig as TConfig
from eftpipe_tpu_torch.models.bird import BirdState as TBird
from eftpipe_tpu_torch.models import transforms as ttr
from eftpipe_tpu_torch.models.pipeline import TracerPipeline, CosmoInputs
from eftpipe_tpu_torch.likelihood import parambasis as tpb
from eftpipe_tpu_torch.likelihood.likelihood import EFTLikelihood, TracerSpec, regularize_prior
from eftpipe_tpu_torch.boltzmann.eh98 import eh98_pk
from eftpipe_tpu_torch.utils.safe_expr import safe_eval_expr, UnsafeExpressionError

from refbridge import golden_oracle
from test_safe_expr import ESCAPES, PRODUCTION_EXPRS
from test_orchestrate import make_config

ROOT = __import__("pathlib").Path(__file__).resolve().parent.parent
W = 8
NARROW = dict(nfft_loop=64, nkin=80)
# a data k grid that parses to the same doubles with np.loadtxt (the port)
# and pandas (the JAX package): ±1 ulp on a k that sits on kmin/kmax would
# move a k-mask boundary
KOUT = np.round(np.arange(0.01, 0.2049, 0.005), 6)
FID = {"f": 0.8, "alperp": 1.0, "alpara": 1.0, "LRG_b1": 2.2, "ELG_b1": 1.3, "X_ce0": 0.0}


@pytest.fixture(scope="module", autouse=True)
def narrow():
    """Narrow widths for every config-built tracer of both packages, and the
    JAX package's dense quadratic forms."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EFTPIPE_TPU_LOWRANK", "0")
        mp.setattr(jorch, "EFTConfig", functools.partial(JConfig, **NARROW))
        mp.setattr(torch_orch, "EFTConfig", functools.partial(TConfig, **NARROW))
        yield


def t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def close(got, want, rtol=1e-10, scale_atol=1e-12, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=scale_atol * np.abs(want).max(),
                               err_msg=name)


def seeded(theta0, n, seed, rel=1e-2):
    rng = np.random.default_rng(seed)
    return theta0[None, :] * (1.0 + rel * rng.standard_normal((n, theta0.size)))


def write_multipoles(path, k, plk, ls):
    np.savetxt(path, np.column_stack([k] + [np.asarray(plk)[i] for i in range(len(ls))]),
               header="k " + " ".join(f"P{l}" for l in ls))


def random_bird(nl, seed, nw=4):
    rng = np.random.default_rng(seed)
    nk, ns = 13, 5
    shapes = dict(f=(nw,), p11l=(nw, nl, 3, nk), ploopl=(nw, nl, 12, nk), pctl=(nw, nl, 6, nk),
                  pct_nnlo_l=(nw, nl, 3, nk), pstl=(nw, nl, 3, nk), picc=(nw, nl, nk),
                  c11=(nw, nl, ns), cct=(nw, nl, ns), cct_nnlo=(nw, nl, ns),
                  cloopl=(nw, nl, 12, ns))
    return {k: rng.standard_normal(s) for k, s in shapes.items()}


def both_birds(b):
    return JBird(**{k: jnp.asarray(v) for k, v in b.items()}), TBird(**{k: t(v) for k, v in b.items()})


# ----------------------------------------------------------------------
# stages
# ----------------------------------------------------------------------
@pytest.mark.parametrize("nl", [2, 3, 4])
def test_apply_chained_matches_jax(nl):
    assert ttr.chain_coeff(2) == jtr.chain_coeff(2)
    np.testing.assert_array_equal(ttr.chained_matrix(nl), jtr.chained_matrix(nl))
    jb, tb = both_birds(random_bird(nl, seed=nl))
    cfg_j, cfg_t = JConfig(nl=nl, no=nl), TConfig(nl=nl, no=nl)
    want, got = jtr.apply_chained(cfg_j, jb), ttr.apply_chained(cfg_t, tb)
    for field in ("p11l", "ploopl", "pctl", "pct_nnlo_l", "pstl", "picc"):
        close(getattr(got, field).numpy(), getattr(want, field), name=field)
    with pytest.raises(NotImplementedError):
        ttr.chained_matrix(5)


def _random_params(names, seed, nw=4):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(nw) for n in names}


def _basis_parity(jb, tb, cfg_j, cfg_t, params, nl, seed):
    bird = random_bird(nl, seed)
    assert jb.gaussian_params() == tb.gaussian_params()
    assert jb.non_gaussian_params() == tb.non_gaussian_params()

    def jrun(b, p):
        state = JBird(**b)
        return jb.reduce_plk(cfg_j, state, p), jb.gaussian_table(cfg_j, state, p)

    jcomp, jtab = jax.vmap(jrun)({k: jnp.asarray(v) for k, v in bird.items()},
                                 {k: jnp.asarray(v) for k, v in params.items()})
    state = TBird(**{k: t(v) for k, v in bird.items()})
    tparams = {k: t(v) for k, v in params.items()}
    comp = tb.reduce_plk(cfg_t, state, tparams)
    for field in comp._fields:
        close(getattr(comp, field).numpy(), getattr(jcomp, field), name=field)
    tab = tb.gaussian_table(cfg_t, state, tparams)
    assert set(tab) == set(jtab)
    for key in tab:
        close(tab[key].numpy(), jtab[key], name=key)


@pytest.mark.parametrize("with_nnlo", [False, True])
def test_eastcoast_reduce_plk_matches_jax(with_nnlo):
    """The east-coast branch of ``reduce_plk`` and ``EastCoastBasis``
    (rotation, ∂P/∂b_G rows) on a random bird, per walker."""
    kw = dict(nl=3, no=3, with_nnlo=with_nnlo, counterform="eastcoast", nd_a=2e-4)
    names = ("b1", "b2", "bG2", "bGamma3", "c0", "c2", "c4", "Pshot", "a0", "a2", "ctilde")
    params = _random_params([f"E_{n}" for n in names], seed=5)
    _basis_parity(jpb.EastCoastBasis(prefix="E_"), tpb.EastCoastBasis(prefix="E_"),
                  JConfig(**kw), TConfig(**kw), params, 3, seed=6)
    assert tpb.find_param_basis("eastcoast") is tpb.EastCoastBasis
    assert tpb.find_param_basis("eftpipe_tpu_torch.likelihood.parambasis.WestCoastBasis") \
        is tpb.WestCoastBasis
    with pytest.raises(NotImplementedError, match="cross"):
        tpb.EastCoastBasis(prefix="E_", cross_prefix=["A_", "B_"])


@pytest.mark.parametrize("with_nnlo", [False, True])
def test_cross_westcoast_matches_jax(with_nnlo):
    """A cross spectrum: both partners' bias parameters, the B-variant
    normalisations, its own stochastic terms."""
    kw = dict(nl=2, no=2, with_nnlo=with_nnlo, nd_a=5e-5, nd_b=1.85e-4, km_b=0.6, kr_b=0.3)
    names = ("b1", "b2", "b3", "b4", "cct", "cr1", "cr2")
    params = _random_params([p + n for p in ("A_", "B_") for n in names]
                            + [f"X_{n}" for n in ("ce0", "cemono", "cequad", "cr4", "cr6")],
                            seed=7)
    tb = tpb.WestCoastBasis(prefix="X_", cross_prefix=["A_", "B_"])
    assert tb.is_cross() and tb.bs_names(1)[0] == "B_b1"
    _basis_parity(jpb.WestCoastBasis(prefix="X_", cross_prefix=["A_", "B_"]), tb,
                  JConfig(**kw), TConfig(**kw), params, 2, seed=8)


# ----------------------------------------------------------------------
# the likelihood against the committed reference goldens (default widths)
# ----------------------------------------------------------------------
def _golden(name):
    def compute():
        pytest.skip("the reference tree is mounted: the JAX package's own test "
                    "recomputes this golden")
    return golden_oracle(name, compute)


def test_mixed_three_tracer_likelihood_against_golden(tmp_path):
    """West coast + NNLO + fiber, east coast, and a west-coast cross tracer
    (the JAX package's ``test_mixed_basis_three_tracer_parity``, its inputs
    and its tolerances against the reference), in the port."""
    from test_likelihood_mixed import PLIN, F, Q, KOUT as KM, PARAMS, FIBER, ND, write_data
    from eftpipe_tpu_torch.likelihood.likelihood import mask_covariance, hartlap

    ls = {"LRG": [0, 2, 4], "ELG": [0, 2], "X": [0, 2]}
    kmin = {"LRG": 0.02, "ELG": 0.03, "X": 0.03}
    kmax = {"LRG": 0.20, "ELG": 0.18, "X": 0.15}
    paths = {tr: write_data(tmp_path, tr, ls[tr], seed=i) for i, tr in enumerate(ls)}
    ndata_full = sum(len(ls[tr]) * KM.size for tr in ls)
    rng = np.random.default_rng(5)
    a = rng.normal(size=(ndata_full, ndata_full + 20)) * 40
    cov = a @ a.T + np.eye(ndata_full) * 1e3
    np.savetxt(tmp_path / "cov.txt", cov)
    marg = {
        "LRG_": {"b3": {"scale": 2.0}, "cct": {"scale": 4.0}, "cr4": {"scale": 4.0}},
        "ELG_": {"bGamma3": {"scale": 2.0}, "c0": {"scale": 4.0}, "Pshot": {"scale": 1.0}},
        "X_": {"ce0": {"scale": 2.0}},
    }
    cfgs = {"LRG": TConfig(nl=3, no=3, nd_a=ND["LRG"], with_nnlo=True),
            "ELG": TConfig(nl=2, no=2, nd_a=ND["ELG"], counterform="eastcoast"),
            "X": TConfig(nl=2, no=2, nd_a=ND["LRG"], nd_b=ND["ELG"])}
    bases = {"LRG": tpb.WestCoastBasis(prefix="LRG_"), "ELG": tpb.EastCoastBasis(prefix="ELG_"),
             "X": tpb.WestCoastBasis(prefix="X_", cross_prefix=["LRG_", "ELG_"])}
    specs = {}
    for tr in ls:
        pipe = TracerPipeline.build(cfgs[tr], with_irresum=True,
                                    apeffect=dict(om_ap=0.31, z_ap=0.7),
                                    fiber=FIBER if tr == "LRG" else None, device="cpu")
        specs[tr] = TracerSpec(pipeline=pipe, basis=bases[tr], with_binning=True,
                               data=dict(path=paths[tr], ls=ls[tr], kmin=kmin[tr], kmax=kmax[tr]))
    like = EFTLikelihood(tracers=specs, cov=dict(path=tmp_path / "cov.txt", rescale=1.2,
                                                 Nreal=2000), marg=marg)
    ci = CosmoInputs(plin=t(PLIN)[None], f=t([F]), qperp=t([Q[0]]), qpar=t([Q[1]]))
    inputs = {tr: ci for tr in ls}
    params = {k: t([v]) for k, v in PARAMS.items()}
    png, pg = like.png_and_pg(inputs, params)
    gold = _golden("likelihood_mixed_three_tracer")
    png_ref, pg_ref = gold["png"], gold["pg"]
    # the JAX package's tolerances against the reference
    np.testing.assert_allclose(png[0].numpy(), png_ref, rtol=5e-6, atol=1e-8 * np.abs(png_ref).max())
    np.testing.assert_allclose(pg[0].numpy(), pg_ref, rtol=5e-6, atol=1e-8 * np.abs(pg_ref).max())
    kmasks = []
    for tr in ls:
        kmasks += [ls[tr], ls[tr], KM, kmin[tr], kmax[tr]]
    invcov = np.linalg.inv(mask_covariance(cov / 1.2 / hartlap(2000, png_ref.size), *kmasks))
    np.testing.assert_allclose(like.invcov, invcov, rtol=1e-10)
    sig = {p: s["scale"] for pre, d in marg.items() for p, s in
           ((pre + k, v) for k, v in d.items())}
    sigma_inv = np.diag([1.0 / sig[p] ** 2 for p in like.marginal.names])
    res = png_ref - like.data_vector
    f2 = pg_ref @ invcov @ pg_ref.T + sigma_inv
    f1 = -pg_ref @ invcov @ res
    _, logdet = np.linalg.slogdet(f2 / (2 * np.pi))
    expected = -0.5 * (-f1 @ np.linalg.solve(f2, f1) + res @ invcov @ res + logdet)
    np.testing.assert_allclose(float(like.logp(inputs, params)["logp"][0]), expected, rtol=2e-6)


def test_chained_and_interpolated_likelihood_against_golden(tmp_path):
    """One tracer chained and binned, one unbinned and interpolated in k·P
    (the JAX package's ``test_two_tracer_chained_interp_chi2``, its inputs
    and tolerance against the reference), in the port."""
    from test_likelihood import PLIN, F, Q, KOUT as KL, PARAMS, write_data, make_cov

    params = dict(PARAMS)
    params.update({
        "LRG_b3": 0.2, "LRG_cct": -0.3, "LRG_cr1": -2.0, "LRG_cr2": 0.1,
        "LRG_ce0": 0.5, "LRG_cemono": 0.0, "LRG_cequad": 0.2,
        "ELG_b3": -0.1, "ELG_cct": 0.2, "ELG_cr1": 1.0, "ELG_cr2": 0.0,
        "ELG_ce0": 0.1, "ELG_cemono": 0.05, "ELG_cequad": -0.1,
    })
    path_lrg = write_data(tmp_path, "LRG", KL, [0, 2], seed=3)
    path_elg = write_data(tmp_path, "ELG", KL, [0, 2], seed=4)
    np.savetxt(tmp_path / "cov2.txt", make_cov(len(KL) * 4, seed=5))

    def pipe(nl):
        return TracerPipeline.build(TConfig(nl=nl, no=nl), with_irresum=True,
                                    apeffect=dict(om_ap=0.31, z_ap=0.7), device="cpu")

    like = EFTLikelihood(tracers={
        "LRG": TracerSpec(pipeline=pipe(3), basis=tpb.WestCoastBasis(prefix="LRG_"),
                          data=dict(path=path_lrg, ls=[0, 2], kmin=0.02, kmax=0.18),
                          chained=True, with_binning=True),
        "ELG": TracerSpec(pipeline=pipe(2), basis=tpb.WestCoastBasis(prefix="ELG_"),
                          data=dict(path=path_elg, ls=[0, 2], kmin=0.03, kmax=0.15),
                          with_binning=False, with_interp=True),
    }, cov=tmp_path / "cov2.txt")
    ci = CosmoInputs(plin=t(PLIN)[None], f=t([F]), qperp=t([Q[0]]), qpar=t([Q[1]]))
    result = like.logp({"LRG": ci, "ELG": ci}, {k: t([v]) for k, v in params.items()})
    png = _golden("likelihood_two_tracer_chained_interp")["png"]
    res = png - like.data_vector
    np.testing.assert_allclose(float(result["chi2"][0]), res @ like.invcov @ res, rtol=2e-6)
    # a chained tracer needs one internal multipole beyond its data
    bad = TracerSpec(pipeline=pipe(2), basis=tpb.WestCoastBasis(prefix="LRG_"),
                     data=dict(path=path_lrg, ls=[0, 2]), chained=True)
    with pytest.raises(ValueError, match="multipole"):
        EFTLikelihood(tracers={"LRG": bad}, cov=tmp_path / "cov2.txt")


# ----------------------------------------------------------------------
# parameters and expressions
# ----------------------------------------------------------------------
PARAMS_BLOCK = {
    "a": {"prior": {"min": 0.0, "max": 2.0}, "ref": 1.0},
    "b": {"prior": {"dist": "norm", "loc": 3.0, "scale": 0.5}},
    "c2": {"prior": {"min": -4.0, "max": 4.0}},
    "c4": 0.4,
    "fixed": {"value": 7.0},
    "b2": "lambda c2, c4: (c2 + c4) / np.sqrt(2.)",
    "b4": {"value": "lambda c2, c4: (c2 - c4) / np.sqrt(2.)"},
    "nested": "lambda b2, a: b2 * np.exp(a) + abs(a)",
}


def test_param_space_matches_jax():
    """Sampled / fixed / computed (production lambdas, computed on computed)
    parameters and the prior, on a (W, ndim) batch against the JAX space per
    point; the prior's constants are made once per device and dtype."""
    js, ts = jorch.ParamSpace.from_config(PARAMS_BLOCK), torch_orch.ParamSpace.from_config(PARAMS_BLOCK)
    assert ts.sampled == js.sampled == ["a", "b", "c2"]
    assert ts.fixed == js.fixed and ts.refs == js.refs and set(ts.computed) == set(js.computed)
    np.testing.assert_array_equal(ts.theta0(), js.theta0())
    for x, y in zip(ts.bounds(), js.bounds()):
        np.testing.assert_array_equal(x, y)
    thetas = seeded(ts.theta0() + 0.5, W, seed=1, rel=0.5)
    thetas[1, 0] = 2.5                     # outside the uniform prior
    got = ts.to_dict(t(thetas))
    want = jax.vmap(js.to_dict)(jnp.asarray(thetas))
    for name in ("b2", "b4", "nested", "a"):
        close(got[name].numpy(), want[name], name=name)
    assert got["c4"] == 0.4 and got["fixed"] == 7.0
    lp = ts.log_prior(t(thetas))
    jlp = np.asarray(jax.vmap(js.log_prior)(jnp.asarray(thetas)))
    assert np.isneginf(lp[1].item()) and np.isneginf(jlp[1])
    fin = np.isfinite(jlp)
    close(lp.numpy()[fin], jlp[fin], name="log_prior")
    assert len(ts._consts) == 1
    ts.log_prior(t(thetas))
    assert len(ts._consts) == 1
    # the scalar form (one point) works like the JAX one
    np.testing.assert_allclose(float(ts.to_dict(thetas[0])["nested"]),
                               float(js.to_dict(thetas[0])["nested"]), rtol=1e-12)
    with pytest.raises(ValueError, match="unresolvable"):
        torch_orch.ParamSpace.from_config({"x": "lambda y: y"}).to_dict(np.zeros(0))


@pytest.mark.parametrize("expr", ESCAPES)
def test_safe_expr_refusals(expr):
    """The JAX package's escape attempts (``tests/test_safe_expr.py``) are
    refused by the port's whitelist too."""
    with pytest.raises(UnsafeExpressionError):
        safe_eval_expr(expr)


@pytest.mark.parametrize("expr,args,expected", PRODUCTION_EXPRS)
def test_safe_expr_on_numbers_and_tensors(expr, args, expected):
    fn = safe_eval_expr(expr)
    np.testing.assert_allclose(float(fn(*args)), expected, rtol=1e-12)
    batch = fn(*(t(np.full(3, a)) for a in args))
    assert isinstance(batch, torch.Tensor) and batch.shape == (3,)
    np.testing.assert_allclose(batch.numpy(), expected, rtol=1e-12)
    with pytest.raises(UnsafeExpressionError):
        safe_eval_expr("lambda d: d.values()")
    with pytest.raises(AttributeError, match="not available"):
        safe_eval_expr("lambda x: np.load(x)")("f")
    # chains rooted at np (the JAX package's own case), on numbers and tensors
    norm = safe_eval_expr("lambda v: np.linalg.norm(np.asarray([v, v]))")
    np.testing.assert_allclose(float(norm(1.0)), np.sqrt(2.0), rtol=1e-12)
    np.testing.assert_allclose(norm(t([1.0, 2.0])).numpy(), np.sqrt(10.0), rtol=1e-12)


# ----------------------------------------------------------------------
# Analysis.from_config: the template-fit two-tracer + cross config
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def template(tmp_path_factory, narrow):
    """Both packages' ``Analysis`` of the JAX package's template-fit config
    (``tests/test_orchestrate.py:76-125``), on mock data from the port's
    products, and the JAX side's batched ``logp`` on W seeded points."""
    work = tmp_path_factory.mktemp("template")
    k = np.logspace(-5, 0, 300)
    cosmo = [t([v]) for v in (0.02237, 0.12, 0.6777, 3.044, 0.9649)]
    np.savetxt(work / "plin.txt", np.column_stack([k, eh98_pk(t(k), *cosmo, 0.7)[0][0].numpy()]))
    th = torch_orch.Analysis.from_config(make_config(work, work / "plin.txt", with_like=False),
                                         device="cpu")
    for name in ("LRG", "ELG", "X"):
        ls, _, plk = th.nonlinear_Plk_grid(name, FID, binned=True, kout=KOUT)
        write_multipoles(work / f"data_{name}.txt", KOUT, plk, ls)
    np.savetxt(work / "cov.txt", np.eye(6 * KOUT.size) * 25.0)
    info = make_config(work, work / "plin.txt")
    tan = torch_orch.Analysis.from_config(info, device="cpu")
    jan = jorch.Analysis.from_config(info)
    thetas = seeded(tan.space.theta0(), W, seed=2)
    jlogp = np.asarray(jax.jit(jax.vmap(jan.logp))(jnp.asarray(thetas)))
    return work, info, tan, jan, thetas, jlogp


def test_template_analysis_logp_matches_jax(template):
    """Batched ``logp`` at W=8 against the JAX ``logp`` per walker; the
    structure the JAX test checks; the frozen templates were made once."""
    _, _, tan, jan, thetas, jlogp = template
    assert set(tan.pipelines) == {"LRG", "ELG", "X"}
    assert tan.bases["X"].is_cross() and tan.bases["X"].cross_prefix == ["LRG_", "ELG_"]
    assert tan.configs["X"].nd_a == 5e-5 and tan.configs["X"].nd_b == 1.85e-4
    assert tan.space.sampled == jan.space.sampled == ["f", "LRG_b1", "ELG_b1"]
    assert all(p.frozen is not None for p in tan.pipelines.values())
    assert all(np.isfinite(jlogp))
    close(tan.logp(thetas).numpy(), jlogp, rtol=1e-8, name="logp")
    close(tan.logp(thetas, chunk=3).numpy(), jlogp, rtol=1e-8, name="logp chunked")
    assert tan.logp(np.array([[2.0, 2.2, 1.3]])).isneginf().all()   # out of the prior
    with pytest.raises(ValueError, match="shape"):
        tan.logp(thetas[:, :2])
    chain, lps, acc = tan.sampler(nwalkers=8).run(torch.Generator().manual_seed(0),
                                                  t(thetas), nsteps=2)
    assert chain.shape == (2, 8, 3) and torch.isfinite(lps).all() and 0 <= float(acc) <= 1


def test_template_analysis_derived_and_products_match_jax(template):
    _, _, tan, jan, thetas, _ = template
    assert tan.derived_names() == jan.derived_names()
    want = np.asarray(jax.jit(jax.vmap(jan.derived))(jnp.asarray(thetas)))
    close(tan.derived(thetas).numpy(), want, rtol=1e-8, name="derived")
    fid = {"f": 0.8, "LRG_b1": 2.2, "ELG_b1": 1.3}
    for chained in (False, True):
        ls, k, plk = tan.nonlinear_Plk_grid("LRG", fid, chained=chained)
        jls, jk, jplk = jan.nonlinear_Plk_grid("LRG", fid, chained=chained)
        assert ls == jls and plk.shape == jplk.shape
        close(plk.numpy(), jplk, name=f"plk chained={chained}")
    _, _, tab = tan.nonlinear_Plk_gaussian_grid("X", fid, binned=True, kout=KOUT)
    _, _, jtab = jan.nonlinear_Plk_gaussian_grid("X", fid, binned=True, kout=KOUT)
    assert set(tab) == set(jtab)
    for key in tab:
        close(tab[key].numpy(), jtab[key], name=key)
    itp, jitp = tan.nonlinear_Plk_interpolator("ELG", fid), jan.nonlinear_Plk_interpolator("ELG", fid)
    kq = np.linspace(0.02, 0.25, 17)
    close(itp([0, 2], kq).numpy(), jitp([0, 2], kq), name="interpolator")
    comp, jcomp = tan.bird_component("ELG", fid)[2], jan.bird_component("ELG", fid)[2]
    close(comp.ploop.numpy(), jcomp.ploop, name="ploop")
    assert set(tan.snapshots("LRG", fid)) == set(jan.snapshots("LRG", fid))
    assert tan.eft_params_values_dict("X", fid) == jan.eft_params_values_dict("X", fid)
    moved = tan.rebuilt(zeff=0.8)
    assert all(p.zeff == 0.8 and p.frozen is not None for p in moved.pipelines.values())


def test_template_analysis_laplace_cov_matches_jax(template):
    """The Laplace covariance: the port's Hessian (double backward through
    ``logp``) against ``jax.hessian``, to rtol 1e-8; cached at θ₀."""
    _, _, tan, jan, _, _ = template
    cov, jcov = tan.laplace_cov(), jan.laplace_cov()
    close(cov, jcov, rtol=1e-8, name="laplace_cov")
    assert np.all(np.linalg.eigvalsh(cov) > 0)
    assert tan.laplace_cov() is cov


def test_init_walkers_by_draws(template):
    """JAX's draws (``jax.random.normal`` of its key), remade and fed in:
    the same walkers.  The port's own draws come from a seeded
    ``torch.Generator``, scatter at posterior width and stay in the prior."""
    _, _, tan, jan, _, _ = template
    want = np.asarray(jan.init_walkers(16, key=3))
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (16, tan.space.ndim)))
    close(tan.init_walkers(16, z=z).numpy(), want, rtol=1e-8, name="walkers")
    x0 = tan.init_walkers(64, key=3)
    assert torch.equal(x0, tan.init_walkers(64, key=3)) and x0.shape == (64, 3)
    lo, hi = tan.space.bounds()
    assert np.all(x0.numpy() >= lo) and np.all(x0.numpy() <= hi)
    assert np.all(x0.numpy().std(axis=0) > 0.1 * np.sqrt(np.diag(tan.laplace_cov())))


def test_freeze_template_matches_unfrozen(template):
    """A frozen pipeline computes the same bird as the unfrozen one at its
    template; the JAX pipeline's frozen state carried across is the same."""
    from eftpipe_tpu_torch.convert import frozen_from_numpy

    _, _, tan, jan, _, _ = template
    pipe = tan.pipelines["LRG"]
    prov = tan.providers["LRG"]
    unfrozen = dataclasses.replace(pipe, frozen=None)
    params = {"f": t([0.7, 0.8, 0.9]), "alperp": t([1.0, 1.01, 0.99]),
              "alpara": t([1.0, 0.98, 1.02])}
    x = prov.inputs(params)
    a, b = pipe.compute_bird(x), unfrozen.compute_bird(x)
    for field in a._fields:
        close(getattr(a, field).numpy(), getattr(b, field).numpy(), rtol=1e-12, name=field)
    carried = frozen_from_numpy(dataclasses.replace(pipe, frozen=None), jan.pipelines["LRG"].frozen)
    for key, v in carried.frozen["nl_out"].items():
        close(v.numpy(), pipe.frozen["nl_out"][key].numpy(), name=key)
    close(carried.frozen["xpyp"].numpy(), pipe.frozen["xpyp"].numpy(), name="xpyp")


def jax_state(jan, info):
    """A JAX ``Analysis``'s state as plain data, for
    ``convert.analysis_from_numpy``."""
    def plain(tree):
        if dataclasses.is_dataclass(tree):
            return {f.name: plain(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
        if isinstance(tree, dict):
            return {k: plain(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(plain(v) for v in tree)
        return np.asarray(tree) if isinstance(tree, jnp.ndarray) else tree

    state = dict(configs={}, tables={}, zeff={}, frozen={}, bases={}, providers={},
                 params=info["params"])
    for name, jp in jan.pipelines.items():
        state["configs"][name] = {f.name: getattr(jp.cfg, f.name)
                                  for f in dataclasses.fields(jp.cfg) if f.init}
        tables = {k: plain(getattr(jp, k)) for k in ("nt", "bt", "rt", "at", "wt", "wmt", "ft")}
        if jp.nt["plan_cf"] is jp.nt["plan_pk"]:
            tables["nt"]["plan_cf"] = None
        state["tables"][name], state["zeff"][name] = tables, jp.zeff
        state["frozen"][name] = jp.frozen
        b = jan.bases[name]
        state["bases"][name] = dict(basis=b.name, prefix=b.prefix, cross_prefix=b.cross_prefix)
        prov = jan.providers[name]
        if hasattr(prov, "plin"):
            state["providers"][name] = dict(kind="fixed_template", plin=prov.plin)
        else:
            state["providers"][name] = dict(
                kind="eh98", zeff=prov.zeff, da_fid=prov.da_fid, h_fid=prov.h_fid,
                use_ap=prov.use_ap, rdrag_fid=prov.rdrag_fid, h0_fid=prov.h0_fid)
    jl = jan.like
    state["likes"] = {"like": dict(
        tracers={n: dict(ls=rt.ls, rows=rt.rows, cols=rt.cols, chained=rt.spec.chained,
                         binning_matrix=(None if rt.binning_tables is None
                                         else rt.binning_tables["matrix"]),
                         keff=None if rt.binning_tables is None else rt.binning_tables["keff"],
                         interp_png=rt.interp_png, interp_pg=rt.interp_pg)
                 for n, rt in jl.runtimes.items()},
        data_vector=jl.data_vector, invcov=jl.invcov, jeffreys=jl.jeffreys,
        marg=regularize_prior(info["likelihood"]["marg"]))}
    return state


def test_analysis_from_numpy_carries_jax_state(template):
    """The JAX ``Analysis``'s tables, frozen templates, providers, bases,
    likelihood and params as plain data through
    ``convert.analysis_from_numpy``: the same ``logp``."""
    from eftpipe_tpu_torch.convert import analysis_from_numpy

    _, info, tan, jan, thetas, jlogp = template
    carried = analysis_from_numpy(jax_state(jan, info), device="cpu")
    assert carried.like.marginal.names == jan.like.marginal.names
    assert all(p.frozen is not None for p in carried.pipelines.values())
    close(carried.logp(thetas).numpy(), jlogp, rtol=1e-8, name="logp")
    # the port's own builders made the same tables and frozen templates
    for name, pipe in tan.pipelines.items():
        other = carried.pipelines[name]
        assert pipe.cfg == other.cfg
        for key in ("m22_fold", "mcf_fold"):
            close(pipe.nt[key].numpy(), other.nt[key].numpy(), rtol=1e-13, name=key)
        for key, v in pipe.frozen["nl_out"].items():
            close(v.numpy(), other.frozen["nl_out"][key].numpy(), name=key)
    np.testing.assert_array_equal(tan.like.invcov, carried.like.invcov)


def test_mesh_and_unported_providers_raise(template, tmp_path):
    """``run_mcmc(mesh=)`` (A13, once listed here as raising) on a one-rank
    gloo group gives the mesh-less chain bit for bit, and refuses a mesh on
    another device; the solver provider (A8, once
    listed here) builds on the analysis' device, and on the card only a
    third derivative through it raises (a backward of the double backward of
    its gradient's Function with ``create_graph=True``, here on a stand-in
    for the solver whose Hessian the Function contracts; its gradient there,
    A8.1, and its second derivative, A8.2, are ported); the ``emulator``
    provider (A7, once listed here)
    builds from a ``TransferEmulator.save`` file and a config-built analysis
    on it gives the JAX analysis' ``logp`` (float64, 1e-8)."""
    from eftpipe_tpu_torch.boltzmann import einstein_boltzmann as te
    from eftpipe_tpu_torch.boltzmann.einstein_boltzmann import SolverProvider
    from eftpipe_tpu_torch.convert import eb_solver_from_numpy
    from test_torch_compat import write_transfer_emulator

    import torch.distributed as dist
    from eftpipe_tpu_torch.parallel.mesh import walker_mesh

    _, info, tan, _, _, _ = template
    run = dict(nwalkers=8, max_steps=2, block=2, rhat_tol=-1.0, with_derived=False, resume=False)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1)
    try:
        mesh = walker_mesh(devices=["cpu"])
        got = tan.run_mcmc(mesh=mesh, **run)
        assert mesh.collectives == 1 + 2 * 2
        with pytest.raises(ValueError, match="not the mesh's"):
            tan.run_mcmc(mesh=dataclasses.replace(mesh, device=torch.device("meta")), **run)
    finally:
        dist.destroy_process_group()
    want = tan.run_mcmc(**run)
    np.testing.assert_array_equal(got.chain, want.chain)
    np.testing.assert_array_equal(got.logps, want.logps)
    cfg = TConfig(**NARROW)
    grid = np.array([[-12.0, -6.0, 0.0]])
    solver = eb_solver_from_numpy(dict(
        k_mpc=[1e-3], z_out=[0.7], lna_out=[np.log(1 / 1.7)], dlna_f=0.02,
        growth_stencil=False, buckets=[(np.array([0]), grid, grid < -10, np.array([[2]]))]),
        device="cpu")
    prov = torch_orch.build_provider({"name": "solver", "solver": solver}, cfg, 0.7,
                                     device="cpu")
    assert isinstance(prov, SolverProvider)
    h = torch.ones(2, dtype=torch.float64, requires_grad=True)
    stand_in = types.SimpleNamespace(
        table_part=lambda par: (par.h ** 2,),
        table_hessians=lambda par, names: [2.0 * torch.ones(2, 1, 1, dtype=torch.float64)])
    par = types.SimpleNamespace(_replace=lambda **kw: types.SimpleNamespace(**kw))
    (out,) = te._SolverTables.apply(stand_in, par, [2.0 * h.detach()[:, None]], ("h",), h)
    (g,) = torch.autograd.grad(out.sum(), h, create_graph=True)
    (hh,) = torch.autograd.grad(g.sum(), h, retain_graph=True)
    assert torch.equal(hh, 2.0 * torch.ones(2, dtype=torch.float64))
    with pytest.raises(NotImplementedError, match="third derivative"):
        torch.autograd.grad(g.sum(), h, create_graph=True)
    with pytest.raises(ValueError, match="unknown boltzmann"):
        torch_orch.build_provider({"name": "nope"}, cfg, 0.7)

    emu = {"name": "emulator", "path": str(write_transfer_emulator(tmp_path / "emu.npz")),
           "om_fid": 0.31}
    info = copy.deepcopy(info)
    info["theory"]["tracers"] = {"LRG": dict(info["theory"]["tracers"]["LRG"], boltzmann=emu)}
    np.savetxt(tmp_path / "cov.txt", np.eye(2 * KOUT.size) * 25.0)
    info["likelihood"] = dict(info["likelihood"], tracers=["LRG"], cov=str(tmp_path / "cov.txt"),
                              data={"LRG": info["likelihood"]["data"]["LRG"]},
                              marg={"LRG_": info["likelihood"]["marg"]["LRG_"]})
    info["params"] = {
        "omega_b": 0.02237, "ns": 0.9649, "ln10As": 3.044,
        "omega_cdm": {"prior": {"min": 0.10, "max": 0.14}, "ref": 0.12},
        "h": {"prior": {"min": 0.62, "max": 0.72}, "ref": 0.6777},
        "LRG_b1": {"prior": {"min": 1.0, "max": 4.0}, "ref": 2.2},
        "LRG_b2": 0.8, "LRG_b4": 0.8}
    ours = torch_orch.Analysis.from_config(info, device="cpu")
    assert type(ours.providers["LRG"]).__name__ == "EmulatorProvider"
    theirs = jorch.Analysis.from_config(info)
    thetas = seeded(ours.space.theta0(), 4, seed=13, rel=1e-3)
    want = np.asarray(jax.jit(jax.vmap(theirs.logp))(jnp.asarray(thetas)))
    assert np.all(np.isfinite(want))
    close(ours.logp(thetas).numpy(), want, rtol=1e-8, name="emulator logp")


# ----------------------------------------------------------------------
# a full-shape config: east coast, chained, unbinned + interpolated data
# ----------------------------------------------------------------------
def full_shape_config(work, with_like=True):
    cosmo = {"omega_b": 0.02237, "ln10As": 3.044, "ns": 0.9649,
             "omega_cdm": {"prior": {"min": 0.10, "max": 0.14}, "ref": 0.12},
             "h": {"prior": {"dist": "norm", "loc": 0.6777, "scale": 0.02}}}
    info = {
        "theory": {"tracers": {
            "default": {"with_IRresum": True, "with_APeffect": {"Om_AP": 0.31},
                        "boltzmann": {"name": "eh98", "om_fid": 0.31}},
            "LRG": {"z": 0.7, "nd": 5e-5, "ls": [0, 2]},
            "ELG": {"z": 0.845, "nd": 1.85e-4, "ls": [0, 2, 4], "basis": "eastcoast"},
        }},
        "params": {**cosmo,
                   "LRG_b1": {"prior": {"min": 1.0, "max": 4.0}, "ref": 2.2},
                   "LRG_c2": {"prior": {"min": -4.0, "max": 4.0}, "ref": 1.1},
                   "LRG_c4": 0.0,
                   "LRG_b2": "lambda LRG_c2, LRG_c4: (LRG_c2 + LRG_c4) / np.sqrt(2.)",
                   "LRG_b4": "lambda LRG_c2, LRG_c4: (LRG_c2 - LRG_c4) / np.sqrt(2.)",
                   "ELG_b1": {"prior": {"min": 0.5, "max": 3.0}, "ref": 1.3},
                   "ELG_b2": 0.4, "ELG_bG2": 0.1},
    }
    if with_like:
        info["likelihood"] = {
            "tracers": ["LRG", "ELG"],
            "data": {"LRG": {"path": str(work / "data_LRG.txt"), "ls": [0, 2],
                             "kmin": 0.02, "kmax": 0.18},
                     "ELG": {"path": str(work / "data_ELG.txt"), "ls": [0, 2],
                             "kmin": 0.03, "kmax": 0.2}},
            "cov": str(work / "cov.txt"),
            "binned": {"LRG": False, "ELG": True},
            "chained": {"ELG": True},
            "jeffreys": True,
            "marg": {"LRG_": {"b3": {"loc": "lambda LRG_b1: 0.1 * LRG_b1", "scale": 2.0},
                              "cct": {"scale": 4.0}, "ce0": {"scale": 2.0}},
                     "ELG_": {"bGamma3": {"scale": 2.0}, "c0": {"scale": 4.0},
                              "Pshot": {"scale": 1.0}}},
        }
    return info


def test_full_shape_analysis_matches_jax(tmp_path):
    """Eisenstein–Hu cosmology, AP, an unbinned LRG interpolated in k·P, a
    chained east-coast ELG, computed b2/b4, an expression prior and Jeffreys
    marginalisation: batched ``logp`` against the JAX ``logp`` per walker."""
    th = torch_orch.Analysis.from_config(full_shape_config(tmp_path, with_like=False), device="cpu")
    fid = {"omega_cdm": 0.12, "h": 0.6777, "LRG_b1": 2.2, "LRG_b2": 0.78, "LRG_b4": 0.78,
           "ELG_b1": 1.3}
    itp = th.nonlinear_Plk_interpolator("LRG", fid)
    write_multipoles(tmp_path / "data_LRG.txt", KOUT, itp([0, 2], KOUT).numpy(), [0, 2])
    ls, _, plk = th.nonlinear_Plk_grid("ELG", fid, chained=True, binned=True, kout=KOUT)
    write_multipoles(tmp_path / "data_ELG.txt", KOUT, plk.numpy(), ls)
    np.savetxt(tmp_path / "cov.txt", np.diag(np.full(4 * KOUT.size, 40.0) ** 2))
    info = full_shape_config(tmp_path)
    tan = torch_orch.Analysis.from_config(info, device="cpu")
    assert tan.configs["ELG"].nl == 3 and tan.configs["ELG"].counterform == "eastcoast"
    assert tan.like.runtimes["LRG"].interp_png is not None
    jan = jorch.Analysis.from_config(info)
    thetas = seeded(tan.space.theta0(), W, seed=9)
    want = np.asarray(jax.jit(jax.vmap(jan.logp))(jnp.asarray(thetas)))
    assert np.all(np.isfinite(want))
    close(tan.logp(thetas).numpy(), want, rtol=1e-8, name="logp")
    # the JAX state carried across: interpolation matrices, a chained
    # east-coast tracer, an expression prior, the EH98 providers
    from eftpipe_tpu_torch.convert import analysis_from_numpy

    carried = analysis_from_numpy(jax_state(jan, info), device="cpu")
    assert carried.like.jeffreys and not carried.like.tracers["LRG"].with_binning
    close(carried.logp(thetas).numpy(), want, rtol=1e-8, name="carried logp")


# ----------------------------------------------------------------------
# autograd: the Hessian's double backward through the quadratic form
# ----------------------------------------------------------------------
def test_qf_real_gradgradcheck():
    """``_QuadFormReal`` (forward: the plain version on the CPU; backward:
    ``qf_real_backward_plain``) is twice differentiable: the Hessian of
    ``laplace_cov`` runs a double backward through it."""
    from eftpipe_tpu_torch.ops.quadform import quad_form_real

    rng = np.random.default_rng(3)
    w = t(rng.standard_normal((2, 7, 3))).requires_grad_(True)
    m = t(rng.standard_normal((4, 7, 7)))
    assert torch.autograd.gradgradcheck(lambda x: quad_form_real(x, m), (w,))


# ----------------------------------------------------------------------
# chains, bestfit and the CLI
# ----------------------------------------------------------------------
def test_chain_products_of_a_jax_written_chain(tmp_path):
    """A chain the JAX driver wrote: the port's ``ChainProducts`` reads the
    same columns, means, spreads, covariance and bestfit as the JAX one."""
    from eftpipe_tpu.parallel.mcmc import MCMCDriver as JDriver, MCMCResult as JResult
    from eftpipe_tpu.analysis import ChainProducts as JChains
    from eftpipe_tpu_torch.analysis import ChainProducts

    rng = np.random.default_rng(4)
    chain, logps = rng.standard_normal((30, 8, 3)), -rng.uniform(1, 5, (30, 8))
    derived = np.column_stack([rng.standard_normal(240), rng.uniform(0, 9, 240)])
    drv = JDriver(logp=lambda x: -0.5 * jnp.sum(x * x), ndim=3, nwalkers=8,
                  out=str(tmp_path / "jx"), param_names=["a", "b", "c"],
                  derived_names=["d", "fullchi2"])
    drv.write_chains(JResult(chain=chain, logps=logps, rminus1=np.zeros(3), accept_rate=0.5,
                             converged=False), derived)
    for burn in (0.0, 0.3):
        cp, jcp = ChainProducts.from_prefix(tmp_path / "jx", burn_in=burn), \
            JChains.from_prefix(tmp_path / "jx", burn_in=burn)
        assert cp.param_names == jcp.param_names and cp.derived_names == jcp.derived_names
        assert cp.meta == jcp.meta and len(cp.samples) == len(jcp.samples)
        for stat in ("mean", "std"):
            got, want = getattr(cp, stat)(), getattr(jcp, stat)()
            assert list(got) == list(want.index)
            close(list(got.values()), want.to_numpy(), rtol=1e-12, name=stat)
        close(cp.cov(), jcp.cov().to_numpy(), rtol=1e-12, name="cov")
        assert cp.bestfit() == pytest.approx(jcp.bestfit().to_dict(), rel=1e-15)
        assert cp.global_bestfit() == pytest.approx(jcp.global_bestfit().to_dict(), rel=1e-15)


def test_cli_run_and_bestfit(tmp_path, narrow):
    """``python -m eftpipe_tpu_torch run`` on a tiny JSON config (16 walkers,
    20 steps: the last line is JSON and the chain file exists), then
    ``bestfit -o`` writes finite columns (the JAX package's
    ``test_cli_run_and_bestfit``)."""
    from eftpipe_tpu_torch.cli import main
    from eftpipe_tpu_torch.analysis import ChainProducts, BestfitModel, Multipole

    k = np.logspace(-5, 0, 200)
    cosmo = [t([v]) for v in (0.02237, 0.12, 0.6777, 3.044, 0.9649)]
    np.savetxt(tmp_path / "plin.txt", np.column_stack([k, eh98_pk(t(k), *cosmo, 0.7)[0][0].numpy()]))
    info = {
        "theory": {"tracers": {"LRG": {
            "z": 0.7, "nd": 5e-5, "ls": [0, 2], "with_IRresum": True,
            "boltzmann": {"name": "fixed_template", "path": "plin.txt"}}}},
        "params": {"f": {"prior": {"min": 0.4, "max": 1.2}, "ref": 0.8},
                   "LRG_b1": {"prior": {"min": 1.0, "max": 4.0}, "ref": 2.2},
                   "LRG_b2": 0.8, "LRG_b4": 0.8},
    }
    (tmp_path / "theory.json").write_text(json.dumps(info))
    th = torch_orch.Analysis.from_config(tmp_path / "theory.json", device="cpu")
    kout = np.round(np.arange(0.015, 0.2049, 0.01), 6)
    ls, _, plk = th.nonlinear_Plk_grid("LRG", {"f": 0.8, "LRG_b1": 2.2}, binned=True, kout=kout)
    write_multipoles(tmp_path / "data.txt", kout, plk.numpy(), ls)
    np.savetxt(tmp_path / "cov.txt", np.eye(2 * kout.size) * (0.01 * np.abs(plk.numpy().ravel())) ** 2)
    info["likelihood"] = {"tracers": ["LRG"], "cov": "cov.txt", "binned": True,
                          "data": {"LRG": {"path": "data.txt", "ls": [0, 2],
                                           "kmin": 0.02, "kmax": 0.2}}}
    cfg = tmp_path / "run.json"
    cfg.write_text(json.dumps(info))
    res = subprocess.run(
        [sys.executable, "-m", "eftpipe_tpu_torch", "run", str(cfg), "--walkers", "16",
         "--max-steps", "20", "--block", "10", "--rhat", "-1", "--out", str(tmp_path / "ch/run"),
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["steps"] == 20 and out["walkers"] == 16
    assert (tmp_path / "ch/run.1.txt").exists()

    assert main(["bestfit", str(cfg), "--chains", str(tmp_path / "ch/run"), "--tracer", "LRG",
                 "-o", str(tmp_path / "bf.txt"), "--device", "cpu"]) == 0
    bf = np.loadtxt(tmp_path / "bf.txt")
    assert bf.shape[1] == 3 and np.all(np.isfinite(bf))
    model = BestfitModel.from_chains(torch_orch.Analysis.from_config(cfg, device="cpu"),
                                     ChainProducts.from_prefix(tmp_path / "ch/run"))
    assert np.isfinite(model.chi2()["chi2"])
    mp = model.write_data("LRG", tmp_path / "bfdata.txt", kout)
    assert isinstance(mp, Multipole) and mp.ells == [0, 2]
    again = Multipole.loadtxt(tmp_path / "bfdata.txt")
    np.testing.assert_allclose(again(2), mp(2), rtol=1e-15)
    cov = model.gaussian_covariance("LRG", kout, volume=4.0, shot=2e4)
    assert cov.shape == (2 * kout.size,) * 2 and np.all(np.linalg.eigvalsh(cov) > 0)
    assert main(["bench"]) == 2  # not ported: exits 2 naming its item
    for cmd in ("zeff", "plot-window"):  # ported (tests/test_torch_tools.py): need their file
        with pytest.raises(SystemExit) as exc:
            main([cmd])
        assert exc.value.code == 2


def test_readers_match_jax(tmp_path):
    """``average_reader`` and ``mock_cov_reader`` (NumPy) on the JAX
    package's own test inputs (``tests/test_cli.py``)."""
    from eftpipe_tpu.likelihood import reader as jreader
    from eftpipe_tpu_torch.likelihood import reader as treader

    rng = np.random.default_rng(2)
    k = np.linspace(0.01, 0.2, 10)
    base = np.stack([1e4 * np.exp(-k), 2e3 * np.exp(-k)])
    for i in range(12):
        np.savetxt(tmp_path / f"mock_{i:03d}.txt",
                   np.column_stack([k, *(base + rng.standard_normal(base.shape) * 50.0)]),
                   header="k P0 P2")
    pattern = str(tmp_path / "mock_*.txt")
    avg, javg = treader.average_reader(pattern), jreader.average_reader(pattern)
    assert avg.columns == list(javg.columns)
    np.testing.assert_allclose(avg.values, javg.to_numpy(), rtol=1e-14)
    for ls in (None, [2]):
        (cov, n), (jcov, jn) = treader.mock_cov_reader(pattern, ls=ls), \
            jreader.mock_cov_reader(pattern, ls=ls)
        assert n == jn == 12
        # pandas (the JAX package) may parse a file's number 1 ulp off
        close(cov, jcov, rtol=1e-12, scale_atol=1e-13, name="mock cov")
    with pytest.raises(ValueError, match="at least two"):
        treader.mock_cov_reader([pattern.replace("*", "000")])
    with pytest.raises(treader.NoHeaderError):
        np.savetxt(tmp_path / "bare.txt", np.ones((3, 2)))
        treader.read_commented_csv(tmp_path / "bare.txt")


def test_eft_model_template_matches_the_analysis(template):
    """``EFTModel`` in template mode gives the multipoles of the same
    tracer in the config-driven analysis; ``c2c4_to_b2b4`` is the JAX one."""
    from eftpipe_tpu.api.model import c2c4_to_b2b4 as jc2c4
    from eftpipe_tpu_torch.api.model import EFTModel, c2c4_to_b2b4

    work, _, tan, _, _, _ = template
    assert c2c4_to_b2b4(1.3, 0.2) == jc2c4(1.3, 0.2)
    with pytest.MonkeyPatch.context() as mp:
        import eftpipe_tpu_torch.api.model as tmodel

        mp.setattr(tmodel, "EFTConfig", functools.partial(TConfig, **NARROW))
        model = (EFTModel(z=0.7, nd=5e-5, device="cpu")
                 .set_template(work / "plin.txt", f=0.8).set_IRresum().done(ellmax=2))
    b2, b4 = c2c4_to_b2b4(1.1, 0.3)
    ls, _, plk = model.Plk_grid(b1=2.2, c2=1.1, c4=0.3)
    want = tan.nonlinear_Plk_grid("LRG", {"f": 0.8, "LRG_b1": 2.2, "LRG_b2": b2, "LRG_b4": b4})[2]
    close(plk.numpy(), want.numpy(), rtol=1e-12, name="Plk_grid")
    assert ls == [0, 2] and model.pipeline.frozen is not None
    kq = np.linspace(0.02, 0.2, 7)
    close(model(b1=2.2, b2=b2, b4=b4)(0, kq).numpy(),
          tan.nonlinear_Plk_interpolator("LRG", {"f": 0.8, "LRG_b1": 2.2, "LRG_b2": b2,
                                                 "LRG_b4": b4})(0, kq).numpy(), rtol=1e-12)
    with pytest.raises(ValueError, match="either"):
        model.Plk_grid(b2=1.0, c2=1.0)
    with pytest.raises(RuntimeError, match="done"):
        model.set_NNLO()
