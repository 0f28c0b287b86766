"""Likelihood layer of the port (parambasis, marginal, reader, covariance,
likelihood, convert) against the JAX package: identical NumPy inputs from a
seed, float64, rtol 1e-10 unless a test says otherwise."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from eftpipe_tpu.models.config import EFTConfig as JConfig
from eftpipe_tpu.models import pipeline as jpipe
from eftpipe_tpu.models.bird import BirdState as JBird
from eftpipe_tpu.likelihood import parambasis as jpb, marginal as jmarg, likelihood as jlike
from eftpipe_tpu.likelihood import covariance as jcov, reader as jreader
from eftpipe_tpu_torch.models.config import EFTConfig as TConfig
from eftpipe_tpu_torch.models import pipeline as tpipe
from eftpipe_tpu_torch.models.bird import BirdState as TBird
from eftpipe_tpu_torch.likelihood import parambasis as tpb, marginal as tmarg, likelihood as tlike
from eftpipe_tpu_torch.likelihood import covariance as tcov, reader as treader
from eftpipe_tpu_torch.convert import likelihood_from_numpy

W = 4
NARROW = dict(nfft_loop=64, nkin=80)
MARG = {"A_": {"b3": {"loc": 0.0, "scale": 2.0}, "cct": {"loc": 0.5, "scale": 4.0},
               "cr1": {"loc": 0.0, "scale": 8.0}, "ce0": {"loc": 0.0, "scale": 4.0}},
        "B_": {"b3": {"loc": 0.0, "scale": 2.0}, "cct": {"loc": 0.0, "scale": 4.0},
               "cequad": {"loc": -0.2, "scale": 2.0}}}


@pytest.fixture(autouse=True)
def dense_jax(monkeypatch):
    monkeypatch.setenv("EFTPIPE_TPU_LOWRANK", "0")


def t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def close(got, want, rtol=1e-10, scale_atol=1e-12, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=scale_atol * np.abs(want).max(),
                               err_msg=name)


def random_bird(cfg, seed):
    rng = np.random.default_rng(seed)
    nl, nk, ns = cfg.nl, 13, 5
    shapes = dict(f=(W,), p11l=(W, nl, 3, nk), ploopl=(W, nl, 12, nk), pctl=(W, nl, 6, nk),
                  pct_nnlo_l=(W, nl, 3, nk), pstl=(W, nl, 3, nk), picc=(W, nl, nk),
                  c11=(W, nl, ns), cct=(W, nl, ns), cct_nnlo=(W, nl, ns), cloopl=(W, nl, 12, ns))
    return {k: rng.standard_normal(s) for k, s in shapes.items()}


def random_params(prefixes, seed):
    rng = np.random.default_rng(seed)
    names = ("b1", "b2", "b3", "b4", "cct", "cr1", "cr2", "ce0", "cemono", "cequad", "cr4", "cr6")
    return {p + n: rng.standard_normal(W) for p in prefixes for n in names}


@pytest.mark.parametrize("with_nnlo", [False, True])
@pytest.mark.parametrize("nl,no", [(2, 2), (3, 2)])
def test_westcoast_reduce_and_gaussian_table(nl, no, with_nnlo):
    jcfg = JConfig(nl=nl, no=no, with_nnlo=with_nnlo, nd_a=5e-5)
    tcfg = TConfig(nl=nl, no=no, with_nnlo=with_nnlo, nd_a=5e-5)
    bird = random_bird(tcfg, nl)
    params = random_params(["X_"], 7)
    jb, tb = jpb.WestCoastBasis(prefix="X_"), tpb.WestCoastBasis(prefix="X_")
    assert jb.gaussian_params() == tb.gaussian_params()
    assert jb.non_gaussian_params() == tb.non_gaussian_params()

    def jrun(b, p):
        state = JBird(**b)
        return jb.reduce_plk(jcfg, state, p), jb.gaussian_table(jcfg, state, p)

    jcomp, jtab = jax.vmap(jrun)({k: jnp.asarray(v) for k, v in bird.items()},
                                 {k: jnp.asarray(v) for k, v in params.items()})
    state = TBird(**{k: t(v) for k, v in bird.items()})
    tparams = {k: t(v) for k, v in params.items()}
    comp = tb.reduce_plk(tcfg, state, tparams)
    for field in comp._fields:
        close(getattr(comp, field).numpy(), getattr(jcomp, field), name=field)
    close(comp.sum().numpy(), jcomp.sum())
    tab = tb.gaussian_table(tcfg, state, tparams)
    assert set(tab) == set(jtab)
    for key in tab:
        close(tab[key].numpy(), jtab[key], name=key)
    sub = tb.gaussian_table(tcfg, state, tparams, requires={"X_b3", "X_ce0"})
    assert set(sub) == {"X_b3", "X_ce0"}


def test_unported_bases_raise():
    """Cross spectra and the east-coast basis are ported (parity in
    ``test_torch_orchestrate.py``); what the JAX package itself refuses —
    an east-coast cross spectrum — the port refuses too."""
    assert tpb.WestCoastBasis(prefix="a_", cross_prefix=["a_", "b_"]).is_cross()
    with pytest.raises(NotImplementedError, match="cross"):
        jpb.EastCoastBasis(prefix="a_", cross_prefix=["a_", "b_"])
    with pytest.raises(NotImplementedError, match="cross"):
        tpb.EastCoastBasis(prefix="a_", cross_prefix=["a_", "b_"])


@pytest.mark.parametrize("jeffreys", [False, True])
def test_marginalized_logp_matches_jax(jeffreys):
    rng = np.random.default_rng(3)
    nm, nd = 5, 17
    pg = rng.standard_normal((W, nm, nd))
    png = rng.standard_normal((W, nd))
    data = rng.standard_normal(nd)
    a = rng.standard_normal((nd, nd))
    invcov = a @ a.T + nd * np.eye(nd)
    mu = rng.standard_normal(nm)
    sigma_inv = np.diag(1.0 / rng.uniform(1, 3, nm) ** 2)
    want = jax.vmap(lambda g, n: jmarg.marginalized_logp(
        g, n, jnp.asarray(invcov), jnp.asarray(data), jnp.asarray(mu), jnp.asarray(sigma_inv),
        jeffreys=jeffreys))(jnp.asarray(pg), jnp.asarray(png))
    mu_b, sig_b = t(mu).expand(W, nm), t(sigma_inv).expand(W, nm, nm)
    got = tmarg.marginalized_logp(t(pg), t(png), t(invcov), t(data), mu_b, sig_b, jeffreys=jeffreys)
    for g, w_, name in zip(got, want, ("logp", "fullchi2", "bg_best")):
        close(g.numpy(), w_, name=name)
    bg = tmarg.bg_bestfit(t(pg), t(png), t(invcov), t(data), mu_b, sig_b)
    close(bg.numpy(), want[2])
    f2, f1, f0 = tmarg._f2_f1_f0(t(pg), t(png), t(invcov), t(data), mu_b, sig_b)
    assert f2.shape == (W, nm, nm) and f1.shape == (W, nm) and f0.shape == (W,)


def test_marginalized_logp_guards_degenerate_walkers():
    """A walker whose PG matrix is degenerate (and no prior) gets -inf, like
    the JAX function; its neighbours in the batch are untouched."""
    rng = np.random.default_rng(4)
    nm, nd = 3, 9
    pg = rng.standard_normal((W, nm, nd))
    pg[1, 2] = pg[1, 1]          # singular F2 for walker 1
    pg[2] = np.nan               # non-finite walker
    png = rng.standard_normal((W, nd))
    data, invcov = rng.standard_normal(nd), np.eye(nd)
    zeros = torch.zeros(W, nm, dtype=torch.float64)
    logp, _, _ = tmarg.marginalized_logp(t(pg), t(png), t(invcov), t(data), zeros,
                                         torch.zeros(W, nm, nm, dtype=torch.float64))
    assert torch.isinf(logp[1]) and logp[1] < 0 and torch.isinf(logp[2]) and logp[2] < 0
    assert torch.isfinite(logp[[0, 3]]).all()
    want = jax.vmap(lambda g, n: jmarg.marginalized_logp(
        g, n, jnp.asarray(invcov), jnp.asarray(data), jnp.zeros(nm), jnp.zeros((nm, nm)))[0])(
            jnp.asarray(pg), jnp.asarray(png))
    close(logp[[0, 3]].numpy(), np.asarray(want)[[0, 3]])
    assert np.isneginf(np.asarray(want)[2])


def test_marginal_setup_and_prior_forms():
    prior = tlike.regularize_prior(MARG)
    assert prior == jlike.regularize_prior(MARG)
    ordering = tpb.WestCoastBasis("A_").gaussian_params() + tpb.WestCoastBasis("B_").gaussian_params()
    ts = tmarg.MarginalSetup.from_config(prior, ordering)
    js = jmarg.MarginalSetup.from_config(prior, ordering)
    assert ts.names == js.names and ts.nmarg == js.nmarg == 7
    like = torch.zeros(W, dtype=torch.float64)
    mu, sig = ts.mu_sigma_inv({}, like)
    jmu, jsig = js.mu_sigma_inv({})
    close(mu.numpy(), np.broadcast_to(np.asarray(jmu), mu.shape))
    close(sig.numpy(), np.broadcast_to(np.asarray(jsig), sig.shape))
    # constant entries are made once per (value, device, dtype), then reused
    n_consts = len(ts._consts)
    again = ts.mu_sigma_inv({}, like)
    assert n_consts > 0 and len(ts._consts) == n_consts
    assert torch.equal(again[0], mu) and torch.equal(again[1], sig)
    # a callable entry carries the walker axis; one infinite scale zeroes Σ⁻¹
    call = tmarg.MarginalSetup.from_config(
        {"A_b3": {"loc": lambda p: 2.0 * p["A_b1"], "scale": 2.0}}, ordering)
    mu, sig = call.mu_sigma_inv({"A_b1": t(np.arange(W))}, like)
    assert mu.shape == (W, 1) and torch.equal(mu[:, 0], 2.0 * t(np.arange(W)))
    inf = tmarg.MarginalSetup.from_config({"A_b3": {"scale": np.inf}, "A_cct": {"scale": 1.0}}, ordering)
    assert not inf.mu_sigma_inv({}, like)[1].any()
    with pytest.raises(ValueError):
        tmarg.MarginalSetup.from_config({"nope": {}}, ordering)
    # an expression string is a callable of the parameters, like the JAX one
    expr = {"A_b3": {"loc": "lambda A_b1: 2.0 * A_b1", "scale": "lambda A_b1: 1.0 + A_b1**2"}}
    mu, sig = tmarg.MarginalSetup.from_config(expr, ordering).mu_sigma_inv(
        {"A_b1": t(np.arange(W))}, like)
    jmu, jsig = jax.vmap(lambda b: jmarg.MarginalSetup.from_config(expr, ordering).mu_sigma_inv(
        {"A_b1": b}))(jnp.asarray(np.arange(W, dtype=float)))
    close(mu.numpy(), jmu)
    close(sig.numpy(), jsig)


def test_host_helpers_match_jax(tmp_path):
    k = np.arange(0.01, 0.2, 0.01)
    assert tlike.parse_kmask(k, [0, 2], [0.02, 0.05], 0.15) == jlike.parse_kmask(k, [0, 2], [0.02, 0.05], 0.15)
    assert tlike.hartlap(1000, 40) == jlike.hartlap(1000, 40)
    assert tlike.extract_multipole_info(["k", "P0", "P2"]) == jlike.extract_multipole_info(["k", "P0", "P2"])
    rng = np.random.default_rng(0)
    cov = rng.standard_normal((2 * k.size, 2 * k.size))
    args = ([0, 2], [0, 2], k, 0.03, 0.12)
    np.testing.assert_array_equal(tlike.mask_covariance(cov, *args), jlike.mask_covariance(cov, *args))
    # reader: commented header, and no header
    table = np.column_stack([k, rng.standard_normal((k.size, 2))])
    np.savetxt(tmp_path / "h.txt", table, header="k P0 P2")
    np.savetxt(tmp_path / "n.txt", table)
    for name in ("h.txt", "n.txt"):
        ours, theirs = treader.read_pkl(tmp_path / name), jreader.read_pkl(tmp_path / name)
        assert ours.columns == list(theirs.columns)
        # np.loadtxt parses exactly; the JAX package reads through pandas,
        # whose fast float parser may be 1 ulp off
        np.testing.assert_allclose(ours.k, theirs.index.to_numpy(), rtol=4e-16)
        np.testing.assert_allclose(ours["P2"], theirs["P2"].to_numpy(), rtol=4e-16)
        np.testing.assert_array_equal(ours.values, table)
    np.savetxt(tmp_path / "c.txt", cov)
    np.testing.assert_array_equal(treader.load_covariance(tmp_path / "c.txt")[0],
                                  jreader.load_covariance(tmp_path / "c.txt")[0])
    # Gaussian covariance: a copy, bitwise
    kedges = np.linspace(0.005, 0.205, 21)
    p = [np.abs(rng.standard_normal(20)) * 1e4 for _ in range(3)]
    a = tcov.GaussianCovariance(kedges, volume=4.0)([0, 2, 4], [0, 2, 4], "aa->aaaa", tcov.Multipole(*p))
    b = jcov.GaussianCovariance(kedges, volume=4.0)([0, 2, 4], [0, 2, 4], "aa->aaaa", jcov.Multipole(*p))
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def two_tracer(tmp_path_factory):
    """Two narrow tracers (nl=3 and nl=2), data files written once and read
    by both packages."""
    work = tmp_path_factory.mktemp("like")
    rng = np.random.default_rng(11)
    kout = np.arange(0.01, 0.2049, 0.01)
    spec = {"A": dict(nl=3, ls=[0, 2, 4], kmin=0.02, kmax=0.18, nd=5e-5),
            "B": dict(nl=2, ls=[0, 2], kmin=0.03, kmax=0.2, nd=2e-4)}
    blocks = []
    for name, s in spec.items():
        cols = [kout] + [1e4 * np.exp(-5 * kout) * (1 + 0.1 * rng.standard_normal(kout.size)) / (1 + l)
                         for l in s["ls"]]
        np.savetxt(work / f"data_{name}.txt", np.column_stack(cols),
                   header="k " + " ".join(f"P{l}" for l in s["ls"]))
        a = rng.standard_normal((len(s["ls"]) * kout.size,) * 2)
        blocks.append(a @ a.T * 1e2 + 1e5 * np.eye(a.shape[0]))
    from scipy.linalg import block_diag

    np.savetxt(work / "cov.txt", block_diag(*blocks))
    ap = dict(om_ap=0.31, rdrag_ap=147.66, hubble_ap=0.6777)
    jspecs, tspecs = {}, {}
    for name, s in spec.items():
        kw = dict(nl=s["nl"], no=s["nl"], nd_a=s["nd"], **NARROW)
        data = dict(path=work / f"data_{name}.txt", ls=s["ls"], kmin=s["kmin"], kmax=s["kmax"])
        jp = jpipe.TracerPipeline.build(JConfig(**kw), zeff=0.7, apeffect=dict(ap, z_ap=0.7))
        tp = tpipe.TracerPipeline.build(TConfig(**kw), zeff=0.7, apeffect=dict(ap, z_ap=0.7),
                                        device="cpu", dtype=torch.float64)
        jspecs[name] = jlike.TracerSpec(pipeline=jp, basis=jpb.WestCoastBasis(prefix=f"{name}_"), data=dict(data))
        tspecs[name] = tlike.TracerSpec(pipeline=tp, basis=tpb.WestCoastBasis(prefix=f"{name}_"), data=dict(data))
    cfg = tspecs["A"].pipeline.cfg
    k = cfg.kin
    base = 2e4 * (k / 0.05) ** 0.96 / (1.0 + (k / 0.05) ** 2.8)
    inputs = {name: dict(plin=base[None] * (1 + 0.03 * rng.standard_normal((W, 1))),
                         f=0.8 + 0.03 * rng.standard_normal(W),
                         qperp=1 + 0.01 * rng.standard_normal(W),
                         qpar=1 + 0.01 * rng.standard_normal(W)) for name in spec}
    params = {f"{n}_{p}": v + 0.1 * rng.standard_normal(W)
              for n in spec for p, v in (("b1", 2.0), ("b2", 0.7), ("b4", 0.5))}
    return work, jspecs, tspecs, inputs, params


def _jax_eval(jl, inputs, params, fn):
    ji = {n: jpipe.CosmoInputs(**{k: jnp.asarray(v) for k, v in x.items()}) for n, x in inputs.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    # jitted: op-by-op eager dispatch of the same graph is several times slower
    return jax.jit(jax.vmap(lambda i, p: fn(jl, i, p)))(ji, jp)


def _torch_inputs(inputs, params):
    ti = {n: tpipe.CosmoInputs(**{k: t(v) for k, v in x.items()}) for n, x in inputs.items()}
    return ti, {k: t(v) for k, v in params.items()}


@pytest.mark.parametrize("marg", [None, MARG], ids=["chi2", "marginalized"])
def test_likelihood_matches_jax(two_tracer, marg):
    work, jspecs, tspecs, inputs, params = two_tracer
    jl = jlike.EFTLikelihood(tracers=jspecs, cov=work / "cov.txt", marg=marg)
    tl = tlike.EFTLikelihood(tracers=tspecs, cov=work / "cov.txt", marg=marg)
    np.testing.assert_allclose(tl.data_vector, jl.data_vector, rtol=4e-16)  # pandas: 1 ulp
    np.testing.assert_array_equal(tl.invcov, jl.invcov)
    assert tl.segments == jl.segments and tl.ndata == jl.ndata
    assert tl._bg_groups == jl._bg_groups and tl._bg_index == jl._bg_index
    assert tl.marginalizable_params() == jl.marginalizable_params()
    ti, tp = _torch_inputs(inputs, params)
    png, pg = tl.png_and_pg(ti, tp)
    jpng, jpg = _jax_eval(jl, inputs, params, lambda l, i, p: l.png_and_pg(i, p))
    close(png.numpy(), jpng, name="png")
    if marg is None:
        assert pg is None and jpg is None
    else:
        assert pg.shape == (W, tl.marginal.nmarg, tl.ndata)
        close(pg.numpy(), jpg, name="pg")
    out = tl.logp(ti, tp)
    jout = _jax_eval(jl, inputs, params, lambda l, i, p: l.logp(i, p))
    assert set(out) == set(jout)
    for key in out:
        assert out[key].shape[0] == W
        close(out[key].numpy(), jout[key], rtol=1e-9, scale_atol=1e-11, name=key)


def test_likelihood_from_numpy_carries_jax_state(two_tracer):
    """The JAX likelihood's constants as NumPy through
    ``convert.likelihood_from_numpy``: the same log-posterior."""
    work, jspecs, tspecs, inputs, params = two_tracer
    jl = jlike.EFTLikelihood(tracers=jspecs, cov=work / "cov.txt", marg=MARG)
    mu, sigma_inv = jl.marginal.mu_sigma_inv({})
    state = dict(
        tracers={name: dict(prefix=f"{name}_", ls=rt.ls, rows=rt.rows, cols=rt.cols,
                            binning_matrix=rt.binning_tables["matrix"], keff=rt.binning_tables["keff"])
                 for name, rt in jl.runtimes.items()},
        data_vector=jl.data_vector, invcov=jl.invcov, marg_names=jl.marginal.names,
        marg_mu=np.asarray(mu), marg_sigma=1.0 / np.sqrt(np.diag(np.asarray(sigma_inv))))
    tl = likelihood_from_numpy({n: s.pipeline for n, s in tspecs.items()}, state)
    ti, tp = _torch_inputs(inputs, params)
    jout = _jax_eval(jl, inputs, params, lambda l, i, p: l.logp(i, p))
    close(tl.logp(ti, tp)["logp"].numpy(), jout["logp"], rtol=1e-9, scale_atol=1e-11)
    with pytest.raises(ValueError):
        likelihood_from_numpy({n: s.pipeline for n, s in tspecs.items()},
                              dict(state, data_vector=jl.data_vector[:-1]))


def test_likelihood_rejects_unported_modes(two_tracer):
    """Chained and unbinned data modes are ported (parity in
    ``test_torch_orchestrate.py``); what stays refused is a data multipole
    the pipeline does not compute — also when chaining uses one up."""
    work, _, tspecs, _, _ = two_tracer
    import dataclasses

    for change in (dict(with_binning=False), dict(with_binning=False, with_interp=True)):
        unbinned = {"A": dataclasses.replace(tspecs["A"], **change), "B": tspecs["B"]}
        assert tlike.EFTLikelihood(tracers=unbinned, cov=work / "cov.txt").ndata > 0
    chained = {"A": dataclasses.replace(tspecs["A"], chained=True)}  # nl=3, l=4 in its data
    with pytest.raises(ValueError, match="chained=True"):
        tlike.EFTLikelihood(tracers=chained, cov=work / "cov.txt")
    too_many = {"B": dataclasses.replace(tspecs["B"], data=dict(tspecs["A"].data))}
    with pytest.raises(ValueError, match="multipole"):
        tlike.EFTLikelihood(tracers=too_many, cov=work / "cov.txt")
