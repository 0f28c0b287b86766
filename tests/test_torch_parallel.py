"""The port's sampling path (eftpipe_tpu_torch/parallel/) against the JAX
package's (eftpipe_tpu/parallel/): the diagnostics, the stretch move, the HMC
pieces and dual averaging on identical inputs and identical draws (the JAX
draws are remade from its keys and handed to the port), then the JAX
package's statistical tests of the samplers and the driver, ported, and the
driver's files and checkpoints across both packages.  Tiny Gaussian targets
only, float64 on the CPU."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from eftpipe_tpu.parallel import diagnostics as jdiag, hmc as jhmc, sampler as jsamp
from eftpipe_tpu.parallel.mcmc import MCMCDriver as JDriver
from eftpipe_tpu_torch.parallel import diagnostics as tdiag, hmc as thmc, sampler as tsamp
from eftpipe_tpu_torch.parallel.mcmc import MCMCDriver

F64 = torch.float64
MEAN = np.array([1.0, -2.0, 0.5])
SIGMA = np.array([0.3, 0.7, 1.5])
SIGMA_DRIVER = np.array([0.3, 0.7, 1.1])   # tests/test_mcmc.py
COV = np.array([[1.0, 0.85, 0.1], [0.85, 1.0, 0.2], [0.1, 0.2, 0.5]])
PREC = np.linalg.inv(COV)


def gaussian(mean, sigma):
    """The same diagonal Gaussian for both packages: scalar JAX, batched torch."""
    mj, sj = jnp.asarray(mean), jnp.asarray(sigma)
    mt, st = torch.as_tensor(mean), torch.as_tensor(sigma)
    return (lambda x: -0.5 * jnp.sum(((x - mj) / sj) ** 2),
            lambda x: -0.5 * (((x - mt) / st) ** 2).sum(-1))


def correlated():
    pj, pt = jnp.asarray(PREC), torch.as_tensor(PREC)
    return (lambda x: -0.5 * x @ pj @ x,
            lambda x: -0.5 * ((x @ pt) * x).sum(-1))


def t(x):
    return torch.tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# the pieces against the JAX ones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn, kwargs", [
    ("gelman_rubin", {}), ("gelman_rubin", dict(burn_frac=0.2)),
    ("integrated_autocorr_time", {}), ("integrated_autocorr_time", dict(c=3.0, burn_frac=0.1)),
    ("effective_sample_size", {}),
])
def test_diagnostics_match_jax(fn, kwargs):
    rng = np.random.default_rng(11)
    x = np.cumsum(rng.standard_normal((300, 6, 3)), axis=0) * 0.1 + rng.standard_normal((300, 6, 3))
    np.testing.assert_allclose(getattr(tdiag, fn)(x, **kwargs), getattr(jdiag, fn)(x, **kwargs),
                               rtol=1e-12)
    np.testing.assert_allclose(tdiag.autocorr_func_1d(x[:, 0, 0]),
                               jdiag.autocorr_func_1d(x[:, 0, 0]), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("seed", [0, 1])
def test_half_update_matches_jax_on_its_draws(seed):
    rng = np.random.default_rng(seed)
    n, d = 10, 3
    active = MEAN + SIGMA * rng.standard_normal((n, d))
    other = MEAN + SIGMA * rng.standard_normal((n, d))
    jlp, tlp = gaussian(MEAN, SIGMA)
    active_logp = np.asarray(jax.vmap(jlp)(jnp.asarray(active)))
    key = jax.random.PRNGKey(seed + 7)
    want = jsamp._half_update(key, jax.vmap(jlp), jnp.asarray(active), jnp.asarray(active_logp),
                              jnp.asarray(other), 2.0, d)
    # the draws of the JAX function, remade from its key
    k_z, k_pick, k_accept = jax.random.split(key, 3)
    u = jax.random.uniform(k_z, (n,), dtype=jnp.float64)
    j = jax.random.randint(k_pick, (n,), 0, n)
    u_acc = jax.random.uniform(k_accept, (n,), dtype=jnp.float64)
    got = tsamp._half_update(tlp, t(active), t(active_logp), t(other), 2.0, d,
                             t(u), t(j).long(), t(u_acc))
    accepts = np.asarray(want[2])
    assert 0 < accepts.sum() < n  # both branches of the update are exercised
    np.testing.assert_array_equal(got[2].numpy(), accepts)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)


@pytest.mark.parametrize("dense", [False, True])
def test_mass_ops_match_jax(dense):
    rng = np.random.default_rng(3)
    inv_mass = COV if dense else np.array([0.5, 2.0, 0.1])
    z = rng.standard_normal((5, 3))
    for jop, top in zip(jhmc._mass_ops(jnp.asarray(inv_mass)), thmc._mass_ops(t(inv_mass))):
        np.testing.assert_allclose(top(t(z)).numpy(), np.asarray(jop(jnp.asarray(z))),
                                   rtol=1e-10)


def _jax_draws(key, nchains, ndim, n_leapfrog, jitter=0.1):
    """The draws ``eftpipe_tpu.parallel.hmc.HMC._transition`` makes from
    ``key``, remade here (hmc.py:150-172)."""
    k_mom, k_acc, k_jit, k_len = jax.random.split(key, 4)
    z = jax.random.normal(k_mom, (nchains, ndim), jnp.float64)
    u = jax.random.uniform(k_jit, (nchains, 1), jnp.float64, 1.0 - jitter, 1.0 + jitter)
    n_lo = max(1, (n_leapfrog + 1) // 2)
    n_steps = int(jax.random.randint(k_len, (), n_lo, n_leapfrog + 1))
    u_acc = jax.random.uniform(k_acc, (nchains,), jnp.float64)
    return thmc.HMCDraws(z=t(z), u=t(u), n_steps=n_steps, u_acc=t(u_acc))


@pytest.mark.parametrize("dense", [False, True])
def test_leapfrog_and_transition_match_jax(dense):
    """A correlated Gaussian, the same momenta, jitter, L and uniforms."""
    jlp, tlp = correlated()
    jh = jhmc.HMC(logp=jlp, ndim=3, n_leapfrog=9)
    th = thmc.HMC(logp=tlp, ndim=3, n_leapfrog=9)
    rng = np.random.default_rng(4)
    q = rng.standard_normal((6, 3))
    inv_mass = COV if dense else np.array([0.9, 1.1, 0.4])
    jlogp, jgrad = jh._lpg(jnp.asarray(q))
    tlogp, tgrad = th._lpg(t(q))
    np.testing.assert_allclose(tlogp.numpy(), np.asarray(jlogp), rtol=1e-12)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-12)

    # leapfrog: same start, momenta and per-chain steps
    p = rng.standard_normal((6, 3))
    eps = 0.3 * (1.0 + 0.1 * rng.standard_normal((6, 1)))
    _, jvel, _ = jhmc._mass_ops(jnp.asarray(inv_mass))
    _, tvel, _ = thmc._mass_ops(t(inv_mass))
    want = jhmc._leapfrog(jh._lpg, jnp.asarray(q), jnp.asarray(p), jgrad, jnp.asarray(eps),
                          jvel, 5)
    got = thmc._leapfrog(th._lpg, t(q), t(p), tgrad, t(eps), tvel, 5)
    for g, w in zip(got[:3], want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(jax.vmap(jlp)(want[0])), rtol=1e-10)

    # three transitions on the JAX draws
    jstate = jhmc.HMCState(q=jnp.asarray(q), logp=jlogp, grad=jgrad)
    tstate = thmc.HMCState(q=t(q), logp=tlogp, grad=tgrad)
    eps = 0.45
    accepted = []
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        jstate, jacc = jh._transition(key, jstate, jnp.asarray(eps), jnp.asarray(inv_mass))
        tstate, tacc = thmc._transition(th._lpg, tstate, torch.tensor(eps, dtype=F64),
                                        thmc._mass_ops(t(inv_mass)),
                                        _jax_draws(key, 6, 3, 9))
        np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), rtol=1e-10)
        for g, w in zip(tstate, jstate):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-12)
        accepted.append(np.asarray(jacc))
    assert 0.0 < np.mean(accepted) < 1.0


def test_dual_averaging_sequence_matches_jax():
    jh = jhmc.HMC(logp=None, ndim=3, target_accept=0.7)
    th = thmc.HMC(logp=None, ndim=3, target_accept=0.7)
    rng = np.random.default_rng(5)
    jda = jh._da_init(jnp.asarray(0.05))
    tda = th._da_init(torch.tensor(0.05, dtype=F64))
    jmu, tmu = jnp.log(10.0 * 0.05), torch.log(torch.tensor(10.0 * 0.05, dtype=F64))
    for _ in range(25):
        acc = rng.uniform(0.0, 1.0, 8)
        jda = jh._da_update(jda, jnp.asarray(acc), jmu)
        tda = th._da_update(tda, t(acc), tmu)
        for g, w in zip(tda, jda):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)


def test_mesh_is_not_ported(tmp_path):
    """(Named when ``mesh=`` raised.)  On a one-rank gloo group the samplers
    and the driver take ``mesh=``; the stretch chain equals the mesh-less
    one bit for bit and evaluates through one all_gather a half-step; an
    ensemble that does not split over twice the mesh raises.  The
    two-process runs are ``tests/test_torch_mesh.py``'s."""
    import torch.distributed as dist
    from eftpipe_tpu_torch.parallel.mesh import walker_mesh

    _, tlp = gaussian(MEAN, SIGMA)
    x0 = torch.as_tensor(MEAN) + 0.1 * torch.randn((8, 3), generator=torch.Generator().manual_seed(0),
                                                   dtype=F64)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1)
    try:
        mesh = walker_mesh(devices=["cpu"])
        got = tsamp.EnsembleSampler(logp=tlp, nwalkers=8, ndim=3, mesh=mesh).run(
            torch.Generator().manual_seed(1), x0, nsteps=4)
        assert mesh.collectives == 1 + 2 * 4
        thmc.HMC(logp=tlp, ndim=3, mesh=mesh)
        for kind in ("stretch", "hmc"):
            assert MCMCDriver(logp=tlp, ndim=3, mesh=mesh, sampler_kind=kind).device == mesh.device
        with pytest.raises(ValueError, match="not the mesh's"):
            MCMCDriver(logp=tlp, ndim=3, mesh=mesh, device="meta")
        with pytest.raises(ValueError, match="nwalkers must be even"):
            tsamp.EnsembleSampler(logp=tlp, nwalkers=7, ndim=3, mesh=mesh)
    finally:
        dist.destroy_process_group()
    want = tsamp.EnsembleSampler(logp=tlp, nwalkers=8, ndim=3).run(
        torch.Generator().manual_seed(1), x0, nsteps=4)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_driver_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, tlp = gaussian(MEAN, SIGMA)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MCMCDriver(logp=tlp, ndim=3)


# ---------------------------------------------------------------------------
# the JAX package's statistical tests (tests/test_hmc.py, tests/test_mcmc.py)
# ---------------------------------------------------------------------------

def test_hmc_recovers_gaussian_moments():
    _, tlp = gaussian(MEAN, SIGMA)
    hmc = thmc.HMC(logp=tlp, ndim=3, n_leapfrog=12)
    q0 = torch.zeros((16, 3), dtype=F64) + 0.1
    chain, logps, info = hmc.sample(0, q0, n_warmup=400, n_samples=800)
    assert chain.shape == (800, 16, 3)
    assert 0.6 < info["accept"] <= 1.0
    flat = chain[200:].reshape(-1, 3)
    np.testing.assert_allclose(flat.mean(0), MEAN, atol=0.15 * float(np.max(SIGMA)))
    np.testing.assert_allclose(flat.std(0), SIGMA, rtol=0.2)
    ratio = info["inv_mass"] / SIGMA ** 2
    assert np.all(ratio > 0.3) and np.all(ratio < 3.0)
    assert np.max(tdiag.gelman_rubin(chain) - 1.0) < 0.05


def test_hmc_correlated_gaussian():
    cov = np.array([[1.0, 0.85], [0.85, 1.0]])
    prec = torch.as_tensor(np.linalg.inv(cov))
    hmc = thmc.HMC(logp=lambda x: -0.5 * ((x @ prec) * x).sum(-1), ndim=2, n_leapfrog=24)
    chain, _, info = hmc.sample(1, torch.zeros((8, 2), dtype=F64), n_warmup=400,
                                n_samples=1200)
    flat = chain[300:].reshape(-1, 2)
    np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.15)


def test_hmc_handles_nan_rejection():
    """Leapfrog divergence (NaN energy) must reject, not propagate."""

    def lp(x):
        return torch.where((x.abs() < 5.0).all(-1), -0.5 * (x ** 2).sum(-1),
                           torch.full_like(x[:, 0], float("nan")))

    hmc = thmc.HMC(logp=lp, ndim=2, n_leapfrog=8)
    chain, logps, info = hmc.sample(2, torch.zeros((4, 2), dtype=F64), n_warmup=100,
                                    n_samples=200)
    assert np.all(np.isfinite(chain))
    assert np.all(np.isfinite(logps))


def test_gelman_rubin_iid_converges():
    chain = np.random.default_rng(0).standard_normal((400, 16, 3))
    r = tdiag.gelman_rubin(chain)
    assert r.shape == (3,)
    assert np.all(r - 1.0 < 0.05)


def test_gelman_rubin_detects_disagreement():
    chain = np.random.default_rng(1).standard_normal((400, 16, 2))
    chain[:, :8, 0] += 10.0  # half the walkers sit elsewhere
    r = tdiag.gelman_rubin(chain)
    assert r[0] - 1.0 > 0.5
    assert r[1] - 1.0 < 0.05


def test_autocorr_time_and_ess():
    rng = np.random.default_rng(2)
    rho, n, nw = 0.8, 4000, 8
    x = np.zeros((n, nw, 1))
    eps = rng.standard_normal((n, nw, 1))
    for i in range(1, n):
        x[i] = rho * x[i - 1] + eps[i]
    tau = tdiag.integrated_autocorr_time(x)
    expected = (1 + rho) / (1 - rho)  # = 9
    assert 0.5 * expected < tau[0] < 1.6 * expected
    assert tdiag.effective_sample_size(x)[0] == pytest.approx(n * nw / tau[0])


def test_driver_converges_and_recovers_moments(tmp_path):
    _, tlp = gaussian(MEAN, SIGMA_DRIVER)
    driver = MCMCDriver(logp=tlp, ndim=3, nwalkers=64, rhat_tol=0.03, block=200,
                        out=tmp_path / "chain", param_names=["a", "b", "c"], device="cpu")
    res = driver.run(seed=0, x0=np.zeros(3), max_steps=4000)
    assert res.converged
    flat = res.flat(burn_frac=0.5)
    np.testing.assert_allclose(flat.mean(axis=0), MEAN, atol=0.12)
    np.testing.assert_allclose(flat.std(axis=0), SIGMA_DRIVER, rtol=0.25)
    assert 0.1 < res.accept_rate < 0.9
    assert (tmp_path / "chain.1.txt").exists()
    assert (tmp_path / "chain.paramnames").exists()
    cols = np.loadtxt(tmp_path / "chain.1.txt")
    assert cols.shape[1] == 2 + 3  # weight, -logpost, params
    np.testing.assert_allclose(cols[:, 0], 1.0)


def test_driver_derived_columns(tmp_path):
    _, tlp = gaussian(MEAN, SIGMA_DRIVER)
    driver = MCMCDriver(logp=tlp, ndim=3, nwalkers=32, rhat_tol=-1.0, block=40,
                        out=tmp_path / "d", param_names=["a", "b", "c"], derived_names=["asq"],
                        derived_fn=lambda th: th[:, :1] ** 2, device="cpu")
    driver.run(seed=1, x0=np.zeros(3), max_steps=40)
    cols = np.loadtxt(tmp_path / "d.1.txt")
    assert cols.shape[1] == 2 + 3 + 1
    np.testing.assert_allclose(cols[:, -1], cols[:, 2] ** 2, rtol=1e-6)
    names = [line.split()[0] for line in open(tmp_path / "d.paramnames")]
    assert names == ["a", "b", "c", "asq*"]


def test_driver_hmc_converges_and_checkpoints(tmp_path):
    _, tlp = gaussian(MEAN, SIGMA_DRIVER)
    kw = dict(logp=tlp, ndim=3, nwalkers=16, rhat_tol=0.01, block=100, out=tmp_path / "h",
              sampler_kind="hmc", n_leapfrog=8, warmup_steps=100,
              inv_mass0=SIGMA_DRIVER ** 2, device="cpu")
    driver = MCMCDriver(**kw)
    res = driver.run(seed=3, x0=np.zeros(3), max_steps=600)
    assert res.converged
    flat = res.flat(burn_frac=0.5)
    np.testing.assert_allclose(flat.mean(axis=0), MEAN, atol=0.1)
    np.testing.assert_allclose(flat.std(axis=0), SIGMA_DRIVER, rtol=0.25)
    assert np.max(res.rminus1) < 0.01
    eps = driver.sampler.eps
    assert eps is not None and float(eps) > 0
    d2 = MCMCDriver(**kw)
    d2.run(seed=3, x0=np.zeros(3), max_steps=600, resume=True)
    np.testing.assert_allclose(np.asarray(d2.sampler.eps), np.asarray(eps))


# ---------------------------------------------------------------------------
# checkpoints and chain files across runs and packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["stretch", "hmc"])
def test_resumed_run_is_bitwise_an_uninterrupted_one(tmp_path, kind):
    _, tlp = gaussian(MEAN, SIGMA_DRIVER)
    kw = dict(logp=tlp, ndim=3, nwalkers=16, rhat_tol=-1.0, block=20, sampler_kind=kind,
              n_leapfrog=6, warmup_steps=20, device="cpu")
    whole = MCMCDriver(**kw, out=tmp_path / "whole").run(seed=9, x0=np.zeros(3), max_steps=60)
    first = MCMCDriver(**kw, out=tmp_path / "cut").run(seed=9, x0=np.zeros(3), max_steps=20)
    assert first.chain.shape[0] == 20
    resumed = MCMCDriver(**kw, out=tmp_path / "cut").run(seed=123, max_steps=60)
    assert resumed.chain.shape == whole.chain.shape == (60, 16, 3)
    np.testing.assert_array_equal(resumed.chain, whole.chain)
    np.testing.assert_array_equal(resumed.logps, whole.logps)
    np.testing.assert_array_equal(resumed.chain[:20], first.chain)
    # a fresh run ignores the checkpoint
    fresh = MCMCDriver(**kw, out=tmp_path / "cut").run(seed=9, x0=np.zeros(3), max_steps=20,
                                                       resume=False)
    np.testing.assert_array_equal(fresh.chain, first.chain)


def test_chain_files_read_by_the_jax_package(tmp_path):
    from eftpipe_tpu.analysis.chains import ChainProducts

    _, tlp = gaussian(MEAN, SIGMA_DRIVER)
    driver = MCMCDriver(logp=tlp, ndim=3, nwalkers=8, rhat_tol=-1.0, block=10,
                        out=tmp_path / "run", param_names=["a", "b", "c"],
                        derived_names=["asum"], derived_fn=lambda th: th.sum(-1, keepdim=True),
                        device="cpu")
    res = driver.run(seed=4, x0=np.zeros(3), max_steps=10)
    cp = ChainProducts.from_prefix(tmp_path / "run")
    assert cp.param_names == ["a", "b", "c"] and cp.derived_names == ["asum"]
    assert list(cp.samples.columns) == ["weight", "minuslogpost", "a", "b", "c", "asum"]
    flat = res.chain.reshape(-1, 3)
    np.testing.assert_allclose(cp.samples[["a", "b", "c"]].to_numpy(), flat, rtol=1e-15)
    np.testing.assert_allclose(cp.samples["minuslogpost"].to_numpy(), -res.logps.reshape(-1),
                               rtol=1e-15)
    np.testing.assert_allclose(cp.samples["asum"].to_numpy(), flat.sum(-1), rtol=1e-12)
    assert cp.meta["nwalkers"] == 8


def test_resumes_a_jax_written_checkpoint(tmp_path, caplog):
    """The JAX driver writes 40 steps; the port's driver takes over its
    walkers and chain and extends it to 80."""
    jlp, tlp = gaussian(MEAN, SIGMA_DRIVER)
    kw = dict(ndim=3, nwalkers=16, rhat_tol=-1.0, block=40, out=tmp_path / "j",
              param_names=["a", "b", "c"])
    jres = JDriver(logp=jlp, **kw).run(key=2, x0=np.zeros(3), max_steps=40)
    with caplog.at_level("INFO", logger="eftpipe_tpu_torch.mcmc"):
        res = MCMCDriver(logp=tlp, device="cpu", **kw).run(seed=0, max_steps=80)
    assert "from its key" in caplog.text
    assert res.chain.shape == (80, 16, 3)
    np.testing.assert_array_equal(res.chain[:40], jres.chain)
    np.testing.assert_array_equal(res.logps[:40], jres.logps)
    # the new steps start from the JAX walkers and stay on the posterior
    assert np.all(np.isfinite(res.logps))
    assert np.abs(res.chain[40] - jres.chain[-1]).max() < 5.0
    z = np.load(tmp_path / "j.checkpoint.npz")
    assert "generator_state" in z.files and int(z["nsteps_done"]) == 80


def test_driver_state_from_numpy_carries_the_hmc_metric():
    """A JAX HMC checkpoint's arrays (hmc.py adapter format)."""
    from eftpipe_tpu_torch.convert import driver_state_from_numpy

    rng = np.random.default_rng(6)
    arrays = dict(key=np.asarray(jax.random.PRNGKey(5)), walkers=rng.standard_normal((4, 3)),
                  chain=rng.standard_normal((7, 4, 3)), logps=rng.standard_normal((7, 4)),
                  nsteps_done=np.asarray(7), hmc_eps=np.asarray(0.12),
                  hmc_inv_mass=np.array([1.0, 2.0, 3.0]))
    state = driver_state_from_numpy(arrays)
    assert state["nsteps_done"] == 7 and len(state["chain"]) == 1
    np.testing.assert_array_equal(state["chain"][0], arrays["chain"])
    np.testing.assert_array_equal(state["hmc_inv_mass"], arrays["hmc_inv_mass"])
    assert state["seed"] == int.from_bytes(arrays["key"].tobytes(), "little")
    assert "generator_state" not in state
    with pytest.raises(ValueError, match="neither"):
        driver_state_from_numpy({k: v for k, v in arrays.items() if k != "key"})
