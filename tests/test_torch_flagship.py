"""The port as a whole: the flagship ``logp`` against the JAX package's on
seeded points at the full default widths (float64), its float32 path against
its float64 path, and the Eisenstein–Hu provider.  Two configurations: the
default (survey window, solver-emulator cosmology — the JAX package's
default) and the lite one (no window, Eisenstein–Hu)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from eftpipe_tpu.api import flagship as jflag
from eftpipe_tpu.boltzmann import eh98 as jeh
from eftpipe_tpu.models.config import EFTConfig as JConfig
from eftpipe_tpu_torch.api import flagship as tflag
from eftpipe_tpu_torch.boltzmann import eh98 as teh, background as tbg
from eftpipe_tpu_torch.models.ap import lcdm_da, lcdm_hubble
from eftpipe_tpu_torch.models.config import EFTConfig as TConfig
from eftpipe_tpu_torch.ops import quadform as tq

from test_eh98 import GROWTH_POINTS

GOLDENS = __import__("pathlib").Path(__file__).parent / "goldens"


def seeded_points(theta0, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return theta0[None, :] * (1.0 + 1e-3 * rng.standard_normal((n, theta0.size)))


LITE = dict(with_window=False, cosmology="eh98")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Each package builds its own lite flagship — Phase-A tables, mock data
    and covariance — in its own workdir; the JAX side once per module."""
    jmodel = jflag.build_flagship(tmp_path_factory.mktemp("flagship_jax"), dtype=jnp.float64,
                                  **LITE)
    twork = tmp_path_factory.mktemp("flagship_torch")
    tmodel = tflag.build_flagship(twork, dtype=torch.float64, device="cpu", **LITE)
    return jmodel, tmodel, twork


@pytest.fixture(scope="module")
def default_models(tmp_path_factory):
    """Both packages' DEFAULT flagship (window, solver emulator), each in its
    own workdir with its own mock data and covariance."""
    jmodel = jflag.build_flagship(tmp_path_factory.mktemp("default_jax"), dtype=jnp.float64)
    twork = tmp_path_factory.mktemp("default_torch")
    tmodel = tflag.build_flagship(twork, dtype=torch.float64, device="cpu")
    return jmodel, tmodel, twork


@pytest.fixture(scope="module")
def lite_jax_ref(models):
    """The JAX flagship-lite's log-posterior and ``jax.grad`` at 4 seeded
    points: one jitted ``jax.vmap(jax.value_and_grad(logp))`` (an eager
    ``jax.vmap`` of ``logp`` alone compiles ~900 small ops, 30 s on the
    CPU)."""
    jmodel, tmodel, _ = models
    thetas = seeded_points(tmodel.theta0)
    logp, grad = jax.jit(jax.vmap(jax.value_and_grad(jmodel.logp)))(jnp.asarray(thetas))
    return thetas, np.asarray(logp), np.asarray(grad)


@pytest.fixture(scope="module")
def default_jax_ref(default_models):
    """The JAX default flagship's log-posterior and gradient at 4 seeded
    points, by JAX's own transformations of its ``FlagshipModel.logp``
    taken in the two pieces that function chains, ``logp =
    like.logp(inputs(params), params)`` (``eftpipe_tpu/api/flagship.py:74-87``;
    its float64 casts are the identity here): the likelihood and its
    ``jax.grad`` with respect to the inputs and the parameters, jitted, and
    the solver emulator's inputs with their Jacobian by ``jax.jvp`` along
    each parameter (``jax.jacfwd``, keeping the primal), eager.
    One eager ``jax.vmap`` of the whole ``logp`` compiles ~900 small ops
    (40 s on the CPU), its gradient as many again, and a ``jit`` of the
    whole gradient compiles the emulator's ~10⁴-operation polynomial graph
    (two minutes)."""
    jmodel, tmodel, _ = default_models
    thetas = seeded_points(tmodel.theta0, seed=2)

    def cosmo(th):
        params = jmodel.params_dict(th)
        return {t: p.inputs(params) for t, p in jmodel.providers.items()}

    def with_jacobian(th):
        push = lambda v: jax.jvp(cosmo, (th,), (v,))
        return jax.vmap(push, out_axes=(None, -1))(jnp.eye(th.size))

    def like(inputs, th):
        return jmodel.like.logp(inputs, jmodel.params_dict(th))["logp"]

    th = jnp.asarray(thetas)
    inputs, jac = jax.vmap(with_jacobian)(th)   # each Jacobian leaf (4, ..., 9)
    logp, (g_inputs, grad) = jax.jit(jax.vmap(jax.value_and_grad(like, argnums=(0, 1))))(
        inputs, th)
    for g_leaf, j_leaf in zip(jax.tree_util.tree_leaves(g_inputs),
                              jax.tree_util.tree_leaves(jac)):
        grad = grad + jnp.einsum("w...,w...k->wk", g_leaf, j_leaf)
    return thetas, np.asarray(logp), np.asarray(grad)


def test_default_flagship_is_the_jax_default(default_models):
    jmodel, tmodel, twork = default_models
    for name, spec in tmodel.like.tracers.items():
        assert type(tmodel.providers[name]).__name__ == "SolverEmulatorProvider"
        assert type(jmodel.providers[name]).__name__ == "SolverEmulatorProvider"
        pipe, jpipe_ = spec.pipeline, jmodel.like.tracers[name].pipeline
        assert pipe.wt is not None and pipe.wt["psn"] is None
        assert (pipe.wmt, pipe.ft) == (None, None)
        np.testing.assert_allclose(pipe.wt["wmat"].numpy(), jpipe_.wt["wmat"], rtol=1e-12,
                                   atol=1e-12 * np.abs(jpipe_.wt["wmat"]).max())
        assert pipe.wt["wmat"].shape[:2] == (pipe.cfg.nl, pipe.cfg.nl)
    np.testing.assert_allclose(tmodel.like.data_vector, jmodel.like.data_vector, rtol=1e-9)
    np.testing.assert_allclose(tmodel.like.invcov, jmodel.like.invcov, rtol=1e-7,
                               atol=1e-9 * np.abs(jmodel.like.invcov).max())
    meta = __import__("json").loads((twork / "flagship_meta.json").read_text())
    assert meta["with_window"] is True and meta["cosmology"] == "solver_emulator"
    assert meta["window_nmax"] == 2048


def test_default_flagship_logp_matches_jax_float64(default_models, default_jax_ref):
    """|Δlogp| ≤ 1e-8·|logp| on 4 seeded points (float64)."""
    _, tmodel, _ = default_models
    thetas, want, _ = default_jax_ref
    got = tmodel.logp(thetas)
    assert got.shape == (4,) and np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=0)


def test_default_flagship_float32_within_budget(default_models, tmp_path):
    """float32 against float64 on 16 seeded points: |Δlogp| < 0.02; a
    workdir built for another configuration regenerates its mock data."""
    _, tmodel, twork = default_models
    m32 = tflag.build_flagship(twork, dtype=torch.float32, device="cpu")
    thetas = seeded_points(tmodel.theta0, n=16, seed=3)
    d = np.abs(m32.logp(thetas).double().numpy() - tmodel.logp(thetas).numpy())
    assert d.max() < 0.02, d.max()
    lite = tflag.build_flagship(tmp_path, dtype=torch.float64, device="cpu", **LITE)
    again = tflag.build_flagship(tmp_path, dtype=torch.float64, device="cpu")
    assert not np.allclose(lite.like.data_vector, again.like.data_vector)
    np.testing.assert_allclose(again.like.data_vector, tmodel.like.data_vector, rtol=1e-12)


def test_flagship_ap_quadrature_option(models, tmp_path):
    """``ap_quadrature="gauss_legendre"`` puts float64 on the float32 µ nodes
    (float32 models agree bitwise with their default), and the mock data stay
    the default float64 model's, also when the option's model writes them."""
    _, tmodel, twork = models
    thetas = seeded_points(tmodel.theta0)
    gl64 = tflag.build_flagship(twork, dtype=torch.float64, device="cpu",
                                ap_quadrature="gauss_legendre", **LITE)
    fresh = tflag.build_flagship(tmp_path, dtype=torch.float64, device="cpu",
                                 ap_quadrature="gauss_legendre", **LITE)
    np.testing.assert_allclose(fresh.like.data_vector, tmodel.like.data_vector, rtol=1e-12)
    for name, spec in gl64.like.tracers.items():
        at = spec.pipeline.at
        np.testing.assert_array_equal(at["mu"].numpy(), at["mu_gl"].numpy())
        assert tmodel.like.tracers[name].pipeline.at["mu"].shape != at["mu"].shape
    d = np.abs(gl64.logp(thetas).numpy() - tmodel.logp(thetas).numpy())
    assert 0 < d.max() < 0.02, d
    m32 = [tflag.build_flagship(twork, dtype=torch.float32, device="cpu", ap_quadrature=q, **LITE)
           for q in ("by_dtype", "gauss_legendre")]
    np.testing.assert_array_equal(m32[0].logp(thetas).numpy(), m32[1].logp(thetas).numpy())


def test_flagship_static_state_matches(models):
    jmodel, tmodel, _ = models
    assert tmodel.param_names == jmodel.param_names
    np.testing.assert_array_equal(tmodel.theta0, jmodel.theta0)
    assert tflag.FIDUCIAL == jflag.FIDUCIAL and tflag.TRACERS == jflag.TRACERS
    # each side generated its own mock data and covariance from its own model
    np.testing.assert_allclose(tmodel.like.data_vector, jmodel.like.data_vector, rtol=1e-9)
    np.testing.assert_allclose(tmodel.like.invcov, jmodel.like.invcov, rtol=1e-7,
                               atol=1e-9 * np.abs(jmodel.like.invcov).max())
    assert tmodel.like.ndata == jmodel.like.ndata
    assert tmodel.like.marginal.names == jmodel.like.marginal.names
    for name, spec in tmodel.like.tracers.items():
        cfg = spec.pipeline.cfg
        assert (cfg.nfft_loop, cfg.nkin, cfg.nk, cfg.ns) == (256, 200, 50, 80)
        assert spec.pipeline.nt["mcf_fold"].shape == (38 * cfg.nl, 255, 255)
        assert spec.pipeline.nt["m22_fold"].shape == (28, 255, 255)


def test_flagship_logp_matches_jax_float64(models, lite_jax_ref):
    """|Δlogp| ≤ 1e-8·|logp| on 4 seeded points (float64, dense forms)."""
    _, tmodel, _ = models
    thetas, want, _ = lite_jax_ref
    got = tmodel.logp(thetas)
    assert got.shape == (4,) and got.dtype == torch.float64
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=0)
    # chunking the walker axis changes nothing
    np.testing.assert_allclose(tmodel.logp(thetas, chunk=3).numpy(), got.numpy(), rtol=1e-12)
    np.testing.assert_allclose(tmodel.logp(torch.as_tensor(thetas), chunk=1).numpy(),
                               got.numpy(), rtol=1e-12)


def test_flagship_peaks_at_fiducial_and_validates_input(models):
    _, tmodel, _ = models
    lp = tmodel.logp(np.stack([tmodel.theta0, tmodel.theta0 * 1.05]))
    assert torch.isfinite(lp).all() and lp[0] > lp[1]
    with pytest.raises(ValueError):
        tmodel.logp(tmodel.theta0)          # the walker axis is explicit
    with pytest.raises(ValueError):
        tmodel.logp(np.zeros((2, 5)))


def test_flagship_float32_within_budget_of_float64(models):
    """float32 (GL-16 AP quadrature, IEEE products) against float64 on 16
    seeded points: |Δlogp| < 0.02, the JAX package's accuracy budget."""
    _, tmodel, twork = models
    m32 = tflag.build_flagship(twork, dtype=torch.float32, device="cpu", **LITE)
    thetas = seeded_points(tmodel.theta0, n=16, seed=1)
    lp32 = m32.logp(thetas)
    assert lp32.dtype == torch.float32
    d = np.abs(lp32.double().numpy() - tmodel.logp(thetas).numpy())
    assert d.max() < 0.02, d.max()
    # the plain route gives the same float32 numbers as the public op on the CPU
    plain = tflag.build_flagship(twork, dtype=torch.float32, device="cpu", quadform="plain",
                                 **LITE)
    np.testing.assert_array_equal(plain.logp(thetas).numpy(), lp32.numpy())


def test_flagship_fold_ab_check_and_no_launch_on_cpu(models):
    """The complex A/B reference of the fold at full width; on the CPU no
    kernel is launched."""
    _, tmodel, _ = models
    tq.reset_launch_counts()
    ref, folded = tmodel.fold_ab_check(seeded_points(tmodel.theta0, n=2), tracer="ELG")
    assert ref.shape == folded.shape == (2, 38, 80)
    assert float((ref - folded).abs().max() / folded.abs().max()) < 1e-10
    assert tq.LAUNCHES == {"qf_real": 0, "cf_half": 0}


def test_eh98_provider_matches_jax():
    rng = np.random.default_rng(5)
    w = 5
    fid = tflag.FIDUCIAL
    params = {k: v * (1 + 0.02 * rng.standard_normal(w)) for k, v in fid.items()}
    om_fid = (fid["omega_b"] + fid["omega_cdm"]) / fid["h"] ** 2
    kw = dict(zeff=0.845, da_fid=lcdm_da(om_fid, 0.845), h_fid=lcdm_hubble(om_fid, 0.845))
    jprov = jeh.EisensteinHuProvider(cfg=JConfig(), **kw)
    tprov = teh.EisensteinHuProvider(cfg=TConfig(), **kw)
    want = jax.vmap(jprov.inputs)({k: jnp.asarray(v) for k, v in params.items()})
    got = tprov.inputs({k: torch.as_tensor(v) for k, v in params.items()})
    for field in want._fields:
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=1e-11, err_msg=field)
    assert got.plin.shape == (w, 200) and got.f.shape == (w,)
    off = teh.EisensteinHuProvider(cfg=TConfig(), zeff=0.845, use_ap=False).inputs(
        {k: torch.as_tensor(v) for k, v in params.items()})
    assert torch.equal(off.qperp, torch.ones(w, dtype=torch.float64))
    # float32 inputs give float32 outputs on the same device
    p32 = tprov.inputs({k: torch.as_tensor(v, dtype=torch.float32) for k, v in params.items()})
    assert p32.plin.dtype == torch.float32
    np.testing.assert_allclose(p32.plin.double().numpy(), got.plin.numpy(), rtol=2e-4)


def test_growth_and_background_match_goldens_and_host():
    gold = np.load(GOLDENS / "eh98_growth_fn.npz")["fn"]
    for (om, z), fn_ref in zip(GROWTH_POINTS, gold):
        d, f = teh.lcdm_growth(torch.tensor([om, om], dtype=torch.float64), z)
        assert float(f[0]) == pytest.approx(fn_ref, rel=1e-8) and float(f[1]) == float(f[0])
        assert float(d[0]) == pytest.approx(tbg.growth_factor_lcdm(om, z), rel=1e-8)
        assert tbg.growth_rate_lcdm(om, z) == pytest.approx(fn_ref, rel=1e-10)
        jd, jf = jeh.lcdm_growth(jnp.asarray(om), jnp.asarray(z))
        assert float(d[0]) == pytest.approx(float(jd), rel=1e-13)
        assert float(teh.lcdm_growth_f(torch.tensor([om], dtype=torch.float64), z)[0]) == float(f[0])
    for om, z in [(0.31, 0.7), (0.27, 1.2)]:
        e, da = teh.lcdm_background(torch.tensor([om], dtype=torch.float64), z)
        assert float(e[0]) == pytest.approx(lcdm_hubble(om, z), rel=1e-12)
        assert float(da[0]) == pytest.approx(lcdm_da(om, z), rel=1e-9)


def _torch_grad(tmodel, thetas):
    """∇logp of each walker by autograd through the port's batched logp."""
    x = torch.tensor(thetas, dtype=torch.float64, requires_grad=True)
    lp = tmodel.logp(x)
    (g,) = torch.autograd.grad(lp.sum(), x)
    return lp.detach().numpy(), g.numpy()


def test_flagship_grad_matches_jax_grad(models, lite_jax_ref):
    """autograd of the port's float64 logp against jax.grad of the JAX
    flagship-lite on the 4 points of ``lite_jax_ref``, within 1e-6·max|g|
    per component."""
    _, tmodel, _ = models
    thetas, _, want = lite_jax_ref
    _, got = _torch_grad(tmodel, thetas)
    assert np.isfinite(want).all() and np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_default_flagship_grad_matches_jax(default_models, default_jax_ref):
    """The same for the default flagship, on the 4 points of
    ``default_jax_ref``."""
    _, tmodel, _ = default_models
    thetas, _, want = default_jax_ref
    _, got = _torch_grad(tmodel, thetas)
    assert np.isfinite(want).all() and np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_bad_walkers_do_not_poison_the_batch_gradient(default_models):
    """A walker outside the emulator's box and one with NaN parameters in a
    batch: nothing raises, and every other walker's log-posterior and
    gradient are finite and those of the batch without them."""
    _, tmodel, _ = default_models
    good = seeded_points(tmodel.theta0, n=2, seed=6)
    out_of_box = tmodel.theta0.copy()
    out_of_box[0] = 0.8  # omega_cdm above the emulator's box (0.03, 0.7)
    nan = np.full_like(tmodel.theta0, np.nan)
    lp_ref, g_ref = _torch_grad(tmodel, good)
    lp, g = _torch_grad(tmodel, np.stack([good[0], out_of_box, good[1], nan]))
    assert np.isfinite(g_ref).all() and np.isfinite(lp_ref).all()
    np.testing.assert_allclose(lp[[0, 2]], lp_ref, rtol=1e-12)
    np.testing.assert_allclose(g[[0, 2]], g_ref, rtol=1e-10, atol=1e-10 * np.abs(g_ref).max())
    assert not np.isnan(lp[1]) and lp[3] == -np.inf
