"""Small ops of the port (cplx, legendre, interp, fftlog, qcoef, loop tables)
against their JAX counterparts and the committed goldens: NumPy inputs from a
seed through both sides, float64."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from eftpipe_tpu.ops import cplx as jcplx, fftlog as jfft, interp as jinterp
from eftpipe_tpu.ops.legendre import legendre_even as jleg
from eftpipe_tpu.tables import loop_matrices as jlm, qcoef as jq
from eftpipe_tpu.models.config import EFTConfig as JConfig
from eftpipe_tpu_torch.ops import cplx as tcplx, fftlog as tfft, interp as tinterp
from eftpipe_tpu_torch.ops.legendre import legendre_even as tleg
from eftpipe_tpu_torch.tables import loop_matrices as tlm, qcoef as tqc
from eftpipe_tpu_torch.models.config import EFTConfig as TConfig, kbird_grid

from test_fftlog import CASES, _key, smooth_positive

GOLDENS = __import__("pathlib").Path(__file__).parent / "goldens"


def t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def test_cplx_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 4, 6))
    b = rng.standard_normal((2, 6, 3, 5))
    ja, jb = tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b))
    ta, tb = tuple(map(t, a)), tuple(map(t, b))
    for got, want in zip(tcplx.ceinsum("...n,nbk->...bk", ta, tb),
                         jcplx.ceinsum("...n,nbk->...bk", ja, jb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(
        tcplx.ceinsum_real("...n,nbk->...bk", ta, tb).numpy(),
        np.asarray(jcplx.ceinsum_real("...n,nbk->...bk", ja, jb)), rtol=1e-13, atol=1e-14)
    for got, want in zip(tcplx.cmul(ta, ta), jcplx.cmul(ja, ja)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14)
    z = a[0] + 1j * a[1]
    for got, want in zip(tcplx.split(z), jcplx.split(z)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("i", range(5))
def test_legendre_even_matches_jax(i):
    x = np.linspace(-1, 1, 41)
    np.testing.assert_allclose(np.asarray(tleg(i, t(x))), np.asarray(jleg(i, jnp.asarray(x))),
                               rtol=1e-14, atol=1e-15)
    np.testing.assert_array_equal(tleg(i, x), jleg(i, x))


def test_spline_tables_bitwise():
    rng = np.random.default_rng(1)
    xin = np.sort(rng.uniform(0.01, 1.0, 30))
    xout = rng.uniform(0.005, 1.2, 40)
    np.testing.assert_array_equal(tinterp.spline_matrix(xin, xout), jinterp.spline_matrix(xin, xout))
    np.testing.assert_array_equal(tinterp.spline_matrix(xin, xout, log_x=True),
                                  jinterp.spline_matrix(xin, xout, log_x=True))
    a, b = tinterp.SplineTable.build(xin), jinterp.SplineTable.build(xin)
    for f in ("x", "m2", "h"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_spline_eval_matches_jax():
    """Gather form here, one-hot matmul form there: 1e-12 relative."""
    rng = np.random.default_rng(2)
    x = kbird_grid()
    y = rng.standard_normal((3, 4, x.size))
    xq = rng.uniform(0.0005, 0.35, (6, 7))   # includes extrapolation both ends
    want = np.asarray(jinterp.spline_eval(jinterp.SplineTable.build(x), jnp.asarray(y), jnp.asarray(xq)))
    got = tinterp.spline_eval(tinterp.SplineTable.build(x), t(y), t(xq)).numpy()
    assert got.shape == (3, 4, 6, 7)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("seed", range(4))
def test_matmul_interp_bitwise(seed):
    """The fuzz of tests/test_interp.py: queries on knots, ±1 ulp around
    every knot and outside the grid.  The one-hot contractions are exact, so
    the result is BITWISE equal to the gather form of the same formula in
    IEEE arithmetic (NumPy); against ``jnp.interp`` and the JAX package's
    MatmulInterp, whose compiled a + b·c is contracted to an FMA, it agrees
    to 4 ulp of the largest data value."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 60))
    gaps = np.exp(rng.uniform(-3.0, 3.0, size=n - 1))
    xp = np.concatenate([[rng.uniform(-5, 5)], gaps]).cumsum()
    fp = rng.normal(size=(3, xp.size)).cumsum(axis=-1)
    q = np.concatenate([xp, np.nextafter(xp, np.inf), np.nextafter(xp, -np.inf),
                        rng.uniform(xp[0], xp[-1], size=200),
                        [xp[0] - 1.0, xp[-1] + 1.0, xp[0] - 1e-9, xp[-1] + 1e-9]])
    got = tinterp.MatmulInterp.build(xp).interp(t(q), t(fp)).numpy()
    idx = np.clip(np.searchsorted(xp, q, side="right") - 1, 0, n - 2)
    gather = fp[:, idx] + ((q - xp[idx]) / (xp[idx + 1] - xp[idx])) * (fp[:, idx + 1] - fp[:, idx])
    gather = np.where(q <= xp[0], fp[:, :1], np.where(q >= xp[-1], fp[:, -1:], gather))
    np.testing.assert_array_equal(got, gather)
    ulp4 = 4 * np.spacing(np.abs(fp).max())
    want = np.stack([np.asarray(jnp.interp(jnp.asarray(q), jnp.asarray(xp), jnp.asarray(f)))
                     for f in fp])
    np.testing.assert_allclose(got, want, rtol=0, atol=ulp4)
    theirs = jinterp.MatmulInterp.build(xp).interp(jnp.asarray(q), jnp.asarray(fp))
    np.testing.assert_allclose(got, np.asarray(theirs), rtol=0, atol=ulp4)
    # the row-wise gather form (one query grid per leading index) is the same
    # formula, and the grid's tensor is made once per device and dtype
    lut = tinterp.MatmulInterp.build(xp)
    rows = lut.interp_rows(t(np.broadcast_to(q, fp.shape[:1] + q.shape).copy()), t(fp))
    np.testing.assert_array_equal(rows.numpy(), gather)
    assert lut._grid(t(q)) is lut._grid(t(q))
    with pytest.raises(ValueError):
        tinterp.MatmulInterp.build(xp[::-1])


def test_host_fftlog_bitwise_and_goldens():
    kin = np.logspace(-5, 0, 200)
    f = smooth_positive(kin)
    ours = tfft.HostFFTLog(n=256, xmin=1.5e-5, xmax=1000.0, bias=-1.6)
    theirs = jfft.HostFFTLog(n=256, xmin=1.5e-5, xmax=1000.0, bias=-1.6)
    gold = np.load(GOLDENS / "fftlog_host_coef.npz")
    np.testing.assert_array_equal(ours.pow, theirs.pow)
    np.testing.assert_allclose(ours.x, gold["x"], rtol=1e-14)
    for window, extrap in CASES:
        c = ours.coef(kin, f, extrap=extrap, window=window)
        np.testing.assert_array_equal(c, theirs.coef(kin, f, extrap=extrap, window=window))
        ref = gold[_key(window, extrap)]
        np.testing.assert_allclose(c, ref, rtol=1e-9, atol=1e-13 * np.abs(ref).max())
    wgold = np.load(GOLDENS / "fftlog_spectral_window.npz")
    for window in (1.0, 0.75, 0.2):
        np.testing.assert_allclose(tfft.spectral_window(256, window), wgold[f"w{window}"], rtol=1e-14)
    # batched golden
    sin = np.geomspace(0.5, 900.0, 120)
    fb = np.abs(np.random.default_rng(3).normal(size=(3, 5, sin.size))) + 0.1
    cref = np.load(GOLDENS / "fftlog_batched_coef.npz")["coef"]
    cb = tfft.HostFFTLog(n=192, xmin=0.1, xmax=10000.0, bias=-0.6).coef(
        sin, fb, extrap="padding", window=None)
    np.testing.assert_allclose(cb, cref, rtol=1e-9, atol=1e-12 * np.abs(cref).max())


@pytest.mark.parametrize("window", [1.0, 0.2, None])
@pytest.mark.parametrize("extrap", ["extrap", "padding", ("padding", "extrap")])
def test_fftlog_plan_and_coef_match_jax(window, extrap):
    """Plans bitwise; batched coefficients 1e-12 of the largest one."""
    kin = np.logspace(-5, 0, 200)
    fs = np.stack([smooth_positive(kin, seed=s) for s in range(3)])
    args = dict(n=128, xmin=1.5e-5, xmax=1000.0, bias=-1.6)
    tplan = tfft.make_plan(tfft.HostFFTLog(**args), kin, extrap=extrap, window=window)
    jplan = jfft.make_plan(jfft.HostFFTLog(**args), kin, extrap=extrap, window=window)
    for fld in dataclasses.fields(tplan):
        np.testing.assert_array_equal(getattr(tplan, fld.name), getattr(jplan, fld.name))
    cre, cim = tfft.fftlog_coef(tplan, t(fs))
    jre, jim = jfft.fftlog_coef(jplan, jnp.asarray(fs))
    scale = np.abs(np.asarray(jre)).max()
    np.testing.assert_allclose(cre.numpy(), np.asarray(jre), rtol=1e-10, atol=1e-12 * scale)
    np.testing.assert_allclose(cim.numpy(), np.asarray(jim), rtol=1e-10, atol=1e-12 * scale)
    # and against the host transform
    c_host = tfft.HostFFTLog(**args).coef(kin, fs, extrap=extrap, window=window)
    np.testing.assert_allclose(cre.numpy(), c_host.real, rtol=1e-9, atol=1e-11 * scale)


def test_loop_tables_qcoef_config_bitwise():
    pw = tfft.HostFFTLog(n=32, xmin=1.5e-5, xmax=1000.0, bias=-1.6).pow
    np.testing.assert_array_equal(tlm.m13_matrices(pw), jlm.m13_matrices(pw))
    np.testing.assert_array_equal(tlm.m22_matrices(pw), jlm.m22_matrices(pw))
    np.testing.assert_array_equal(tlm.mpc(2, -0.5 * pw), jlm.mpc(2, -0.5 * pw))
    for nl in (2, 3):
        a, b = tlm.legendre_weights(nl), jlm.legendre_weights(nl)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for nir in (8, 16):
        (ca, fa), (cb, fb) = tqc.load_qcoef(nir), jq.load_qcoef(nir)
        np.testing.assert_array_equal(ca, cb)
        assert fa == fb
    f = np.array([0.6, 0.75, 0.9])
    coef, fmax = tqc.load_qcoef(8)
    qj = np.asarray(jq.make_q(jnp.asarray(coef), fmax, jnp.asarray(f)))
    np.testing.assert_allclose(tqc.make_q(t(coef), fmax, t(f)).numpy(), qj,
                               rtol=1e-10, atol=1e-13 * np.abs(qj).max())
    ta, ja = TConfig(nl=3, no=3, nd_a=5e-5), JConfig(nl=3, no=3, nd_a=5e-5)
    for name in ("k", "s", "kin", "kr"):
        np.testing.assert_array_equal(getattr(ta, name), getattr(ja, name))
    assert (ta.nk, ta.ns, ta.nklow, ta.cache_key()) == (ja.nk, ja.ns, ja.nklow, ja.cache_key())
