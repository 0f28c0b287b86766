"""The port's emulator training (``boltzmann/emulator.py``: ``_ridge_fit``,
``train_pk_emulator``, ``PkEmulator.save``, ``init_mlp``,
``train_transfer_emulator``; ``tools/train_solver_emulator.py``) against the
JAX package's, float64 on the CPU, on identical NumPy inputs: the P(k) fit
on seeded synthetic spectra, artifact files read across both packages, 20
Adam steps of the transfer MLP from the JAX package's own initial weights,
and the training recipe's sample design, workdir contract and batched
solves (the solver replaced by a seeded stub where only the bookkeeping is
under test)."""

import functools
import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from eftpipe_tpu.boltzmann import emulator as je
from eftpipe_tpu_torch.boltzmann import emulator as te, einstein_boltzmann as teb, thermo as tth
from eftpipe_tpu_torch.convert import emulator_from_numpy, eb_solver_from_numpy, \
    mlp_params_from_numpy
from eftpipe_tpu_torch.tools import train_solver_emulator as tool

ROOT = Path(__file__).resolve().parent.parent
ARTIFACT = ROOT / "eftpipe_tpu_torch" / "boltzmann" / "artifacts" / "pk_emulator_mnu06.npz"
RTOL = 1e-12
NZ, NK = 2, 5
INNER = (np.array([0.020, 0.09, 0.60]), np.array([0.024, 0.15, 0.76]))
PK_FIELDS = ("coeffs", "y_mean", "x_mean", "x_std", "coeffs_in", "y_mean_in", "x_mean_in",
             "x_std_in", "blend_lo", "blend_hi", "blend_margin", "bounds_lo", "bounds_hi",
             "kgrid", "z_grid")


def jax_tool():
    """The JAX package's ``tools/train_solver_emulator.py`` as a module."""
    spec = importlib.util.spec_from_file_location("jax_train_solver_emulator",
                                                  ROOT / "tools" / "train_solver_emulator.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def synthetic(n=64, seed=0):
    """Seeded smooth targets (n, 2·NZ·NK + 1) of inputs, half in the wide
    box and half in the inner one, with noise, so that the fit's errors
    stand well above rounding."""
    rng = np.random.default_rng(seed)
    lo, hi = np.array([0.017, 0.03, 0.40]), np.array([0.029, 0.70, 1.00])
    x = np.concatenate([lo + (hi - lo) * rng.random((n // 2, 3)),
                        INNER[0] + (INNER[1] - INNER[0]) * rng.random((n - n // 2, 3))])
    u = (x - lo) / (hi - lo)
    k = np.linspace(0.0, 1.0, NK)
    cols = [np.exp(-(1 + z) * k[None] * (1 + u[:, :1])) * (1 + 0.3 * u[:, 1:2]) + u[:, 2:3] * k
            for z in range(2 * NZ)]
    y = np.concatenate(cols + [np.log(147.0 + 20 * u[:, 1:2])], axis=1)
    return x, y + 1e-3 * rng.standard_normal(y.shape)


META = dict(bounds_lo=np.array([0.017, 0.03, 0.40]), bounds_hi=np.array([0.029, 0.70, 1.00]),
            input_names=["omega_b", "omega_cdm", "h"], m_ncdm=0.02, deg_ncdm=3.0,
            n_ur=0.00641, yhe=0.2454, kmax=1.6, n_train=64)


def assert_same_pk(got, want, rtol=RTOL):
    for name in PK_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol, atol=0, err_msg=name)
    for name in ("degree", "degree_in", "m_ncdm", "deg_ncdm", "n_ur", "yhe", "input_names",
                 "meta"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("inner", [False, True])
def test_train_pk_emulator_matches_jax(inner, tmp_path):
    """The fit (SVD, ridge solves, the log-r_drag refit, the inner box) and
    its report equal the JAX function's; each package's file loads in the
    other with equal arrays."""
    x, y = synthetic()
    kw = dict(ncomp=8, degree=5, inner_bounds=INNER if inner else None, degree_in=3)
    kgrid, zgrid = np.geomspace(1e-3, 1.0, NK), np.array([0.5, 0.0])
    got, grep = te.train_pk_emulator(x, y, kgrid, zgrid, meta=dict(META), device="cpu", **kw)
    want, wrep = je.train_pk_emulator(x, y, kgrid, zgrid, meta=dict(META), **kw)
    assert_same_pk(got, want)
    assert set(grep) == set(wrep)
    for key, w in wrep.items():
        np.testing.assert_allclose(grep[key], w, rtol=RTOL, err_msg=key)
    assert ("val_inner_max_abs_logT" in grep) == inner
    # artifact files across the packages
    got.save(tmp_path / "port.npz")
    want.save(tmp_path / "jax.npz")
    assert_same_pk(je.PkEmulator.load(tmp_path / "port.npz"), want, rtol=0)
    assert_same_pk(te.PkEmulator.load(tmp_path / "jax.npz"), got, rtol=0)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
    # a JAX-trained emulator in memory carries across, and predicts the same
    carried = emulator_from_numpy({k: v for k, v in vars(want).items()})
    xq = torch.as_tensor(x[:7])
    np.testing.assert_allclose(carried.raw(xq).numpy(), np.asarray(want.raw(jnp.asarray(x[:7]))),
                               rtol=1e-12)


def test_ridge_design_in_poly_exponents_order():
    xn = np.random.default_rng(1).standard_normal((6, 3))
    expo = te.poly_exponents(3, 4)
    want = np.prod(xn[:, None, :] ** expo[None], axis=-1)
    np.testing.assert_allclose(te._design_numpy(xn, 4), want, rtol=1e-13)


def test_train_transfer_emulator_matches_jax(tmp_path, monkeypatch):
    """20 Adam steps from the JAX package's own initial weights (the port
    starts from them through ``mlp_params_from_numpy``: ``jax.random``
    cannot be reproduced in torch): every parameter within 1e-10, the
    normalisations equal; the port's saved file loads in the JAX package."""
    k = np.logspace(-4, 0.3, 40)
    kw = dict(n_samples=32, width=16, depth=2, steps=20, lr=3e-3, seed=1)
    sizes = [4, 16, 16, k.size]
    jinit = je.init_mlp(jax.random.PRNGKey(kw["seed"]), sizes)
    init = mlp_params_from_numpy([{n: np.asarray(v) for n, v in layer.items()} for layer in jinit],
                                 device="cpu")
    monkeypatch.setattr(te, "init_mlp", lambda gen, s, dtype: init if s == sizes else None)
    got = te.train_transfer_emulator(k, device="cpu", dtype=torch.float64, **kw)
    want = je.train_transfer_emulator(k, **kw)
    for g, w in zip(got.params, want.params):
        for n in "wb":
            np.testing.assert_allclose(g[n].numpy(), np.asarray(w[n]), rtol=0, atol=1e-10)
            assert g[n].device.type == "cpu" and g[n].dtype == torch.float64
    for name in ("x_mean", "x_std", "y_mean", "y_std"):
        np.testing.assert_allclose(getattr(got, name), np.asarray(getattr(want, name)),
                                   rtol=1e-13, err_msg=name)
    assert got.input_names == want.input_names
    got.save(tmp_path / "port.npz")
    back = je.TransferEmulator.load(tmp_path / "port.npz")
    for g, w in zip(got.params, back.params):
        for n in "wb":
            np.testing.assert_array_equal(g[n].numpy(), w[n])
    xq = np.array([[0.0223, 0.118, 0.69, 0.965]])
    np.testing.assert_allclose(got(torch.as_tensor(xq)).numpy(),
                               np.asarray(want(jnp.asarray(xq[0])))[None], rtol=1e-9)


def test_init_mlp_is_he_initialised():
    gen = torch.Generator().manual_seed(3)
    params = te.init_mlp(gen, [4, 64, 3], torch.float64)
    assert [tuple(p["w"].shape) for p in params] == [(4, 64), (64, 3)]
    assert all(float(p["b"].abs().max()) == 0.0 for p in params)
    ref = torch.randn((4, 64), generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    assert torch.equal(params[0]["w"], ref * np.sqrt(2.0 / 4))


# ---------------------------------------------------------------------------
# the training recipe
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sample_mnu", [False, True])
def test_sample_design_matches_the_jax_tool(sample_mnu, tmp_path, monkeypatch):
    """The constants and the design (Sobol seeds 7 and 11, the 4-D
    permutation) equal the JAX tool's bit for bit: its ``main`` writes
    ``x.npy`` and ``sampling_meta.json`` before it fits (and then stops, no
    samples being there)."""
    jt = jax_tool()
    for name in ("BOUNDS", "INNER_BOUNDS", "NEUTRINO", "MNU_BOUNDS", "MNU_INNER", "SOLVER_KMAX"):
        assert getattr(tool, name) == getattr(jt, name), name
    np.testing.assert_array_equal(tool.Z_GRID, jt.Z_GRID)
    np.testing.assert_array_equal(tool.sobol(37, 3, seed=11), jt.sobol(37, 3, seed=11))
    argv = ["train", "--n", "40", "--inner-frac", "0.35", "--workdir", str(tmp_path / "jax"),
            "--train-only"] + (["--sample-mnu"] if sample_mnu else [])
    monkeypatch.setattr(sys, "argv", argv)
    with pytest.raises(FileNotFoundError, match="kgrid"):
        jt.main()
    d = tool.prepare_workdir(tmp_path / "port", tool.sample_design(40, 0.35, sample_mnu))
    np.testing.assert_array_equal(d["x"], np.load(tmp_path / "jax" / "x.npy"))
    for name in ("x.npy", "sampling_meta.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_shipped_artifact_design():
    """At ``--n 512 --inner-frac 0.35`` the training subset (the fit's
    ``default_rng(0)`` split) has the shipped artifact's x_mean and x_std,
    exactly."""
    x = tool.sample_design(512, 0.35)["x"]
    ti = np.random.default_rng(0).permutation(512)[51:]
    with np.load(ARTIFACT) as z:
        np.testing.assert_array_equal(x[ti].mean(0), z["x_mean"])
        np.testing.assert_array_equal(x[ti].std(0) + 1e-12, z["x_std"])


class StubSolver:
    """A seeded stand-in for the solver: smooth spectra of each input row,
    and a count of its calls and cosmologies."""

    def __init__(self):
        self.k_mpc = np.geomspace(1e-3, 1.0, 6)
        self.device = torch.device("cpu")
        self.calls, self.seen = 0, 0

    def __call__(self, par):
        self.calls += 1
        self.seen += par.h.shape[0]
        k = torch.as_tensor(self.k_mpc)
        z = torch.as_tensor(np.sort(tool.Z_GRID)[::-1].copy())
        amp = (par.omega_cdm / par.h**2)[:, None, None] * (1 + z)[None, :, None] ** -2
        pk = amp * 1e4 * k / (1 + (k / (0.02 + par.omega_b[:, None, None])) ** 2.5)
        return SimpleNamespace(k_mpc=k, pk=pk, pk_cb=0.97 * pk, rs_drag=147.0 * par.h)


def test_workdir_contract(tmp_path, monkeypatch):
    """Refuse a mismatch; ``--train-only`` restores the stored design;
    resume solves only the missing samples; the artifact fits and loads."""
    stub = StubSolver()
    monkeypatch.setattr(tool, "design_solver", lambda design, device=None: stub)
    wd, out = tmp_path / "wd", tmp_path / "emu.npz"
    small = ["--ncomp", "4", "--degree", "2", "--degree-in", "2", "--device", "cpu"]
    tool.main(["--n", "16", "--batch", "5", "--workdir", str(wd), "--out", str(out)] + small)
    assert (stub.calls, stub.seen) == (4, 16)
    assert sorted(p.name for p in wd.glob("sample_*.npz")) == [f"sample_{i:04d}.npz"
                                                                for i in range(16)]
    emu = te.PkEmulator.load(out)
    assert emu.meta == {"kmax": 1.6, "n_train": 16} and emu.m_ncdm == 0.02
    # resume: two samples lost
    for i in (3, 11):
        (wd / f"sample_{i:04d}.npz").unlink()
    tool.main(["--n", "16", "--batch", "5", "--workdir", str(wd), "--out", str(out)] + small)
    assert (stub.calls, stub.seen) == (5, 18)
    # another design refuses; --train-only keeps the stored one
    with pytest.raises(SystemExit, match="refusing to mix"):
        tool.main(["--n", "16", "--sample-mnu", "--workdir", str(wd), "--out", str(out)] + small)
    tool.main(["--n", "16", "--sample-mnu", "--train-only", "--workdir", str(wd),
               "--out", str(tmp_path / "again.npz")] + small)
    again = te.PkEmulator.load(tmp_path / "again.npz")
    assert again.input_names == ("omega_b", "omega_cdm", "h") and again.m_ncdm == 0.02
    np.testing.assert_array_equal(again.coeffs, emu.coeffs)
    assert stub.calls == 5
    # a workdir without metadata refuses any difference
    (wd / "sampling_meta.json").unlink()
    with pytest.raises(SystemExit, match="refusing to guess"):
        tool.main(["--n", "16", "--inner-frac", "0.5", "--train-only", "--workdir", str(wd),
                   "--out", str(out)] + small)
    with pytest.raises(SystemExit):
        tool.main(["--n", "16", "--workdir", str(wd)])  # --out is required


CUT_K = np.array([1e-4, 2e-3])


def test_batched_solve_equals_single_solves(tmp_path, monkeypatch):
    """The recipe's batched solve (2 cosmologies a call) writes the samples
    of one-at-a-time solves, bit for bit: a cut schedule (two low-k modes,
    coarse steps) over the envelope of the two cosmologies, the tables on a
    256-point grid with the recombination on it."""
    monkeypatch.setattr(teb, "background_tables",
                        functools.partial(tth.background_tables, n_grid=256))
    monkeypatch.setattr(teb, "thermo_tables", functools.partial(tth.thermo_tables, n_fine=0))
    design = tool.sample_design(8, 1.0)
    x = torch.as_tensor(design["x"][:2])
    par = teb.box_params(x[:, 0], x[:, 1], x[:, 2], tool.NEUTRINO["m_ncdm"], device="cpu")
    bg = teb.background_tables(par)
    bg_f, th_f = teb.host_tables(bg, teb.thermo_tables(par, bg))
    z_out = np.sort(tool.Z_GRID)[::-1]
    lna_out = np.unique(np.log(1.0 / (1.0 + z_out)))
    raw, rm = teb.build_schedule(CUT_K, bg_f, th_f, lna_out, pad=False, phase_acc=0.9,
                                 dlna_max=0.5)
    buckets = []
    for idx in teb.bucket_indices([g.size for g in raw]):
        grids = teb._pad_grids([raw[i] for i in idx])
        buckets.append((idx, grids, teb._pad_masks([rm[i] for i in idx]),
                        teb.out_indices(grids, lna_out)))
    solver = eb_solver_from_numpy(dict(k_mpc=CUT_K, z_out=z_out, lna_out=lna_out, dlna_f=0.02,
                                       growth_stencil=False, buckets=buckets), device="cpu")
    d2 = dict(design, x=design["x"][:2])
    assert tool.solve_samples(solver, d2, tmp_path / "batched", batch=2, log=lambda m: None) == 1
    assert tool.solve_samples(solver, d2, tmp_path / "single", batch=1, log=lambda m: None) == 2
    for i in range(2):
        with np.load(tool.sample_path(tmp_path / "batched", i)) as a, \
                np.load(tool.sample_path(tmp_path / "single", i)) as b:
            for name in ("log_tm", "log_tcb", "log_rdrag"):
                assert np.isfinite(a[name]).all()
                np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_box_corners_of_both_recipes():
    """The corner envelope shared by the 3-D recipe (8 corners at the fixed
    mass) and the 4-D one (16, the mass an axis), in ``itertools.product``
    order."""
    three = teb.box_corners(dict(tool.BOUNDS), tool.NEUTRINO["m_ncdm"])
    four = teb.box_corners(dict(tool.BOUNDS, m_ncdm=tool.MNU_BOUNDS))
    assert len(three) == 8 and len(four) == 16
    assert [(c.omega_b, c.omega_cdm, c.h, c.m_ncdm) for c in three[:2]] == [
        (0.017, 0.03, 0.40, 0.02), (0.017, 0.03, 1.00, 0.02)]
    assert {c.m_ncdm for c in four} == set(tool.MNU_BOUNDS)
    assert all(c.deg_ncdm == 3.0 and c.n_ur == 0.00641 and c.ns == 0.9649 for c in four)
    with pytest.raises(ValueError, match="m_ncdm"):
        teb.box_corners(dict(tool.BOUNDS))
