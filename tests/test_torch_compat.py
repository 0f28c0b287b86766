"""Migration paths of the port against the JAX package: the Cobaya config
conversion (``compat/cobaya.py``), the Cobaya chain readers
(``ChainProducts.from_cobaya`` / ``progress`` / ``fixed_params``) and the
transfer-emulator provider (``EmulatorProvider`` / ``TransferEmulator``),
on in-test dicts, a Cobaya-format run written here and an emulator file
written by the JAX package's ``TransferEmulator.save`` from seeded NumPy
weights (no training, no download)."""

import copy
import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import yaml

from eftpipe_tpu.compat import convert_cobaya_config as jconvert
from eftpipe_tpu.compat.cobaya import _rename_lambda_args as jrename
from eftpipe_tpu_torch.compat import convert_cobaya_config
from eftpipe_tpu_torch.compat.cobaya import _rename_lambda_args

# ----------------------------------------------------------------------
# Cobaya configs: the mixed three-tracer and the cross structures of
# tests/test_compat.py, as dicts
# ----------------------------------------------------------------------
_DEFAULT = {
    "km": 0.7, "kr": 0.35, "with_NNLO": True, "with_IRresum": True,
    "with_APeffect": True, "APeffect": {"Om_AP": 0.307, "rdrag_AP": 147.74},
}


def cobaya_mixed():
    """LRG (west coast, window), ELG (east coast, window + fiber) and their
    cross, two likelihood blocks (NGC + SGC style), the production params
    block with renamed cosmology, lambda-valued and latex-only entries."""
    window = {"window_fourier_file": "cache/fourier_{}.npy",
              "window_configspace_file": "data/window_{}.dat", "Nmax": 1024}
    tracers = {
        "default": copy.deepcopy(_DEFAULT),
        "LRG_NGC": {"prefix": "LRG_NGC_", "z": 0.7, "nd": 7.65e-5, "basis": "westcoast",
                    "APeffect": {"z_AP": 0.7}, "with_window": True,
                    "window": {k: v.format("LRG") if isinstance(v, str) else v
                               for k, v in window.items()},
                    "with_icc": True,
                    "icc": {"icc_configspace_SN_file": "data/sn.dat",
                            "icc_configspace_IC_file": "data/ic.dat", "Pshot": 1.3e4}},
        "ELG_NGC": {"prefix": "ELG_NGC_", "z": 0.845, "nd": 1.85e-4, "basis": "eastcoast",
                    "with_window": True,
                    "window": {k: v.format("ELG") if isinstance(v, str) else v
                               for k, v in window.items()},
                    "with_fiber": True, "fiber": {"Dfc": 0.7, "fiberst": True},
                    "with_RSD": True},
        "x_NGC": {"prefix": "x_NGC_", "z": 0.77, "cross": ["LRG_NGC", "ELG_NGC"],
                  "with_window": False, "with_IRresum": False},
    }
    like = lambda tag: {
        "tracers": ["LRG_NGC", "ELG_NGC", "x_NGC"],
        "data": {t: {"path": f"data/{tag}_{t}_P.txt", "ls": [0, 2, 4] if t == "LRG_NGC" else [0, 2],
                     "kmin": 0.02, "kmax": [0.25, 0.25, 0.20] if t == "LRG_NGC" else 0.2}
                 for t in ("LRG_NGC", "ELG_NGC", "x_NGC")},
        "cov": {"path": f"data/cov_{tag}.txt", "rescale": 9, "Nreal": 1000},
        "chained": [False, True, False],
        "with_binning": [True, True, False],
        "marg": {"LRG_NGC_b3": {"scale": 2}, "ELG_NGC_c0": {"scale": 4}},
        "jeffreys": True,
    }
    params = {
        "omegabh2": {"value": 0.02214},
        "omegach2": {"prior": {"min": 0.05, "max": 0.25}, "ref": {"dist": "norm", "loc": 0.1189,
                                                                    "scale": 0.001}},
        "H0": {"prior": {"min": 40.0, "max": 100.0}, "ref": 67.77, "latex": "H_0"},
        "logA": {"prior": {"dist": "norm", "loc": 3.05, "scale": 0.1}, "ref": 3.0513},
        "nns": 0.9611,
        "As": {"value": "lambda logA: 1e-10*np.exp(logA)", "latex": "A_s"},
        "h100": "lambda H0: H0 / 100",
        "LRG_NGC_b1": {"prior": {"min": 0.0, "max": 4.0}, "ref": 2.3},
        "LRG_NGC_c2": {"prior": {"min": -4.0, "max": 4.0}, "ref": 0.8},
        "LRG_NGC_c4": 0.0,
        "LRG_NGC_b2": {"value": "lambda LRG_NGC_c2, LRG_NGC_c4: (LRG_NGC_c2 + LRG_NGC_c4) / np.sqrt(2.)"},
        "ELG_NGC_b1": {"prior": {"min": 0.0, "max": 4.0}, "ref": 1.3},
        "orphan": "lambda nowhere: 2 * nowhere",
        "sigma8": {"latex": r"\sigma_8"},
    }
    return {
        "theory": {"eftpipe.eftlss": {"cache_dir_path": "cache", "tracers": tracers}},
        "likelihood": {"NGC": like("NGC"), "SGC": like("SGC"), "sn.planck": None},
        "params": params,
        "sampler": {"mcmc": {"Rminus1_stop": 0.01}},
    }


def cobaya_cross_single():
    """One likelihood block over a cross tracer (tests/test_compat.py's
    cross YAML structure), scalar chained, window switched off."""
    info = cobaya_mixed()
    info["likelihood"] = {"x": {"tracers": ["LRG_NGC", "ELG_NGC", "x_NGC"],
                                "data": cobaya_mixed()["likelihood"]["NGC"]["data"],
                                "cov": "data/cov.txt", "chained": True}}
    info["theory"]["eftpipe.eftlss"]["tracers"]["ELG_NGC"]["with_window"] = False
    return info


@pytest.mark.parametrize("make, kwargs", [
    (cobaya_mixed, {}),
    (cobaya_mixed, dict(data_root="/data/eboss", cache_dir="/tmp/cache",
                        boltzmann={"name": "solver_emulator"})),
    (cobaya_cross_single, dict(data_root="ref")),
], ids=["mixed", "mixed-rooted", "cross"])
def test_convert_cobaya_config_matches_jax(make, kwargs):
    """Key by key: the port's conversion equals the JAX function's, warnings
    included (the orphan lambda and, in neither, the latex-only entry)."""
    src = make()
    with warnings.catch_warnings(record=True) as ours_warned:
        warnings.simplefilter("always")
        ours = convert_cobaya_config(src, **kwargs)
    with warnings.catch_warnings(record=True) as theirs_warned:
        warnings.simplefilter("always")
        theirs = jconvert(copy.deepcopy(src), **kwargs)
    assert ours == theirs
    assert src == make()  # the input is not modified
    assert [str(w.message) for w in ours_warned] == [str(w.message) for w in theirs_warned]
    assert any("orphan" in str(w.message) for w in ours_warned)
    params = ours["params"]
    assert params["h"] == {"prior": {"min": 0.4, "max": 1.0}, "ref": pytest.approx(0.6777)}
    assert params["As"] == {"value": "lambda ln10As: 1e-10 * np.exp(ln10As)"}
    assert params["h100"] == {"value": "lambda h: 100.0 * h / 100"}
    assert "sigma8" not in params and "orphan" not in params
    tracers = ours["theory"]["tracers"]
    assert tracers["x_NGC"]["cross"] == ["LRG_NGC", "ELG_NGC"]
    assert tracers["ELG_NGC"]["with_fiber"] == {"Dfc": 0.7, "fiberst": True}


def test_convert_cobaya_structure():
    """What ``tests/test_compat.py`` asserts of the reference YAMLs, on the
    in-test dict."""
    info = convert_cobaya_config(cobaya_mixed(), data_root="/ref")
    tracers = info["theory"]["tracers"]
    assert set(tracers) == {"default", "LRG_NGC", "ELG_NGC", "x_NGC"}
    lrg, elg = tracers["LRG_NGC"], tracers["ELG_NGC"]
    assert lrg["prefix"] == "LRG_NGC_" and lrg["z"] == 0.7 and lrg["with_APeffect"] == {"z_AP": 0.7}
    assert lrg["with_window"]["window_configspace_file"] == "/ref/data/window_LRG.dat"
    assert lrg["with_icc"]["icc_configspace_sn_file"] == "/ref/data/sn.dat"
    assert elg["basis"] == "eastcoast" and elg["with_RSD"] is True
    assert tracers["default"]["with_NNLO"] is True
    assert tracers["default"]["with_APeffect"] == {"Om_AP": 0.307, "rdrag_AP": 147.74}
    lk = info["likelihood"]
    assert set(lk) == {"NGC", "SGC"}
    ngc = lk["NGC"]
    assert ngc["chained"] == {"LRG_NGC": False, "ELG_NGC": True, "x_NGC": False}
    assert ngc["binned"] == {"LRG_NGC": True, "ELG_NGC": True, "x_NGC": False}
    assert ngc["cov"] == {"path": "/ref/data/cov_NGC.txt", "rescale": 9, "Nreal": 1000}
    assert ngc["data"]["LRG_NGC"]["kmax"] == [0.25, 0.25, 0.20]
    assert ngc["jeffreys"] is True and ngc["marg"]["LRG_NGC_b3"]["scale"] == 2
    assert info["params"]["ln10As"]["prior"] == {"dist": "norm", "loc": 3.05, "scale": 0.1}
    assert info["params"]["omega_cdm"]["ref"] == pytest.approx(0.1189)
    assert info["params"]["ns"] == pytest.approx(0.9611)
    with pytest.raises(ValueError, match="eftlss"):
        convert_cobaya_config({"theory": {"camb": {}}})


@pytest.mark.parametrize("expr", [
    "lambda logA: 1e-10*np.exp(logA)", "lambda H0, omegach2: omegach2 / (H0 / 100) ** 2",
    "lambda a, b: a + b", "0.5", "lambda ombh2: [ombh2, np.sqrt(ombh2)][1]",
])
def test_rename_lambda_args_matches_jax(expr):
    assert _rename_lambda_args(expr) == jrename(expr)


def test_convert_refuses_what_the_whitelist_refuses():
    """The one difference: a lambda outside the safe-expression whitelist
    is dropped with a warning where the JAX function keeps it."""
    src = cobaya_mixed()
    src["params"]["evil"] = "lambda h: __import__('os').getcwd()"
    with pytest.warns(UserWarning, match="evil"):
        ours = convert_cobaya_config(src)
    assert "evil" not in ours["params"]


def test_convert_reads_a_yaml_path(tmp_path):
    path = tmp_path / "run.yaml"
    path.write_text(yaml.safe_dump(cobaya_cross_single()))
    assert convert_cobaya_config(path) == jconvert(path)


# ----------------------------------------------------------------------
# a Cobaya-format run
# ----------------------------------------------------------------------
def write_cobaya_run(tmp_path, nrow=120):
    rng = np.random.default_rng(42)
    names = ["omega_cdm", "LRG_b1"]
    cols = (["weight", "minuslogpost"] + names
            + ["fsigma8_z", "minuslogprior", "chi2", "chi2__LEX_NGC", "LEX_NGC_fullchi2"])
    truth = np.array([0.12, 2.2])
    for i in (1, 2):
        x = truth[None, :] + 0.01 * rng.standard_normal((nrow, 2))
        chi2 = (((x - truth) / 0.01) ** 2).sum(axis=1)
        body = np.column_stack([
            rng.integers(1, 4, nrow), 0.5 * chi2, x[:, 0], x[:, 1],
            0.45 + 0.01 * rng.standard_normal(nrow), np.zeros(nrow), chi2, chi2, chi2 + 1.0])
        np.savetxt(tmp_path / f"run.{i}.txt", body, header=" ".join(cols), comments="# ")
    params_block = {
        "omega_cdm": {"prior": {"min": 0.05, "max": 0.2}, "ref": 0.12, "latex": r"\omega_c"},
        "LRG_b1": {"prior": {"min": 0.0, "max": 4.0}, "ref": 2.2},
        "h": {"value": 0.6777},
        "ns": {"value": 0.9649, "derived": False},
        "LRG_b2": {"value": "lambda LRG_c2: LRG_c2/1.414"},
        "fsigma8_z": {"derived": True, "latex": r"f\sigma_8"},
    }
    info = {"params": params_block, "output": "run",
            "likelihood": {"LEX_NGC": {"marg": {}}}}
    (tmp_path / "run.input.yaml").write_text(yaml.safe_dump(info))
    (tmp_path / "run.updated.yaml").write_text(yaml.safe_dump(info))
    (tmp_path / "launch.yaml").write_text(yaml.safe_dump(info))
    np.savetxt(tmp_path / "run.progress",
               np.array([[100, 1.0, 0.21, 3.0, 5.0], [200, 2.0, 0.24, 0.08, 0.3]]),
               header="N  timestamp  acceptance_rate  Rminus1  Rminus1_cl", comments="# ")
    (tmp_path / "run.minimum").write_text(
        "-log(Like) = 1.23\nchi-sq = 2.46\n\n"
        "   1  0.1201  omega_cdm  \\omega_c\n   2  2.1995  LRG_b1\n\n"
        "   3  0.4501  fsigma8_z  f\\sigma_8\n")
    return tmp_path / "run"


def test_from_cobaya_progress_and_fixed_params_match_jax(tmp_path):
    """The port's readers against the JAX ones on the same run, from each
    entry point and with burn-in: names, split, metadata, samples,
    statistics, progress history, fixed parameters and bestfit."""
    from eftpipe_tpu.analysis import ChainProducts as JChains
    from eftpipe_tpu_torch.analysis import ChainProducts

    prefix = write_cobaya_run(tmp_path)
    for src in (prefix, str(prefix), tmp_path / "run.updated.yaml",
                tmp_path / "run.input.yaml", tmp_path / "launch.yaml"):
        for burn in (0.0, 0.5):
            cp, jcp = ChainProducts.from_cobaya(src, burn_in=burn), JChains.from_cobaya(src, burn)
            assert cp.root == jcp.root
            assert cp.param_names == jcp.param_names == ["omega_cdm", "LRG_b1"]
            assert cp.derived_names == jcp.derived_names
            assert cp.meta == jcp.meta
            assert cp.samples.columns == list(jcp.samples.columns)
            np.testing.assert_array_equal(cp.samples.values, jcp.samples.to_numpy())
    assert cp.fixed_params() == jcp.fixed_params() == {"h": 0.6777, "ns": 0.9649}
    for stat in ("mean", "std"):
        got, want = getattr(cp, stat)(), getattr(jcp, stat)()
        assert list(got) == list(want.index)
        np.testing.assert_allclose(list(got.values()), want.to_numpy(), rtol=1e-12)
    np.testing.assert_allclose(cp.cov(), jcp.cov().to_numpy(), rtol=1e-12)
    assert cp.bestfit() == pytest.approx(jcp.bestfit().to_dict(), rel=1e-15)
    assert cp.global_bestfit() == pytest.approx(jcp.global_bestfit().to_dict(), rel=1e-15)
    prog, jprog = cp.progress(), jcp.progress()
    assert prog.columns == list(jprog.columns)
    np.testing.assert_array_equal(prog.values, jprog.to_numpy())
    assert prog["Rminus1"][-1] == pytest.approx(0.08)


def test_from_cobaya_refusals(tmp_path):
    from eftpipe_tpu_torch.analysis import ChainProducts

    with pytest.raises(FileNotFoundError):
        ChainProducts.from_cobaya(tmp_path / "none")
    np.savetxt(tmp_path / "bare.1.txt", np.ones((3, 4)))
    with pytest.raises(ValueError, match="header"):
        ChainProducts.from_cobaya(tmp_path / "bare")
    (tmp_path / "nooutput.yaml").write_text(yaml.safe_dump({"params": {}}))
    with pytest.raises(ValueError, match="output"):
        ChainProducts.from_cobaya(tmp_path / "nooutput.yaml")
    # no YAML beside the chains: the positional split
    cols = "weight minuslogpost a b"
    np.savetxt(tmp_path / "pos.1.txt", np.ones((3, 4)), header=cols, comments="# ")
    cp = ChainProducts.from_cobaya(tmp_path / "pos")
    assert cp.param_names == ["a", "b"] and cp.derived_names == [] and cp.fixed_params() == {}
    with pytest.raises(FileNotFoundError):
        cp.progress()


# ----------------------------------------------------------------------
# the transfer-emulator provider
# ----------------------------------------------------------------------
BOX_LO = np.array([0.020, 0.09, 0.60, 0.90])
BOX_HI = np.array([0.024, 0.15, 0.76, 1.02])


def write_transfer_emulator(path, seed=0, width=16, depth=2):
    """An emulator file in the JAX package's ``TransferEmulator.save``
    layout, written by that method from seeded NumPy weights: log T(k) is
    the EH98 transfer at the box's centre plus a small tanh MLP whose last
    layer is smooth in log k (no training)."""
    from eftpipe_tpu.boltzmann.eh98 import eh98_transfer
    from eftpipe_tpu.boltzmann.emulator import TransferEmulator as JTransfer

    rng = np.random.default_rng(seed)
    k = np.logspace(-4.0, 0.5, 120)
    x_mean, x_std = 0.5 * (BOX_LO + BOX_HI), (BOX_HI - BOX_LO) / np.sqrt(12.0)
    t_mid = np.asarray(eh98_transfer(jnp.asarray(k), x_mean[0], x_mean[0] + x_mean[1],
                                     x_mean[2])[0])
    u = (np.log(k) - np.log(k[0])) / (np.log(k[-1]) - np.log(k[0]))
    smooth = np.stack([np.cos(np.pi * j * u) for j in range(4)])  # (4, nk)
    sizes = [4] + [width] * depth
    params = [{"w": rng.standard_normal((a, b)) / np.sqrt(a), "b": 0.1 * rng.standard_normal(b)}
              for a, b in zip(sizes[:-1], sizes[1:])]
    params.append({"w": rng.standard_normal((width, 4)) / np.sqrt(width) @ smooth,
                   "b": np.zeros(k.size)})
    JTransfer(params=params, kgrid=k, x_mean=x_mean, x_std=x_std, y_mean=np.log(t_mid),
              y_std=np.full(k.size, 0.05)).save(path)
    return path


def emulator_params(seed, nw=5):
    rng = np.random.default_rng(seed)
    lo, hi = np.append(BOX_LO, 2.9), np.append(BOX_HI, 3.2)
    x = lo + (hi - lo) * rng.random((nw, 5))
    return dict(zip(("omega_b", "omega_cdm", "h", "ns", "ln10As"), x.T))


def emulator_inputs_both(path, cfg_kw, params, zeff=0.7, dtype=torch.float64):
    """(port, JAX) ``EmulatorProvider.inputs`` on the same file and points;
    the JAX provider maps one point, vmapped over the walkers."""
    from eftpipe_tpu.boltzmann.emulator import EmulatorProvider as JProvider
    from eftpipe_tpu.models.config import EFTConfig as JConfig
    from eftpipe_tpu_torch.boltzmann.emulator import EmulatorProvider
    from eftpipe_tpu_torch.models.config import EFTConfig as TConfig

    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    ours = EmulatorProvider.load(TConfig(**cfg_kw), zeff=zeff, path=path, om_fid=0.31)
    theirs = JProvider.load(JConfig(**cfg_kw), zeff=zeff, path=path, om_fid=0.31)
    got = ours.inputs({k: torch.as_tensor(v, dtype=dtype) for k, v in params.items()})
    want = jax.jit(jax.vmap(theirs.inputs))({k: jnp.asarray(v, jdt) for k, v in params.items()})
    return got, want


@pytest.mark.parametrize("zeff", [0.7, 1.1])
def test_emulator_provider_inputs_match_jax(tmp_path, zeff):
    """float64: P_lin on cfg.kin, f, q⊥, q∥ per walker, rtol 1e-12 (the
    linear interpolation in log k rounds a few ulp apart); float32 within
    1e-5 relative."""
    path = write_transfer_emulator(tmp_path / "emu.npz")
    params = emulator_params(seed=int(zeff * 10))
    got, want = emulator_inputs_both(path, dict(nkin=80, kin_max=0.9), params, zeff=zeff)
    for field in ("plin", "f", "qperp", "qpar"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=1e-12, err_msg=field)
    assert np.all(np.isfinite(got.plin.numpy())) and np.all(got.plin.numpy() > 0)
    got32, want32 = emulator_inputs_both(path, dict(nkin=80), params, zeff=zeff,
                                         dtype=torch.float32)
    assert got32.plin.dtype == torch.float32
    for field in ("plin", "f", "qperp", "qpar"):
        np.testing.assert_allclose(getattr(got32, field).numpy(),
                                   np.asarray(getattr(want32, field)), rtol=1e-5, err_msg=field)


def test_transfer_emulator_files_and_state_cross_over(tmp_path):
    """The port reads the JAX package's file and writes one the JAX package
    reads; ``convert.transfer_emulator_from_numpy`` carries the JAX object's
    fields; all give the JAX emulator's T(k) (rtol 1e-13)."""
    from eftpipe_tpu.boltzmann.emulator import TransferEmulator as JTransfer
    from eftpipe_tpu_torch.boltzmann.emulator import TransferEmulator, mlp_apply
    from eftpipe_tpu_torch.convert import transfer_emulator_from_numpy

    path = write_transfer_emulator(tmp_path / "emu.npz", seed=3)
    jemu = JTransfer.load(path)
    ours = TransferEmulator.load(path)
    x = np.column_stack([p for p in emulator_params(seed=4).values()][:4])
    want = np.asarray(jax.vmap(jemu)(jnp.asarray(x)))
    np.testing.assert_allclose(ours(torch.as_tensor(x)).numpy(), want, rtol=1e-13)
    ours.save(tmp_path / "again.npz")
    np.testing.assert_allclose(np.asarray(jax.vmap(JTransfer.load(tmp_path / "again.npz"))(
        jnp.asarray(x))), want, rtol=1e-13)
    carried = transfer_emulator_from_numpy(dict(
        params=jemu.params, kgrid=jemu.kgrid, x_mean=jemu.x_mean, x_std=jemu.x_std,
        y_mean=jemu.y_mean, y_std=jemu.y_std, input_names=jemu.input_names))
    np.testing.assert_allclose(carried(torch.as_tensor(x)).numpy(), want, rtol=1e-13)
    layers = [{k: torch.as_tensor(v) for k, v in layer.items()} for layer in jemu.params]
    from eftpipe_tpu.boltzmann.emulator import mlp_apply as jmlp

    xn = np.random.default_rng(5).standard_normal((3, 4))
    np.testing.assert_allclose(mlp_apply(layers, torch.as_tensor(xn)).numpy(),
                               np.asarray(jmlp(jemu.params, jnp.asarray(xn))), rtol=1e-13)
