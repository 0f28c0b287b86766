"""The port's host tools against the JAX package's on identical inputs: the
Kaiser fitter, the BAO/RSD conversions, the native parser and pair sums,
the effective redshift, the neutrino masses, the oracle bridge, the random
parameter draws; the profiling helpers on the lite flagship at narrow
widths; the CLI's ``zeff`` and ``plot-window``."""

import functools
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from eftpipe_tpu import native as jnative
from eftpipe_tpu.analysis import convert as jconv, kaiser as jkaiser, zeff as jzeff
from eftpipe_tpu.boltzmann import bridges as jbridges, neutrino as jneutrino
from eftpipe_tpu.models.config import EFTConfig as JConfig
from eftpipe_tpu.utils import tools as jtools
from eftpipe_tpu_torch import native as tnative
from eftpipe_tpu_torch.analysis import convert as tconv, kaiser as tkaiser, zeff as tzeff
from eftpipe_tpu_torch.boltzmann import bridges as tbridges, neutrino as tneutrino
from eftpipe_tpu_torch.models.config import EFTConfig as TConfig
from eftpipe_tpu_torch.utils import profiling, tools as ttools

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def randoms():
    """500 seeded random-catalogue points (RA, DEC, z, weight)."""
    rng = np.random.default_rng(3)
    n = 500
    return np.column_stack([rng.uniform(150, 160, n), rng.uniform(0, 8, n),
                            rng.uniform(0.6, 0.9, n), rng.uniform(0.5, 1.5, n)])


@pytest.fixture(scope="module")
def gxx():
    """Whether the native libraries can be built here (a compiler on PATH)."""
    return shutil.which("g++") is not None


def test_kaiser_matches_jax():
    rng = np.random.default_rng(1)
    k = np.linspace(0.01, 0.2, 30)
    plin = 2e4 * np.exp(-k / 0.1)
    for b1, f, c, shot in ((2.0, 0.8, 0.0, 0.0), (1.5, 0.7, 3.0, 500.0)):
        for a, b in zip(tkaiser.kaiser_multipoles(k, plin, b1, f, c=c, shot=shot),
                        jkaiser.kaiser_multipoles(k, plin, b1, f, c=c, shot=shot)):
            np.testing.assert_array_equal(a, b)
    p0, p2, _ = jkaiser.kaiser_multipoles(k, plin, 2.1, 0.75, c=1.0, shot=200.0)
    noise = rng.standard_normal((2, k.size)) * 5.0
    fits = [mod.KaiserModel(k, plin, 0.75).fit(p0 + noise[0], p2 + noise[1])
            for mod in (tkaiser, jkaiser)]
    assert fits[0] == fits[1]
    assert abs(fits[0]["b1"] - 2.1) < 0.05


def test_lss_convertor_matches_jax():
    for om, z in ((0.31, 0.7), (0.25, 1.5)):
        assert tconv.hubble(om, z) == jconv.hubble(om, z)
        assert tconv.comoving_distance(om, z) == jconv.comoving_distance(om, z)
        assert tconv.growth_factor(om, z) == jconv.growth_factor(om, z)
        assert tconv.growth_rate(om, z) == jconv.growth_rate(om, z)
    a = tconv.LssConvertor(om_fid=0.31, h_fid=0.676, rdrag_fid=147.8, z=0.7)
    b = jconv.LssConvertor(om_fid=0.31, h_fid=0.676, rdrag_fid=147.8, z=0.7)
    al = np.array([0.98, 1.0, 1.03])
    for name in ("dh_fid", "dm_fid", "dv_fid"):
        assert getattr(a, name) == getattr(b, name)
    np.testing.assert_array_equal(a.dv_over_rd(al, al[::-1]), b.dv_over_rd(al, al[::-1]))
    np.testing.assert_array_equal(a.fsigma8(al, 0.6), b.fsigma8(al, 0.6))
    np.testing.assert_array_equal(a.sigma8_z(0.8), b.sigma8_z(0.8))


def test_native_loadtxt_and_pair_sums_match_jax(tmp_path, randoms, gxx):
    path = tmp_path / "table.txt"
    np.savetxt(path, randoms, header="ra dec z w")
    np.testing.assert_array_equal(tnative.loadtxt(path), jnative.loadtxt(path))
    np.testing.assert_allclose(tnative.loadtxt(path), np.loadtxt(path), rtol=1e-15)
    if gxx:
        assert tnative.available()
        lib = next((ROOT / "build" / "eftpipe_tpu_torch").glob("libpanelio_*.so"), None)
        assert lib is not None  # built beside the package, not next to its source
        assert not list((ROOT / "eftpipe_tpu_torch" / "native").glob("*.so"))
    x, y, z = (randoms[:, i] * 10.0 for i in range(3))
    got = tnative.pair_zeff(x, y, z, randoms[:, 2], randoms[:, 3], smin=25.0, smax=150.0)
    want = jnative.pair_zeff(x, y, z, randoms[:, 2], randoms[:, 3], smin=25.0, smax=150.0)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    rows = np.array([[l1, l2, s1, s2, l1 + 10 * l2 + 100 * s1 + 1000 * s2]
                     for l1 in (0, 2) for l2 in (0, 2, 4) for s1 in (1.0, 2.0) for s2 in (5.0, 6.0)])
    a, ma = tnative.panel_to_ndarray(rows[::-1].copy())
    b, mb = jnative.panel_to_ndarray(rows[::-1].copy())
    np.testing.assert_array_equal(a, b)
    assert all(np.array_equal(ma[key], mb[key]) for key in mb)


def test_effective_redshift_matches_jax(randoms):
    args = (randoms[:, 0], randoms[:, 1], randoms[:, 2])
    for kw in (dict(weight=randoms[:, 3]), dict(omegam=0.28, smin=10.0, smax=400.0)):
        got = tzeff.effective_redshift(*args, **kw)
        assert got == pytest.approx(jzeff.effective_redshift(*args, **kw), rel=1e-12)
        assert 0.6 < got < 0.9
    np.testing.assert_array_equal(tzeff.ComovingDistance(0.31)(randoms[:, 2]),
                                  jzeff.ComovingDistance(0.31)(randoms[:, 2]))


def test_neutrino_masses_match_jax():
    for mnu, hier in ((0.06, "normal"), (0.12, "inverted"), (0.3, "degenerate"), (0.0, "normal")):
        assert tneutrino.get_masses(mnu, hier) == jneutrino.get_masses(mnu, hier)
        assert tneutrino.neutrino_boltzmann_args(mnu, hier) == \
            jneutrino.neutrino_boltzmann_args(mnu, hier)
    assert tneutrino.minimal_mass_sum("inverted") == jneutrino.minimal_mass_sum("inverted")
    with pytest.raises(ValueError):
        tneutrino.get_masses(0.01, "normal")


class _FakeOracle:
    """A host 'Boltzmann code': a smooth spectrum with the parameters in it."""

    def compute(self, params, z):
        kh = np.logspace(-4, 0.5, 200)
        pkh = 2e4 * params["h"] * kh / (1 + (kh / 0.02) ** 2.3) * np.exp(params["ln10As"] - 3.0)
        return dict(kh=kh, pkh=pkh, f=0.5 + params["omega_cdm"], e=1.0 + z * params["h"],
                    da=0.5 + 0.1 * z, h=params["h"], rdrag=147.0, sigma8_z=0.6)


def test_oracle_provider_matches_jax(monkeypatch):
    names = ("omega_cdm", "h", "ln10As")
    rows = [dict(zip(names, v)) for v in ((0.12, 0.68, 3.04), (0.14, 0.7, 3.0), (0.1, 0.65, 3.1))]
    tprov = tbridges.OracleProvider(TConfig(), 0.7, _FakeOracle(), da_fid=0.6, h_fid=1.4)
    jprov = jbridges.OracleProvider(JConfig(), 0.7, _FakeOracle(), da_fid=0.6, h_fid=1.4)
    want = jprov.tabulate(rows)
    batch = {n: torch.tensor([r[n] for r in rows], dtype=torch.float32) for n in names}
    got = tprov.inputs(batch)
    assert got.plin.shape == (3, TConfig().kin.size) and got.plin.dtype == torch.float32
    tab = tprov.tabulate(rows)
    for field in ("plin", "f", "qperp", "qpar"):
        np.testing.assert_allclose(getattr(tab, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=1e-12)
        # float32 inputs: the same host run of each float32-rounded walker
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=1e-5)
    for oracle in (tbridges.ClassyOracle, tbridges.CambOracle):
        with pytest.raises(ImportError):
            oracle()
    # training on the oracle: the targets the transfer emulator is fit on
    # are the JAX function's (both trainers captured, not run)
    from eftpipe_tpu.boltzmann import emulator as jemu
    from eftpipe_tpu_torch.boltzmann import emulator as temu

    caught = {}
    k = np.logspace(-3, 0, 12)
    bounds = {"omega_cdm": (0.1, 0.14), "h": (0.6, 0.7), "ln10As": (3.0, 3.1), "ns": (0.94, 0.99)}
    for side, mod, bridges in (("jax", jemu, jbridges), ("port", temu, tbridges)):
        monkeypatch.setattr(mod, "train_transfer_emulator",
                            lambda kg, side=side, **kw: caught.setdefault(side, (kg, kw)))
        bridges.train_emulator_from_oracle(_FakeOracle(), 0.7, k, bounds, steps=7)
    (jk, jkw), (tk, tkw) = caught["jax"], caught["port"]
    np.testing.assert_array_equal(tk, jk)
    assert tkw["bounds"] == jkw["bounds"] and tkw["steps"] == jkw["steps"] == 7
    for row in ([0.12, 0.68, 3.04, 0.96], [0.14, 0.61, 3.09, 0.95]):
        np.testing.assert_allclose(tkw["oracle"](np.array(row)), jkw["oracle"](np.array(row)),
                                   rtol=1e-14)


def test_random_params_from_covmat_match_jax(tmp_path):
    path = tmp_path / "chain.covmat"
    cov = np.array([[0.04, 0.01, 0.0], [0.01, 0.09, 0.02], [0.0, 0.02, 0.01]])
    np.savetxt(path, cov, header="omega_cdm h LRG_b1")
    mean = {"omega_cdm": 0.12, "h": 0.68, "LRG_b1": 2.0}
    a = ttools.RandomParams.from_covmat_file(path, mean=mean, seed=4)
    b = jtools.RandomParams.from_covmat_file(path, mean=mean, seed=4)
    assert a.names == b.names == list(mean)
    np.testing.assert_array_equal(a.cov, b.cov)
    assert a.draw(5) == b.draw(5)
    assert a.draw() == b.draw()
    assert ttools.group_lists([3, 1], [2, 1]) == jtools.group_lists([3, 1], [2, 1])


@pytest.fixture(scope="module")
def lite_narrow(tmp_path_factory):
    """The lite flagship (no window, Eisenstein-Hu cosmology) at narrow loop
    widths, float64, plain quadratic forms, on the CPU."""
    import eftpipe_tpu_torch.api.flagship as tflag

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tflag, "EFTConfig", functools.partial(TConfig, nfft_loop=64, nkin=80))
        yield tflag.build_flagship(tmp_path_factory.mktemp("lite_narrow"), dtype=torch.float64,
                                   device="cpu", with_window=False, cosmology="eh98",
                                   quadform="plain")


def test_stage_prefixes_and_timer_on_the_lite_flagship(lite_narrow):
    model = lite_narrow
    rng = np.random.default_rng(6)
    theta0 = np.asarray(model.theta0, np.float64)
    thetas = torch.as_tensor(theta0[None] * (1 + 1e-3 * rng.standard_normal((3, theta0.size))))
    fns = profiling.likelihood_stage_prefixes(model.providers, {"like": model.like},
                                              model.params_dict, torch.float64)
    assert list(fns) == ["cosmo", "nonlinear", "IRresum", "APeffect", "png_pg", "logp"]
    vals = {stage: fn(thetas) for stage, fn in fns.items()}
    for stage, v in vals.items():
        assert v.shape == (3,) and torch.isfinite(v).all(), stage
    # the last prefix is the cosmology checksum plus the log-posterior
    torch.testing.assert_close(vals["logp"] - vals["cosmo"], model.logp(thetas),
                               rtol=1e-12, atol=1e-9)
    times = {}
    with profiling.stage_timer(times, "logp"):
        model.logp(thetas)
    with profiling.stage_timer(times, "logp"):
        model.logp(thetas)
    assert set(times) == {"logp"} and times["logp"] > 0.0
    prof = profiling.run_stage_profile(fns, lambda: [thetas, thetas], batch=3, iters=2)
    assert list(prof["stage_us_per_eval"]) == list(fns)
    assert all(v > 0 for v in prof["prefix_us_per_eval"].values())


def test_cli_zeff_and_plot_window(tmp_path, randoms, capsys):
    from eftpipe_tpu_torch.cli import main

    table = tmp_path / "randoms.txt"
    np.savetxt(table, randoms)
    assert main(["zeff", str(table), "--subsample", "300"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rng = np.random.default_rng(0)
    idx = rng.choice(randoms.shape[0], 300, replace=False)
    want = jzeff.effective_redshift(randoms[idx, 0], randoms[idx, 1], randoms[idx, 2],
                                    weight=randoms[idx, 3])
    assert got == {"zeff": round(float(want), 6), "npoints": 300}
    assert main(["bench"]) == 2
    assert "benchmark" in capsys.readouterr().err
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        pytest.skip("matplotlib is not installed: plot-window needs it")
    from eftpipe_tpu_torch.api.flagship import synthetic_mask_file

    mask = tmp_path / "mask.txt"
    synthetic_mask_file(str(mask), 300.0)
    png = tmp_path / "window.png"
    assert main(["plot-window", str(mask), "-o", str(png), "--nmax", "256"]) == 0
    assert png.stat().st_size > 0
