"""The port's survey window (configuration-space window and precomputed
window matrix) against the JAX package's on identical NumPy inputs, float64,
and against the committed goldens: host tables ≤ 1e-12 relative, the
per-evaluation convolution on a seeded walker batch at rtol 1e-10."""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from eftpipe_tpu.models import window as jw
from eftpipe_tpu.models.bird import BirdState as JBird
from eftpipe_tpu.models.config import EFTConfig as JConfig
from eftpipe_tpu_torch.models import window as tw
from eftpipe_tpu_torch.models.bird import BirdState as TBird
from eftpipe_tpu_torch.models.config import EFTConfig as TConfig
from eftpipe_tpu_torch.models.pipeline import CosmoInputs, TracerPipeline

from test_window_matrix import KIN, PLIN, F, florian_matrix  # noqa: F401  (fixture)

GOLDENS = __import__("pathlib").Path(__file__).parent / "goldens"
TABLE_RTOL = 1e-12
W = 3


def assert_rel(got, want, rtol=TABLE_RTOL, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max(),
                               err_msg=name)


def seeded_bird(cfg, seed=0, w=W):
    """A walker batch of P-side fields (and zero CF side) from a seed, as
    NumPy arrays keyed by BirdState field."""
    rng = np.random.default_rng(seed)
    nl, nk, ns = cfg.nl, cfg.nk, cfg.ns
    shapes = dict(f=(w,), p11l=(w, nl, 3, nk), ploopl=(w, nl, 12, nk), pctl=(w, nl, 6, nk),
                  pct_nnlo_l=(w, nl, 3, nk), pstl=(w, nl, 3, nk), picc=(w, nl, nk),
                  c11=(w, nl, ns), cct=(w, nl, ns), cct_nnlo=(w, nl, ns),
                  cloopl=(w, nl, 12, ns))
    return {k: rng.standard_normal(s).cumsum(axis=-1) for k, s in shapes.items()}


def both_birds(fields):
    return (JBird(**{k: jnp.asarray(v) for k, v in fields.items()}),
            TBird(**{k: torch.as_tensor(v) for k, v in fields.items()}))


@pytest.fixture(scope="module")
def win_source(tmp_path_factory):
    """The LRG NGC configuration-space window multipoles of the golden."""
    path = tmp_path_factory.mktemp("windata") / "win_NGC_LRG.txt"
    np.savetxt(path, np.load(GOLDENS / "window_input_lrg_ngc.npz")["table"])
    return path


@pytest.fixture(scope="module")
def tables(win_source):
    """Both packages' window tables at the golden's settings (nl=2, nmax=4096)."""
    tab = tw.build_window_tables(TConfig(nl=2, no=2), window_configspace_file=win_source)
    jtab = jw.build_window_tables(JConfig(nl=2, no=2), window_configspace_file=win_source)
    return tab, jtab


def test_window_kgrid_matches_jax_and_golden():
    gold = np.load(GOLDENS / "window_kgrid.npz")
    for (kmax, acc), key in (((0.3, 1), "g1"), ((0.25, 2), "g2")):
        np.testing.assert_array_equal(tw.window_kgrid(kmax, acc), jw.window_kgrid(kmax, acc))
        np.testing.assert_allclose(tw.window_kgrid(kmax, acc), gold[key], rtol=1e-15)
    np.testing.assert_array_equal(tw.CALQ, jw.CALQ)


def test_window_tables_match_jax_and_golden(tables):
    tab, jtab = tables
    for key in ("wal", "wmat", "p"):
        assert_rel(tab[key], jtab[key], name=key)
    assert tab["meta"] == jtab["meta"] and (tab["na"], tab["nl"]) == (jtab["na"], jtab["nl"])
    gold = np.load(GOLDENS / "window_wal_convolution.npz")
    np.testing.assert_allclose(tab["wal"], gold["wal"], rtol=1e-6,
                               atol=1e-9 * np.abs(gold["wal"]).max())
    p_in = np.random.default_rng(7).normal(size=(2, 4, 50)).cumsum(axis=-1)
    got = torch.einsum("alkj,...lnj->...ank", torch.as_tensor(tab["wmat"]),
                       torch.as_tensor(p_in)[None]).numpy()[0]
    np.testing.assert_allclose(got, gold["conv"], rtol=1e-5,
                               atol=1e-7 * np.abs(gold["conv"]).max())


def test_window_cache_roundtrip_and_key(tmp_path, win_source):
    """Same settings → the same cache file name as the JAX package, with the
    settings inside; the second build loads it bit for bit."""
    cfg = TConfig(nl=2, no=2)
    kw = dict(window_configspace_file=win_source, nmax=512)
    wt1 = tw.build_window_tables(cfg, cache_dir=tmp_path / "t", **kw)
    jw.build_window_tables(JConfig(nl=2, no=2), cache_dir=tmp_path / "j", **kw)
    names = sorted(p.name for p in (tmp_path / "t").glob("window_*.npz"))
    assert names and names == sorted(p.name for p in (tmp_path / "j").glob("window_*.npz"))
    with np.load(tmp_path / "t" / names[0]) as z:
        assert json.loads(str(z["meta"])) == wt1["meta"]
    wt2 = tw.build_window_tables(cfg, cache_dir=tmp_path / "t", **kw)
    np.testing.assert_array_equal(wt2["wal"], wt1["wal"])
    np.testing.assert_array_equal(wt2["wmat"], wt1["wmat"])


def test_window_fourier_file_roundtrip_and_drift(tmp_path, tables, win_source):
    tab, _ = tables
    cfg = TConfig(nl=2, no=2)
    np.save(tmp_path / "wal.npy", tab["wal"])
    assert_rel(tw.build_window_tables(cfg, window_fourier_file=tmp_path / "wal.npy")["wmat"],
               tab["wmat"])
    # the _Nl{nl} retry when the primary file has another nl
    wrong = np.zeros((tab["wal"].shape[0], tab["wal"].shape[1] + 1) + tab["wal"].shape[2:])
    np.save(tmp_path / "w2.npy", wrong)
    np.save(tmp_path / f"w2_Nl{cfg.nl}.npy", tab["wal"])
    assert_rel(tw.build_window_tables(cfg, window_fourier_file=tmp_path / "w2.npy")["wmat"],
               tab["wmat"])
    # inconsistent (na, nl) and grids raise
    np.save(tmp_path / "bad.npy", tab["wal"][:1])
    with pytest.raises(tw.MetaInfoError, match="does not match"):
        tw.build_window_tables(cfg, window_fourier_file=tmp_path / "bad.npy")
    with pytest.raises(tw.MetaInfoError, match="grids"):
        tw.build_window_tables(cfg, window_fourier_file=tmp_path / "wal.npy", accboost=2)

    # a suffix-less path: computed, written back with its JSON sidecar, loaded
    bare = tmp_path / "walcache"
    wt1 = tw.build_window_tables(cfg, window_fourier_file=bare,
                                 window_configspace_file=win_source, nmax=512)
    assert (tmp_path / "walcache.npy").exists() and (tmp_path / "walcache.json").exists()
    wt2 = tw.build_window_tables(cfg, window_fourier_file=bare, nmax=512)
    np.testing.assert_array_equal(wt2["wal"], wt1["wal"])
    # the sidecar records nmax=512: other settings are drift, as in the JAX package
    with pytest.raises(tw.MetaInfoError, match="inconsistent"):
        tw.build_window_tables(cfg, window_fourier_file=bare, nmax=1024)
    with pytest.raises(jw.MetaInfoError, match="inconsistent"):
        jw.build_window_tables(JConfig(nl=2, no=2), window_fourier_file=bare, nmax=1024)


@pytest.mark.parametrize("with_icc", [False, True], ids=["window", "window+icc"])
def test_apply_window_matches_jax(tables, with_icc):
    """One einsum per field on a seeded walker batch; with the integral
    constraint coupled, W − W_icc and the P_icc shot-noise column."""
    tab, jtab = tables
    cfg = TConfig(nl=2, no=2)
    if with_icc:
        rng = np.random.default_rng(11)
        icc = dict(wmat=1e-2 * rng.standard_normal(tab["wmat"].shape),
                   psn=rng.standard_normal((2, cfg.nk)))
        tab, jtab = dict(tab, icc=icc), dict(jtab, icc=icc)
    jbird, tbird = both_birds(seeded_bird(cfg))
    want = jax.vmap(lambda b: jw.apply_window(jtab, JConfig(nl=2, no=2), b))(jbird)
    got = tw.apply_window(tw.window_tables_to(tab, "cpu", torch.float64), cfg, tbird)
    for field in want._fields:
        assert_rel(getattr(got, field).numpy(), getattr(want, field), rtol=1e-10, name=field)
    assert not np.allclose(got.p11l.numpy(), tbird.p11l.numpy())
    if not with_icc:
        np.testing.assert_array_equal(got.picc.numpy(), tbird.picc.numpy())


def test_window_matrix_matches_jax_and_goldens(florian_matrix):  # noqa: F811
    matrix = np.loadtxt(florian_matrix)
    sel = dict(in_ells=(0, 2, 4), in_kmin=0.0, in_kmax=0.4, in_nbins=400,
               out_ells=(0, 1, 2, 3, 4), out_kmin=0.0, out_kmax=0.4, out_nbins=40,
               sel_in_ells=(0, 2), sel_in_kmax=0.3, sel_out_ells=(0, 2),
               sel_out_kmin=0.02, sel_out_kmax=0.18)
    np.testing.assert_array_equal(tw.rearrange_window_matrix(matrix, **sel),
                                  np.load(GOLDENS / "window_matrix_rearrange.npz")["expected"])

    kw = dict(path=florian_matrix, ells=[0, 2], kmin=0.01, kmax=0.2, window_st=True)
    cfg = TConfig(nl=3, no=3)
    wmt = tw.build_window_matrix_tables(cfg, **kw)
    jwmt = jw.build_window_matrix_tables(JConfig(nl=3, no=3), **kw)
    assert_rel(wmt["wmat"], jwmt["wmat"], name="wmat")
    assert (wmt["na"], wmt["nl"], wmt["window_st"]) == (jwmt["na"], jwmt["nl"], True)

    # the golden: the window matrix applied after the loop engine at W=1
    pipe = TracerPipeline.build(cfg, with_irresum=False, window_matrix=kw, device="cpu")
    inputs = CosmoInputs(plin=torch.as_tensor(PLIN)[None], f=torch.tensor([F], dtype=torch.float64),
                         qperp=torch.ones(1, dtype=torch.float64),
                         qpar=torch.ones(1, dtype=torch.float64))
    assert np.allclose(pipe.cfg.kin, KIN)
    bird = pipe.compute_bird(inputs)
    gold = np.load(GOLDENS / "window_matrix_convolved.npz")
    for ref_name, name in (("P11l", "p11l"), ("Ploopl", "ploopl"), ("Pctl", "pctl"),
                           ("Pstl", "pstl")):
        a = gold[ref_name]
        np.testing.assert_allclose(getattr(bird, name).numpy()[0], a, rtol=5e-6,
                                   atol=1e-8 * np.abs(a).max(), err_msg=ref_name)
    assert bird.picc.shape == (1, 2, gold["P11l"].shape[-1]) and not bird.picc.any()

    # and against the JAX function on a seeded batch
    jbird, tbird = both_birds(seeded_bird(cfg, seed=3))
    want = jax.vmap(lambda b: jw.apply_window_matrix(jwmt, JConfig(nl=3, no=3), b))(jbird)
    got = tw.apply_window_matrix(tw.window_matrix_tables_to(wmt, "cpu", torch.float64),
                                 cfg, tbird)
    for field in want._fields:
        assert_rel(getattr(got, field).numpy(), getattr(want, field), rtol=1e-10, name=field)


def test_window_options_and_errors(win_source):
    cfg = TConfig(nl=2, no=2)
    with pytest.raises(ValueError, match="exceed"):
        tw.build_window_tables(cfg, window_configspace_file=win_source, na=3)
    with pytest.raises(ValueError, match="required"):
        tw.build_window_tables(cfg)
    # na < nl, no mask, window_st off: the same tables as the JAX package
    kw = dict(window_configspace_file=win_source, na=1, withmask=False, window_st=False,
              nmax=512, accboost=2)
    tab = tw.build_window_tables(cfg, **kw)
    jtab = jw.build_window_tables(JConfig(nl=2, no=2), **kw)
    assert_rel(tab["wmat"], jtab["wmat"], name="wmat")
    assert tab["wmat"].shape[:2] == (1, 2) and tab["window_st"] is False
    jbird, tbird = both_birds(seeded_bird(cfg, seed=5))
    got = tw.apply_window(tw.window_tables_to(tab, "cpu", torch.float64), cfg, tbird)
    np.testing.assert_array_equal(got.pstl.numpy(), tbird.pstl.numpy())
    assert got.p11l.shape == (W, 1, 3, cfg.nk)
    # the dotted builder extension point resolves the builder it names
    dotted = TracerPipeline.build(
        cfg, window=dict(kw, builder="eftpipe_tpu_torch.models.window.build_window_tables"),
        device="cpu")
    np.testing.assert_array_equal(dotted.wt["wmat"].numpy(), tab["wmat"])
