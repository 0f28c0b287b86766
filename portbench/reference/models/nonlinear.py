"""One-loop engine: FFTLog of P_lin → P22/P13 and CF-side transforms
(counterpart of ``eftpipe_tpu/models/nonlinear.py``).

Phase A (``nonlinear_tables_numpy``) assembles, on the host in complex128,
the constant tensors of the FFT-PT formalism — the analogue of upstream
``NonLinear`` (pybird/pybird.py:870-1064) — fusing wherever a contraction is
linear in the FFTLog coefficients:

* ``a13[n, b, k]`` = k³ · k^{ν_n} · M13_{b,n}   →  P13 = P11 · Re[c @ a13]
* ``a11 / act / act_nnlo[n, l, s]`` = s-powers · MPC moments (incl. the s⁻²
  and s⁻⁴ counterterm factors)                  →  one real matvec each
* ``kpow22[n, k]`` = k^{ν_n + 3/2}, ``m22[b, n, m]`` → P22 quadratic form
* ``mcf22/mcf13[b, l, n, m]`` = Bessel-moment matrices times the loop
  matrices (pybird.py:1040-1046)                → CF quadratic forms

Both quadratic forms are Hermitian-folded to real matrices on 2·nc−1 dofs
(``ops/quadform.py``).  ``build_nonlinear_tables`` moves the tables to the
device once.  Phase B (``nonlinear_pscf``) runs on tensors with a leading
walker axis: one FFTLog (two real matmuls) plus the contractions above, the
two quadratic forms as plain einsums.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np

from .. import to_device
from ..ops import cplx
from ..ops.fftlog import HostFFTLog, make_plan, fftlog_coef
from ..ops.quadform import herm_fold, herm_w, qf_real_plain, trim_nyquist
from ..tables.loop_matrices import m13_matrices, m22_matrices, mpc
from ..utils.io import atomic_save_npz
from .config import EFTConfig


def _loop_fft(cfg: EFTConfig) -> HostFFTLog:
    # upstream fftsettings: pybird.py:919
    return HostFFTLog(n=cfg.nfft_loop, xmin=1.5e-5, xmax=1000.0, bias=-1.6)


_TABLE_MEMO: dict[tuple, dict] = {}


def _memo_key(cfg: EFTConfig) -> tuple:
    """The fields that enter the tables: the FFTLog settings and the k/s/kin
    grids (not km/kr/nd, which only scale the bias contraction)."""
    return (cfg.nl, cfg.kmax, cfg.optiresum, cfg.ir_cutoff, cfg.k_ir,
            cfg.nfft_loop, cfg.kin_min, cfg.kin_max, cfg.nkin)


def _cache_file(cache_dir, stem: str, key: tuple) -> Path:
    digest = hashlib.sha256(repr(key).encode()).hexdigest()[:16]
    return Path(cache_dir) / f"{stem}_{digest}.npz"


def nonlinear_tables_numpy(cfg: EFTConfig, cache_dir=None) -> dict:
    """Host-side constant tensors of the loop engine (complex128/float64).

    Memoized on the fields that enter the tables, so a multi-tracer build
    computes the fold tensors once.  With ``cache_dir`` the two expensive
    fold tensors also persist across processes (uncompressed npz,
    hash-keyed)."""
    memo_key = _memo_key(cfg)
    if memo_key in _TABLE_MEMO:
        return dict(_TABLE_MEMO[memo_key])
    fold_cache = None
    if cache_dir is not None:
        fold_cache = _cache_file(cache_dir, "loopfold", ("dense",) + memo_key)
    fft = _loop_fft(cfg)
    kin = cfg.kin
    # FFTLog plans; IR-cutoff modes truncate the input grid below k_ir and
    # switch the low end to zero-padding (pybird.py:1127-1160)
    plan_full = make_plan(fft, kin, extrap="extrap", window=0.2)
    if cfg.ir_cutoff:
        idx = int(np.searchsorted(kin, cfg.k_ir))
        plan_cut = make_plan(fft, kin[idx:], extrap=("padding", "extrap"), window=0.2)
        kin_cut_index = idx
    else:
        plan_cut = None
        kin_cut_index = 0
    if cfg.ir_cutoff == "all":
        plan_pk = plan_cf = plan_cut
    elif cfg.ir_cutoff == "loop":
        plan_pk, plan_cf = plan_cut, plan_full
    elif cfg.ir_cutoff == "resum":
        plan_pk, plan_cf = plan_full, plan_cut
    else:
        plan_pk = plan_cf = plan_full

    pw = fft.pow  # (n+1,) complex exponents
    ns = -0.5 * pw
    k = cfg.k
    s = cfg.s
    ells = 2 * np.arange(cfg.nl)

    m13 = m13_matrices(pw)  # (10, n+1)

    kpow = k[None, :] ** pw[:, None]  # (n+1, nk)
    kpow22 = k[None, :] ** (pw[:, None] + 1.5)  # k³ split across both factors
    a13 = np.einsum("nk,bn->nbk", kpow * k[None, :] ** 3, m13)

    spow = s[None, :] ** (-pw[:, None] - 3.0)  # (n+1, ns)
    mcf11 = mpc(ells[:, None], ns[None, :])  # (nl, n+1)
    mcfct = mpc(ells[:, None], ns[None, :] - 1.0)
    mcfct_nnlo = mpc(ells[:, None], ns[None, :] - 2.0)
    a11 = np.einsum("ns,ln->nls", spow, mcf11)
    act = np.einsum("ns,ln->nls", spow * s[None, :] ** -2.0, mcfct)
    act_nnlo = np.einsum("ns,ln->nls", spow * s[None, :] ** -4.0, mcfct_nnlo)

    # Hermitian fold: the quadratic-form matrices act on the independent REAL
    # dofs of the rfft coefficients.  The spectral window (0.2 taper) sends
    # the ±Nyquist coefficients to EXACTLY zero, so those two dofs are
    # dropped: 2·nc−1 = 255 dofs at the default nfft_loop = 256.
    n1 = pw.size
    nl = len(ells)
    nc = n1 // 2
    n22, n13 = cfg.n22, cfg.n13
    m22_fold = mcf_fold = None
    if fold_cache is not None and fold_cache.exists():
        with np.load(fold_cache) as z:
            m22_fold, mcf_fold = z["m22_fold"], z["mcf_fold"]
        if m22_fold.shape[0] != n22 or mcf_fold.shape[0] != (n22 + n13) * nl:
            m22_fold = mcf_fold = None  # stale layout: recompute
    if mcf_fold is None:
        m22 = m22_matrices(pw)  # (28, n+1, n+1)
        # Bessel moments for the loop CF: Ml[l,n,m] = MPC(2l, ns_n+ns_m-3/2)
        ml = mpc(ells[:, None, None],
                 ns[None, :, None] + ns[None, None, :] - 1.5)
        m22_fold = trim_nyquist(herm_fold(m22), nc)
        # the (b, l) CF matrices go straight into one preallocated block
        mcf_all = np.empty(((n22 + n13) * nl, n1, n1), dtype=complex)
        np.multiply(m22[:, None], ml[None, :],
                    out=mcf_all[: n22 * nl].reshape(n22, nl, n1, n1))
        np.multiply(m13[:, None, :, None], ml[None, :],
                    out=mcf_all[n22 * nl:].reshape(n13, nl, n1, n1))
        mcf_fold = trim_nyquist(herm_fold(mcf_all), nc)
        if fold_cache is not None:
            atomic_save_npz(fold_cache, m22_fold=m22_fold, mcf_fold=mcf_fold)
    # the trim is exact only because the tapered DFT zeroes c_{±N/2}
    for plan in {id(plan_pk): plan_pk, id(plan_cf): plan_cf}.values():
        assert not plan.gre[:, 0].any() and not plan.gre[:, -1].any()
        assert not plan.gim[:, 0].any() and not plan.gim[:, -1].any()

    def half(x):
        # n ∈ [nc, 2nc) — the Nyquist row (exactly-zero coefficient) dropped
        r, i = cplx.split(x)
        return r[nc:-1], i[nc:-1]

    tables = dict(
        plan_pk=plan_pk,
        plan_cf=plan_cf,
        kin_cut_index=kin_cut_index,
        kpow22_half=half(kpow22),
        a13=cplx.split(a13),
        a11=cplx.split(a11),
        act=cplx.split(act),
        act_nnlo=cplx.split(act_nnlo),
        m22_fold=m22_fold,
        mcf_fold=mcf_fold,
        n22=n22,
        n13=n13,
        spow_half=half(spow),
        nc=nc,
        k=k,
        s=s,
    )
    _TABLE_MEMO[memo_key] = tables
    return nonlinear_tables_numpy(cfg, cache_dir)


def nonlinear_tables_to(tables: dict, device, dtype) -> dict:
    """Move host tables to the device; ``plan_cf`` stays the SAME object as
    ``plan_pk`` when they were one plan (one FFTLog per evaluation then)."""
    shared = tables["plan_cf"] is tables["plan_pk"]
    out = to_device(tables, device, dtype)
    if shared:
        out["plan_cf"] = out["plan_pk"]
    return out


def build_nonlinear_tables(cfg: EFTConfig, device, dtype, cache_dir=None) -> dict:
    return nonlinear_tables_to(nonlinear_tables_numpy(cfg, cache_dir), device, dtype)


def _coefs(nt: dict, cfg: EFTConfig, plin_kin):
    icut = nt["kin_cut_index"]
    f_cut = plin_kin[..., icut:] if icut else plin_kin
    coef_pk = fftlog_coef(nt["plan_pk"], f_cut if cfg.ir_cutoff in ("all", "loop") else plin_kin)
    if nt["plan_cf"] is nt["plan_pk"]:
        coef_cf = coef_pk
    else:
        coef_cf = fftlog_coef(nt["plan_cf"], f_cut if cfg.ir_cutoff == "resum" else plin_kin)
    return coef_pk, coef_cf


def nonlinear_pscf(nt: dict, cfg: EFTConfig, plin_kin, quadform: str = "plain"):
    """Loop power spectra and correlation functions.

    nt : tables from :func:`build_nonlinear_tables`, on ``plin_kin``'s device
    plin_kin : (W, nkin) linear power spectrum on cfg.kin
    quadform : "plain", the two-einsum quadratic forms (the only route here)

    Returns a dict with
      p22 : (W, 28, nk), p13_kernel : (W, 10, nk)
      c11, cct, cct_nnlo : (W, nl, ns)
      c22 : (W, nl, 28, ns), c13 : (W, nl, 10, ns)

    Mirrors ``NonLinear.PsCf`` + the make* contractions
    (pybird.py:1074-1171); upstream FFTLog window = 0.2.
    """
    if quadform != "plain":
        raise ValueError("the reference runs the plain quadratic forms only")

    def qf(w, key):
        return qf_real_plain(w, nt[key + "_fold"])

    coef_pk, coef_cf = _coefs(nt, cfg, plin_kin)
    nc = nt["nc"]

    # ---- P-side: T[w, n, k] = c_n · k^{ν_n + 3/2};
    # P22_bk = Re Σ_{nm} T_nk T_mk M22_bnm, Hermitian-folded to a real form
    w_pk = herm_w(coef_pk, nt["kpow22_half"], nc)
    p22 = qf(w_pk, "m22")
    p13_kernel = cplx.ceinsum_real("...n,nbk->...bk", coef_pk, nt["a13"])

    # ---- CF-side: Z[w, n, s] = c_n s^{-ν_n - 3}; C22/C13 are the same folded
    # quadratic form, evaluated in one stacked call
    c11 = cplx.ceinsum_real("...n,nls->...ls", coef_cf, nt["a11"])
    cct = cplx.ceinsum_real("...n,nls->...ls", coef_cf, nt["act"])
    cct_nnlo = cplx.ceinsum_real("...n,nls->...ls", coef_cf, nt["act_nnlo"])
    w_cf = herm_w(coef_cf, nt["spow_half"], nc)
    n22b, n13b = nt["n22"], nt["n13"]
    nl = nt["a11"][0].shape[1]
    out = dict(p22=p22, p13_kernel=p13_kernel, c11=c11, cct=cct, cct_nnlo=cct_nnlo)
    c_all = qf(w_cf, "mcf")  # (W, (28+10)·nl, ns)
    ns_ = c_all.shape[-1]
    lead = c_all.shape[:-2]
    out["c22"] = c_all[..., : n22b * nl, :].reshape(lead + (n22b, nl, ns_)).transpose(-3, -2)
    out["c13"] = c_all[..., n22b * nl:, :].reshape(lead + (n13b, nl, ns_)).transpose(-3, -2)
    return out
