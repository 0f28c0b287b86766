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
two quadratic forms through the fused kernels.

The low-rank route (``quadform="lowrank"``) is the JAX package's float32
path: the truncated, whitened eigenbasis factors of both folds and of the
(channel, f-power)-premixed CF fold (``lowrank_tables_numpy``), contracted by
``ops/quadform.py::quad_form_lowrank``.  The factors are built only when a
builder asks for that route, and it is never a default here: it is an
approximation, held against the dense path by its callers.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import torch

from .. import to_device
from ..ops import cplx
from ..ops.fftlog import HostFFTLog, make_plan, fftlog_coef
from ..ops.quadform import (
    cf_contract, herm_fold, herm_w, kernel_matrices, lowrank_factors, qf_real_plain,
    quad_form_lowrank, quad_form_real, trim_nyquist,
)
from ..tables.loop_matrices import m13_matrices, m22_matrices, mpc
from ..utils.io import atomic_save_npz
from .bird import cf_group_map
from .config import EFTConfig

QUADFORMS = ("kernel", "plain", "lowrank")
# the spectral cut of the low-rank factors, relative to each matrix's
# spectral radius after whitening (the JAX package's EFTPIPE_TPU_LOWRANK_TOL)
LOWRANK_TOL = 1e-5
# the identity of the factors' recipe (the JAX package's lr_version): a cache
# written by another recipe is rebuilt, never reused
LOWRANK_VERSION = 2
_LOWRANK_KEYS = ("q22", "s22", "qcf", "scf", "qcfg", "scfg")


def _loop_fft(cfg: EFTConfig) -> HostFFTLog:
    # upstream fftsettings: pybird.py:919
    return HostFFTLog(n=cfg.nfft_loop, xmin=1.5e-5, xmax=1000.0, bias=-1.6)


def _fid_coef_mag(plan, kin_plan: np.ndarray) -> np.ndarray:
    """Fiducial |c_n| profile for the whitened spectral cut (host NumPy).

    The per-dof dynamic range of the quadratic-form input w is the FFTLog
    coefficients' decay (|s^{-ν_n-3}| does not depend on n: Re ν is the
    constant bias), set by the taper window and the smoothness of P_lin, so a
    BBKS shape stands in for every cosmology.  Whitening only changes WHICH
    eigenpairs the cut keeps; the kept contraction stays exact."""
    q = kin_plan / 0.15
    tk = (np.log1p(2.34 * q) / (2.34 * q)
          * (1 + 3.89 * q + (16.1 * q) ** 2 + (5.46 * q) ** 3
             + (6.71 * q) ** 4) ** -0.25)
    f = kin_plan * tk ** 2
    parts = []
    if plan.ileft > 0:
        if plan.extrap_lo:
            slope = (np.log(f[1]) - np.log(f[0])) / plan.lo_dlog
            parts.append(f[0] * np.exp(slope * plan.lo_logx) * plan.lo_fac)
        else:
            parts.append(np.zeros(plan.ileft))
    parts.append(f @ plan.smid.T)
    if plan.iright < plan.n:
        if plan.extrap_hi:
            slope = (np.log(f[-1]) - np.log(f[-2])) / plan.hi_dlog
            parts.append(f[-1] * np.exp(slope * plan.hi_logx) * plan.hi_fac)
        else:
            parts.append(np.zeros(plan.n - plan.iright))
    fx = np.concatenate(parts)
    c = np.hypot(fx @ plan.gre, fx @ plan.gim)
    return np.maximum(c, 1e-8 * c.max())


def _whiten_dofs(cmag: np.ndarray, nc: int) -> np.ndarray:
    """Map the (n+1,) coefficient profile to the 2·nc−1 trimmed real dofs of
    ``herm_w`` (zr rows n ∈ [nc, 2nc), then zi rows n ∈ (nc, 2nc))."""
    half = cmag[nc:-1]
    return np.concatenate([half, half[1:]])


_TABLE_MEMO: dict[tuple, dict] = {}
_LOWRANK_MEMO: dict[tuple, dict] = {}


def _memo_key(cfg: EFTConfig) -> tuple:
    """The fields that enter the tables: the FFTLog settings and the k/s/kin
    grids (not km/kr/nd, which only scale the bias contraction)."""
    return (cfg.nl, cfg.kmax, cfg.optiresum, cfg.ir_cutoff, cfg.k_ir,
            cfg.nfft_loop, cfg.kin_min, cfg.kin_max, cfg.nkin)


def _cache_file(cache_dir, stem: str, key: tuple) -> Path:
    digest = hashlib.sha256(repr(key).encode()).hexdigest()[:16]
    return Path(cache_dir) / f"{stem}_{digest}.npz"


def nonlinear_tables_numpy(cfg: EFTConfig, cache_dir=None, lowrank_tol=None) -> dict:
    """Host-side constant tensors of the loop engine (complex128/float64).

    Memoized on the fields that enter the tables, so a multi-tracer build
    computes the fold tensors once.  With ``cache_dir`` the two expensive
    fold tensors also persist across processes (uncompressed npz,
    hash-keyed).  With ``lowrank_tol`` the tables also hold ``lowrank``, the
    factors of :func:`lowrank_tables_numpy` at that cut."""
    memo_key = _memo_key(cfg)
    if memo_key in _TABLE_MEMO:
        tables = dict(_TABLE_MEMO[memo_key])
        if lowrank_tol is not None:
            tables["lowrank"] = lowrank_tables_numpy(cfg, lowrank_tol, cache_dir)
        return tables
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
    return nonlinear_tables_numpy(cfg, cache_dir, lowrank_tol)


def lowrank_tables_numpy(cfg: EFTConfig, lowrank_tol: float = LOWRANK_TOL,
                         cache_dir=None) -> dict:
    """Host: the low-rank factors of the loop engine's folds at the spectral
    cut ``lowrank_tol`` (float64), as the JAX package builds them:

      q22/s22   — the P22 fold, whitened by the fiducial P-side coefficients;
      qcf/scf   — the per-structure CF fold, whitened by the CF-side ones;
      qcfg/scfg — the CF fold premixed over (channel, f-power) groups with
                  the Legendre ℓ-weights (``bird.cf_group_map``) before the
                  eigendecomposition: exact algebra before the cut, where the
                  structures' tails cancel, so the stacked rank drops ~7x.

    Memoized on (the table fields, the cut, ``LOWRANK_VERSION``); with
    ``cache_dir`` also persisted under the same key, with the version inside
    the file, so a cache of another cut or recipe is never reused."""
    tol = float(lowrank_tol)
    key = _memo_key(cfg) + ("lowrank", tol, LOWRANK_VERSION)
    if key in _LOWRANK_MEMO:
        return dict(_LOWRANK_MEMO[key])
    nt = nonlinear_tables_numpy(cfg, cache_dir)
    cache = _cache_file(cache_dir, "lowrank", key) if cache_dir is not None else None
    factors = None
    if cache is not None and cache.exists():
        with np.load(cache) as z:
            if ("lr_version" in z and int(z["lr_version"]) == LOWRANK_VERSION
                    and all(k in z for k in _LOWRANK_KEYS)):
                factors = {k: z[k] for k in _LOWRANK_KEYS}
    if factors is None:
        nc, icut, kin = nt["nc"], nt["kin_cut_index"], cfg.kin
        # the plans built on the grid cut at k_ir read kin[icut:]
        kin_pk = kin[icut:] if cfg.ir_cutoff in ("all", "loop") else kin
        kin_cf = kin[icut:] if cfg.ir_cutoff in ("all", "resum") else kin
        wh_pk = _whiten_dofs(_fid_coef_mag(nt["plan_pk"], kin_pk), nc)
        wh_cf = _whiten_dofs(_fid_coef_mag(nt["plan_cf"], kin_cf), nc)
        mcf_fold = nt["mcf_fold"]
        q22, s22 = lowrank_factors(nt["m22_fold"], tol=tol, whiten=wh_pk)
        qcf, scf = lowrank_factors(mcf_fold, tol=tol, whiten=wh_cf)
        gmap = cf_group_map(cfg.nl, nt["n22"], nt["n13"])
        mcf_grp = (gmap @ mcf_fold.reshape(gmap.shape[1], -1)).reshape(
            (gmap.shape[0],) + mcf_fold.shape[1:])
        qcfg, scfg = lowrank_factors(mcf_grp, tol=tol, whiten=wh_cf)
        factors = dict(q22=q22, s22=s22, qcf=qcf, scf=scf, qcfg=qcfg, scfg=scfg)
        if cache is not None:
            atomic_save_npz(cache, lr_version=np.array(LOWRANK_VERSION), **factors)
    _LOWRANK_MEMO[key] = factors
    return dict(factors)


def nonlinear_tables_to(tables: dict, device, dtype) -> dict:
    """Move host tables to the device; ``plan_cf`` stays the SAME object as
    ``plan_pk`` when they were one plan (one FFTLog per evaluation then)."""
    shared = tables["plan_cf"] is tables["plan_pk"]
    out = to_device(tables, device, dtype)
    if shared:
        out["plan_cf"] = out["plan_pk"]
    return out


def build_nonlinear_tables(cfg: EFTConfig, device, dtype, cache_dir=None,
                           lowrank_tol=None) -> dict:
    return nonlinear_tables_to(nonlinear_tables_numpy(cfg, cache_dir, lowrank_tol),
                               device, dtype)


def kernel_layout(nt: dict, key: str):
    """The layout the quadratic-form kernels read of ``nt[key + "_fold"]``
    (``kernel_matrices``), made at its first use on the card and kept in the
    tables as ``nt[key + "_kernel"]``: once per device and dtype.  None on the
    CPU, where the plain version runs."""
    m = nt[key + "_fold"]
    if not m.is_cuda:
        return None
    if key + "_kernel" not in nt:
        nt[key + "_kernel"] = kernel_matrices(m)
    return nt[key + "_kernel"]


def complex_cf_matrices(cfg: EFTConfig, ell_index: int = 0):
    """Host: the UNFOLDED complex CF quadratic-form matrices of one multipole,
    (n22+n13, n+1, n+1) complex128, stacked like one ℓ-slice of ``mcf_fold``
    (P22 block first) — the operand of the complex A/B reference
    (:func:`cf_loop_complex`)."""
    pw = _loop_fft(cfg).pow
    ns = -0.5 * pw
    ml = mpc(2 * ell_index, ns[:, None] + ns[None, :] - 1.5)
    m22 = m22_matrices(pw)
    m13 = m13_matrices(pw)
    return np.concatenate([m22 * ml[None], m13[:, :, None] * ml[None]], axis=0)


def _coefs(nt: dict, cfg: EFTConfig, plin_kin):
    icut = nt["kin_cut_index"]
    f_cut = plin_kin[..., icut:] if icut else plin_kin
    coef_pk = fftlog_coef(nt["plan_pk"], f_cut if cfg.ir_cutoff in ("all", "loop") else plin_kin)
    if nt["plan_cf"] is nt["plan_pk"]:
        coef_cf = coef_pk
    else:
        coef_cf = fftlog_coef(nt["plan_cf"], f_cut if cfg.ir_cutoff == "resum" else plin_kin)
    return coef_pk, coef_cf


def nonlinear_pscf(nt: dict, cfg: EFTConfig, plin_kin, quadform: str = "kernel",
                   cf_premix: bool = True):
    """Loop power spectra and correlation functions.

    nt : tables from :func:`build_nonlinear_tables`, on ``plin_kin``'s device
    plin_kin : (W, nkin) linear power spectrum on cfg.kin
    quadform : "kernel" — the public op ``quad_form_real`` (fused CUDA kernel
        on the card, its plain version on the CPU); "plain" — the two-einsum
        plain version on whatever device, as an independent reference;
        "lowrank" — ``quad_form_lowrank`` on the tables' ``lowrank`` factors
        (the JAX package's float32 route; tables built with ``lowrank_tol``).
    cf_premix : with "lowrank", contract the CF loop on the (channel,
        f-power)-premixed factors and return ``cloop_grp`` in place of
        ``c22``/``c13`` (the JAX package's ``EFTPIPE_TPU_CF_PREMIX``).

    Returns a dict with
      p22 : (W, 28, nk), p13_kernel : (W, 10, nk)
      c11, cct, cct_nnlo : (W, nl, ns)
      c22 : (W, nl, 28, ns), c13 : (W, nl, 10, ns)   — or, premixed,
      cloop_grp : (W, G, nl, ns), G = 22 (channel, f-power) groups

    Mirrors ``NonLinear.PsCf`` + the make* contractions
    (pybird.py:1074-1171); upstream FFTLog window = 0.2.
    """
    if quadform not in QUADFORMS:
        raise ValueError(f"quadform must be one of {QUADFORMS}, got {quadform!r}")
    if quadform == "lowrank":
        lr = nt.get("lowrank")
        if lr is None:
            raise ValueError("quadform='lowrank' needs tables built with lowrank_tol "
                             "(build_nonlinear_tables(..., lowrank_tol=...))")

        def qf(w, key):
            which = "22" if key == "m22" else "cf"
            return quad_form_lowrank(w, lr["q" + which], lr["s" + which])
    elif quadform == "kernel":
        def qf(w, key):
            return quad_form_real(w, nt[key + "_fold"], kernel_layout(nt, key))
    else:
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
    if quadform == "lowrank" and cf_premix:
        # the premixed CF loop: bird.assemble_bird applies f^p and the
        # group→channel one-hot in place of the l22/l13 regrouping
        cgrp = quad_form_lowrank(w_cf, lr["qcfg"], lr["scfg"])  # (W, G·nl, ns)
        gnl = lr["scfg"].shape[0]
        out["cloop_grp"] = cgrp.reshape(cgrp.shape[:-2] + (gnl // nl, nl, cgrp.shape[-1]))
        return out
    c_all = qf(w_cf, "mcf")  # (W, (28+10)·nl, ns)
    ns_ = c_all.shape[-1]
    lead = c_all.shape[:-2]
    out["c22"] = c_all[..., : n22b * nl, :].reshape(lead + (n22b, nl, ns_)).transpose(-3, -2)
    out["c13"] = c_all[..., n22b * nl:, :].reshape(lead + (n13b, nl, ns_)).transpose(-3, -2)
    return out


def cf_loop_complex(nt: dict, cfg: EFTConfig, plin_kin, mcf_complex, ell_index: int = 0,
                    prepared=None):
    """Complex A/B reference of the folded CF loop for one multipole.

    Contracts the UNFOLDED complex matrices ``mcf_complex`` = (mr, mi), each
    (38, n+1, n+1) (:func:`complex_cf_matrices` moved to the device), against
    the full complex z = c_n s^{-ν_n-3} through the public op ``cf_contract``
    (on their kernel layouts ``prepared`` when given) and returns (reference,
    folded): both (W, 38, ns), the second being the ℓ = ``ell_index`` rows of
    the folded stack from ``quad_form_real``."""
    _, coef_cf = _coefs(nt, cfg, plin_kin)
    nc = nt["nc"]
    pr, pi = nt["spow_half"]  # rows n ∈ [nc, 2nc)
    cr, ci = coef_cf
    # upper half n ≥ nc (Nyquist coefficient is exactly zero), mirrored to
    # n < nc by Hermitian symmetry z_{nc-j} = conj(z_{nc+j})
    zr_h = cr[..., nc:-1, None] * pr - ci[..., nc:-1, None] * pi
    zi_h = cr[..., nc:-1, None] * pi + ci[..., nc:-1, None] * pr
    zero = torch.zeros_like(zr_h[..., :1, :])
    zr = torch.cat([zero, zr_h[..., 1:, :].flip(-2), zr_h, zero], dim=-2)
    zi = torch.cat([zero, -zi_h[..., 1:, :].flip(-2), zi_h, zero], dim=-2)
    ref = cf_contract(zr, zi, mcf_complex[0], mcf_complex[1], prepared)
    w_cf = herm_w(coef_cf, nt["spow_half"], nc)
    nl = nt["a11"][0].shape[1]
    rows = torch.arange(nt["n22"] + nt["n13"], device=plin_kin.device) * nl + ell_index
    folded = quad_form_real(w_cf, nt["mcf_fold"][rows].contiguous())
    return ref, folded
