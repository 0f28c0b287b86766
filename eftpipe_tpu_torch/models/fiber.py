"""Fiber-collision correction, Hahn et al. effective-window method
(counterpart of ``eftpipe_tpu/models/fiber.py``).

Upstream computes the correlated correction ``dPcorr`` with a quadruple loop
over (ℓ, ℓ', component, k) and per-k masked quadratures
(eftpipe/pybird/pybird.py:1703-1757).  The correction is linear in the
multipoles with fixed coefficients, so Phase A collapses the log-spaced q
quadrature, the IR/UV kernels, the masks and the linear interpolation from
the internal k grid into one constant tensor ``fmat[l, l', k, j]``; per
evaluation it is one einsum per field on the walker batch.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import j1, legendre

from .config import EFTConfig
from .bird import BirdState


def w2d(x):
    """Cylindrical top-hat window 2 J1(x)/x (pybird.py:45-47)."""
    return 2.0 * j1(x) / x


def hllp(l: int, lp: int, x):
    """Legendre coupling polynomials H_{ℓℓ'} (pybird.py:50-65)."""
    if l == 2 and lp == 0:
        return x**2 - 1.0
    if l == 4 and lp == 0:
        return 1.75 * x**4 - 2.5 * x**2 + 0.75
    if l == 4 and lp == 2:
        return x**4 - x**2
    if l == 6 and lp == 0:
        return 4.125 * x**6 - 7.875 * x**4 + 4.375 * x**2 - 0.625
    if l == 6 and lp == 2:
        return 2.75 * x**6 - 4.5 * x**4 + 1.75 * x**2
    if l == 6 and lp == 4:
        return x**6 - x**4
    return 0.0 * x


def fllp_ir(l: int, lp: int, k: float, q, dfc: float):
    """IR kernel, q < k (pybird.py:68-75)."""
    if l == lp:
        return (q / k) * w2d(q * dfc) * (q / k) ** l
    return (q / k) * w2d(q * dfc) * (2.0 * l + 1.0) / 2.0 * hllp(max(l, lp), min(l, lp), q / k)


def fllp_uv(l: int, lp: int, k: float, q, dfc: float):
    """UV kernel, q > k (pybird.py:78-85)."""
    if l == lp:
        return w2d(q * dfc) * (k / q) ** l
    return w2d(q * dfc) * (2.0 * l + 1.0) / 2.0 * hllp(max(l, lp), min(l, lp), k / q)


def _linear_interp_matrix(xin: np.ndarray, xout: np.ndarray) -> np.ndarray:
    """Linear interpolation with end-segment linear extrapolation, the
    behaviour of interp1d(kind='linear', fill_value='extrapolate')
    (pybird.py:1720-1722)."""
    n = xin.size
    m = np.zeros((xout.size, n))
    idx = np.clip(np.searchsorted(xin, xout) - 1, 0, n - 2)
    t = (xout - xin[idx]) / (xin[idx + 1] - xin[idx])
    m[np.arange(xout.size), idx] = 1.0 - t
    m[np.arange(xout.size), idx + 1] = t
    return m


def dp_uncorr(kout, fs: float = 0.6, dfc: float = 0.43 / 0.6777) -> np.ndarray:
    """Uncorrelated contribution on the data grid (pybird.py:1679-1701)."""
    kout = np.asarray(kout)
    out = np.zeros((3, kout.size))
    for l in (0, 2, 4):
        out[l // 2] = (
            -fs * np.pi * dfc**2 * (2.0 * np.pi / kout) * (2.0 * l + 1.0) / 2.0
            * legendre(l)(0) * (1.0 - (kout * dfc) ** 2 / 8.0)
        )
    return out


def build_fiber_tables(
    cfg: EFTConfig,
    fs: float,
    dfc: float,
    ktrust: float = 0.25,
    fiber_st: bool = False,
    nq: int = 1024,
) -> dict:
    """Host (NumPy) fused correction tensor fmat[l, l', k, j] with
    dP[l, n, k] = Σ_{l', j} fmat[l, l', k, j] P[l', n, j]."""
    k = cfg.k
    q = np.geomspace(k.min(), ktrust, num=nq)
    dq = np.concatenate([[0.0], np.diff(q)])
    lin = _linear_interp_matrix(k, q)  # (nq, nk)

    kern = np.zeros((cfg.nl, cfg.nl, k.size, nq))
    for il in range(cfg.nl):
        for ilp in range(cfg.nl):
            for i, kk in enumerate(k):
                row = np.zeros(nq)
                if ilp <= il:
                    mask = q < kk
                    row[mask] += fllp_ir(2 * il, 2 * ilp, kk, q[mask], dfc)
                if ilp >= il:
                    mask = (q > kk) & (q < ktrust)
                    row[mask] += fllp_uv(2 * il, 2 * ilp, kk, q[mask], dfc)
                kern[il, ilp, i] = -0.5 * fs * dfc**2 * q * dq * row
    fmat = np.einsum("apkq,qj->apkj", kern, lin)
    return dict(fmat=fmat, fiber_st=fiber_st, fs=fs, dfc=dfc, ktrust=ktrust)


def fiber_tables_to(ft: dict, device, dtype) -> dict:
    """Device form of host fiber tables."""
    return dict(
        fmat=torch.as_tensor(np.ascontiguousarray(ft["fmat"]), dtype=dtype, device=device),
        fiber_st=bool(ft["fiber_st"]),
    )


def apply_fiber(ft: dict, cfg: EFTConfig, bird: BirdState) -> BirdState:
    """Add the correlated fiber-collision correction (pybird.py:1760-1809)."""
    fmat = ft["fmat"]

    def corr(x):
        return x + torch.einsum("apkj,...pnj->...ank", fmat, x)

    out = bird._replace(
        p11l=corr(bird.p11l),
        pctl=corr(bird.pctl),
        ploopl=corr(bird.ploopl),
        pct_nnlo_l=corr(bird.pct_nnlo_l) if cfg.with_nnlo else bird.pct_nnlo_l,
    )
    if ft["fiber_st"]:
        out = out._replace(pstl=corr(bird.pstl))
    return out
