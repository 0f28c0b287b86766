"""Radial integral-constraint correction, arXiv 1904.08851 (counterpart of
``eftpipe_tpu/models/icc.py``).

Phase-A builder mirroring upstream ``IntegralConstraint``
(eftpipe/icc.py:119-497), host NumPy only:

* shot-noise part ``psn[a, k]``: 1-D FFTLog of the W²_ℓ(s) multipoles with the
  analytic Bessel-moment matrix (icc.py:359-398), scaled by Pshot;
* window-like part ``Wal(k, p)``: double spherical-Bessel transform of the
  (ℓ1, ℓ2, s1, s2) table via 2-D FFTLog (icc.py:400-446), masked, weighted
  and fused with the cubic-interpolation matrix like the survey window.

The result is the ``icc_tables`` coupling of
:func:`eftpipe_tpu_torch.models.window.build_window_tables`.
"""

from __future__ import annotations

import json
import hashlib
import logging
import numpy as np
from pathlib import Path

from ..ops.fftlog import HostFFTLog
from ..ops.fftlog2d import HostFFTLog2D, bessel_matrix
from ..ops.interp import spline_matrix
from ..utils.io import atomic_save_npz
from .config import EFTConfig
from .window import window_kgrid, mask_and_weight

log = logging.getLogger("eftpipe_tpu_torch.icc")


def ic_panel_to_ndarray(arr: np.ndarray, inorder: bool = False):
    """(l1, l2, s1, s2, value) rows -> value[l1, l2, s1, s2] (icc.py:106-116)."""
    l1, l2, s1, s2 = (np.unique(c) for c in arr.T[:4])
    shape = (l1.size, l2.size, s1.size, s2.size)
    if arr.shape[0] != np.prod(shape):
        raise ValueError(f"IC table has {arr.shape[0]} rows, its axes give {shape}")
    meta = dict(l1=l1, l2=l2, s1=s1, s2=s2)
    if inorder:
        return arr.T[4].reshape(shape), meta
    idx = (
        np.searchsorted(l1, arr[:, 0]) * (l2.size * s1.size * s2.size)
        + np.searchsorted(l2, arr[:, 1]) * (s1.size * s2.size)
        + np.searchsorted(s1, arr[:, 2]) * s2.size
        + np.searchsorted(s2, arr[:, 3])
    )
    out = np.empty(np.prod(shape))
    out[idx] = arr[:, 4]
    return out.reshape(shape), meta


def read_ic_file(path) -> np.ndarray:
    """Load the config-space IC table: ``.npy`` directly, text by
    ``np.loadtxt`` (``#`` comments skipped)."""
    path = Path(path)
    if path.suffix == ".npy":
        return np.load(path)
    return np.loadtxt(path, comments="#", ndmin=2)


def compute_psn(cfg: EFTConfig, s, w2, na: int, nmax: int = 4096,
                bias: float = -2.1, window_param: float | None = 1.0) -> np.ndarray:
    """Shot-noise part from W²_ℓ(s) multipoles (icc.py:359-398)."""
    fft = HostFFTLog(n=nmax, xmin=s[0], xmax=s[-1], bias=bias)
    coef = fft.coef(s, w2, extrap="padding", window=window_param)  # (a, n)
    power = cfg.k[:, None] ** (-fft.pow[None, :] - 3.0)
    mat = np.stack([bessel_matrix(fft.pow, ell) for ell in range(0, 2 * na, 2)])
    psn = np.einsum("an,kn,an->ak", coef, power, mat, optimize=True).real
    sign = np.real(np.array([(-1j) ** ell for ell in range(0, 2 * na, 2)]))
    return 4.0 * np.pi * sign[:, None] * psn


def compute_ic_wal(cfg: EFTConfig, s1, s2, table, p, na: int, nl: int,
                   nxmax: int = 4096, nymax: int = 4096,
                   xbias: float = -2.0, ybias: float = -2.0,
                   window_param: float | None = 1.0) -> np.ndarray:
    """Window-like part W^ic_{l,l'}(k, p) (icc.py:400-446)."""
    fft2d = HostFFTLog2D(
        nx=nxmax, ny=nymax, xmin=1e-3, xmax=s1[-1], ymin=1e-3, ymax=s2[-1],
        xbias=xbias, ybias=ybias,
    )
    wal = np.empty((na, nl, cfg.k.size, p.size))
    for il1 in range(na):
        for il2 in range(nl):
            block = fft2d.spherical_transform(
                s1, s2, table[il1, il2], k1=cfg.k, k2=p,
                l1=2 * il1, l2=2 * il2, window=window_param,
            )
            sign = np.real((-1j) ** (2 * il1) * (1j) ** (2 * il2))
            wal[il1, il2] = block * 8.0 * sign / (2 * (2 * il2) + 1) * p**2
    return wal


def build_icc_tables(
    cfg: EFTConfig,
    pshot: float,
    icc_configspace_sn_file=None,
    icc_configspace_ic_file=None,
    cache_dir=None,
    inorder: bool = False,
    na: int | None = None,
    nl: int | None = None,
    pmax: float = 0.3,
    accboost: int = 1,
    withmask: bool = True,
    windowk: float = 0.05,
    nmax: int = 4096,
    bias: float = -2.1,
    window_param: float | None = 1.0,
    nxmax: int = 4096,
    nymax: int = 4096,
    xbias: float = -2.0,
    ybias: float = -2.0,
    windowxy_param: float | None = 1.0,
) -> dict:
    """Host (NumPy) icc tables ``wmat`` (fused like the window's), ``psn``
    (already times ``pshot``), ``wal``, ``p``, cached under ``cache_dir``
    with the JAX package's key."""
    na = na or cfg.nl
    nl = nl or cfg.nl
    if na > cfg.nl or nl > cfg.nl or na > nl:
        raise ValueError(f"inconsistent na={na}, nl={nl} for cfg.nl={cfg.nl}")
    p = window_kgrid(kmax=pmax, accboost=accboost)

    meta = dict(
        na=na, nl=nl, pmax=pmax, accboost=accboost, nmax=nmax, bias=bias,
        window_param=window_param, nxmax=nxmax, nymax=nymax, xbias=xbias,
        ybias=ybias, windowxy_param=windowxy_param,
        sn=str(icc_configspace_sn_file), ic=str(icc_configspace_ic_file),
        k=cfg.k.tolist(),
    )
    psn = wal = None
    cache_path = None
    if cache_dir is not None:
        key = hashlib.sha256(json.dumps(meta, sort_keys=True).encode()).hexdigest()[:16]
        cache_path = Path(cache_dir) / f"icc_{key}.npz"
        if cache_path.exists():
            data = np.load(cache_path)
            log.info("icc: loaded cached tables %s", cache_path)
            psn, wal = data["psn"], data["wal"]
    if psn is None:
        if icc_configspace_sn_file is None or icc_configspace_ic_file is None:
            raise ValueError("icc requires the SN and IC configuration-space files")
        log.info(
            "icc: computing PSN/Wal from %s + %s (cached -> %s)",
            icc_configspace_sn_file, icc_configspace_ic_file, cache_path,
        )
        sn = np.loadtxt(icc_configspace_sn_file)
        while sn[0, 0] == 0.0:
            sn = sn[1:]
        sn = sn[:, : 1 + na]
        psn = compute_psn(cfg, sn[:, 0], sn[:, 1:].T, na, nmax=nmax, bias=bias,
                          window_param=window_param)
        table, pmeta = ic_panel_to_ndarray(read_ic_file(icc_configspace_ic_file), inorder)
        wal = compute_ic_wal(cfg, pmeta["s1"], pmeta["s2"], table, p, na, nl,
                             nxmax=nxmax, nymax=nymax, xbias=xbias, ybias=ybias,
                             window_param=windowxy_param)
        if cache_path is not None:
            atomic_save_npz(cache_path, psn=psn, wal=wal, meta=json.dumps(meta))

    waldk = mask_and_weight(cfg, wal, p, withmask=withmask, windowk=windowk)
    interp = spline_matrix(cfg.k, p)
    wmat = np.einsum("alkp,pj->alkj", waldk, interp)
    return dict(wmat=wmat, wal=wal, psn=psn * pshot, p=p, na=na, nl=nl, meta=meta)
