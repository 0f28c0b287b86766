"""Survey window convolution (counterpart of ``eftpipe_tpu/models/window.py``).

Phase A builds the Fourier-space window matrix W_{a,l}(k,p) from the
configuration-space window multipoles Q_q(s) as upstream does
(eftpipe/window.py:262-359): Wigner-3j² coupling of the Q_q into Q_{a,l}(s),
a kernel-FFTLog with spherical-Bessel j_a(ks) kernels, the analytic MPC
transform on the p side, the |p-k| < windowk mask and the Δp quadrature
weights.  The per-evaluation cubic interpolation from the internal k grid
onto the p grid is itself a constant matrix, so the whole convolution is one
constant tensor ``wmat[a, l, k, j]`` applied as one einsum per field.

The matrix is cached to ``<cache_dir>/window_<hash>.npz``, keyed by a hash
of the build settings (the same settings give the same file name as the JAX
package), with the settings stored as a ``meta`` JSON string inside the npz.
Reference-format ``window_fourier_file`` matrices (raw ``.npy`` with an
optional ``.json`` meta sidecar) are accepted, checked against the current
settings on load (``MetaInfoError``) and written back after a compute.

Host builders return NumPy dicts (the JAX package's layout); the pipeline
moves them to the device with :func:`window_tables_to`, and
:func:`apply_window` runs on a walker batch.
"""

from __future__ import annotations

import json
import hashlib
import logging
import numpy as np
import torch
from pathlib import Path
from scipy.special import spherical_jn

from ..ops.fftlog import HostFFTLog
from ..ops.interp import spline_matrix
from ..tables.loop_matrices import mpc
from ..utils.io import atomic_save_npz
from .config import EFTConfig
from .bird import BirdState


log = logging.getLogger("portbench.reference.window")


class MetaInfoError(Exception):
    """Cached/loaded artifact inconsistent with the current settings
    (upstream eftpipe/window.py:36)."""


# Wigner-3j² coupling C_{a,l,q} = (2a+1) (a l q; 0 0 0)² restricted to even
# multipoles a,l,q ∈ {0,2,4,6} (upstream window.py:286-303)
CALQ = np.array([
    [[1, 0, 0, 0],
     [0, 1 / 5, 0, 0],
     [0, 0, 1 / 9, 0],
     [0, 0, 0, 1 / 13]],
    [[0, 1, 0, 0],
     [1, 2 / 7, 2 / 7, 0],
     [0, 2 / 7, 100 / 693, 25 / 143],
     [0, 0, 25 / 143, 14 / 143]],
    [[0, 0, 1, 0],
     [0, 18 / 35, 20 / 77, 45 / 143],
     [1, 20 / 77, 162 / 1001, 20 / 143],
     [0, 45 / 143, 20 / 143, 252 / 2431]],
    [[0, 0, 0, 1],
     [0, 0, 5 / 11, 14 / 55],
     [0, 5 / 11, 20 / 99, 28 / 187],
     [1, 14 / 55, 28 / 187, 400 / 3553]],
])


def window_kgrid(kmax: float = 0.3, accboost: int = 1) -> np.ndarray:
    """Convolution p grid: geometric below 0.015, linear above (window.py:27-33)."""
    return np.concatenate([
        np.geomspace(1e-5, 0.015, 100 * accboost, endpoint=False),
        np.arange(0.015, kmax, 1e-3 / accboost),
    ])


def load_configspace_window(path, nq: int) -> tuple[np.ndarray, np.ndarray]:
    """Read an (s, Q0, Q2, ...) text file, dropping s = 0 rows (window.py:272-283)."""
    raw = np.loadtxt(path)
    while raw[0, 0] == 0.0:
        raw = raw[1:]
    if raw.shape[-1] > 1 + nq:
        raw = raw[:, : 1 + nq]
    return raw[:, 0], raw[:, 1:].T


def compute_wal(
    cfg: EFTConfig,
    sw: np.ndarray,
    qq: np.ndarray,
    p: np.ndarray,
    na: int,
    nl: int,
    nmax: int = 4096,
    xmin_factor: float = 1.0,
    xmax_factor: float = 100.0,
    bias: float = -1.6,
    window_param: float | None = 1.0,
) -> np.ndarray:
    """W_{a,l}(k,p) from config-space multipoles (window.py:262-346)."""
    nq = qq.shape[0]
    qal = np.einsum("alq,qs->als", CALQ[..., :nq], qq)[:na, :nl]

    fft = HostFFTLog(n=nmax, xmin=sw[0] * xmin_factor, xmax=sw[-1] * xmax_factor, bias=bias)
    k = cfg.k
    ells_a = np.arange(na)

    def kernel(x):
        # j_{2a}(k s): shape (na, 1, nk, len(x))
        return spherical_jn(
            2 * ells_a[:, None, None, None],
            x[None, None, None, :] * k[None, None, :, None],
        )

    # the mask multipoles are k-independent, only the j_a(ks) kernel carries
    # k: a length-1 k axis broadcasts against the kernel inside coef(), so the
    # mask is resampled once per (a, l) instead of nk times
    f_in = qal[:, :, None, :]
    coef = fft.coef(sw, f_in, extrap="padding", window=window_param, kernel=kernel)
    phase = np.real((-1j) ** (2 * ells_a))[:, None, None, None] * np.real(
        (1j) ** (2 * np.arange(nl))
    )[None, :, None, None]
    coef = coef * phase

    ppow = p[None, :] ** (-fft.pow[:, None] - 3.0)
    m = 4.0 * np.pi * mpc(2 * np.arange(nl)[:, None], -0.5 * fft.pow[None, :])
    return p**2 * np.real(np.einsum("alkn,np,ln->alkp", coef, ppow, m, optimize=True))


def mask_and_weight(cfg: EFTConfig, wal: np.ndarray, p: np.ndarray,
                    withmask: bool = True, windowk: float = 0.05) -> np.ndarray:
    """|p-k| mask + Δp quadrature weights (window.py:348-359)."""
    out = wal
    if withmask:
        mask = (p[:, None] < cfg.k[None, :] + windowk) & (p[:, None] > cfg.k[None, :] - windowk)
        out = np.einsum("alkp,pk->alkp", out, mask)
    deltap = np.concatenate([[0.0], np.diff(p)])
    return out * deltap


def _load_fourier_file(fourier_path: Path, cfg: EFTConfig, p: np.ndarray,
                       na: int, nl: int, meta: dict):
    """A reference-format .npy Fourier matrix with the ``_Nl{nl}`` retry and
    the JSON-sidecar check (window.py:204-260); None when there is none."""
    wf = fourier_path
    if not wf.exists():
        return None
    wal = np.load(wf)
    if wal.shape[1] != nl:
        retry = wf.with_name(wf.stem + f"_Nl{nl}.npy")
        if not retry.exists():
            return None
        wal, wf = np.load(retry), retry
    log.info("window: loaded fourier matrix %s", wf)
    if wal.shape[:2] != (na, nl):
        raise MetaInfoError(
            f"window fourier matrix shape {wal.shape} does not match "
            f"(na, nl) = ({na}, {nl})"
        )
    if wal.shape[2:] != (cfg.k.size, p.size):
        raise MetaInfoError(
            f"window fourier matrix (nk, np) = {wal.shape[2:]} does "
            f"not match the current grids ({cfg.k.size}, {p.size}) — "
            "was it built for different k/accboost/pmax settings?"
        )
    meta_file = wf.with_suffix(".json")
    if meta_file.exists():
        with meta_file.open() as fjson:
            loaded_meta = json.load(fjson)
        mismatch = {
            key: (loaded_meta[key], meta[key])
            for key in meta
            if key in loaded_meta and key != "window_configspace_file"
            and loaded_meta[key] != meta[key]
        }
        if mismatch:
            raise MetaInfoError(
                f"window fourier meta {meta_file} inconsistent with "
                f"current settings: {mismatch}"
            )
    return wal


def build_window_tables(
    cfg: EFTConfig,
    window_configspace_file=None,
    window_fourier_file=None,
    cache_dir=None,
    na: int | None = None,
    nl: int | None = None,
    nq: int = 3,
    pmax: float | None = None,
    accboost: int = 1,
    withmask: bool = True,
    windowk: float = 0.05,
    nmax: int = 4096,
    xmin_factor: float = 1.0,
    xmax_factor: float = 100.0,
    bias: float = -1.6,
    window_param: float | None = 1.0,
    window_st: bool = True,
    icc_tables: dict | None = None,
) -> dict:
    """Host (NumPy) window tables: the fused tensor ``wmat`` (+ the optional
    integral-constraint tables under ``icc``), as the JAX builder returns them."""
    na = na or cfg.nl
    nl = nl or cfg.nl
    if na > cfg.nl or nl > cfg.nl:
        raise ValueError(f"na={na}, nl={nl} exceed computed multipoles nl={cfg.nl}")
    if na > nl:
        raise ValueError(f"na={na} > nl={nl} is inconsistent")
    if pmax is None:
        pmax = float(cfg.k.max())
    p = window_kgrid(kmax=pmax, accboost=accboost)

    meta = dict(
        na=na, nl=nl, nq=nq, pmax=pmax, accboost=accboost, nmax=nmax,
        xmin_factor=xmin_factor, xmax_factor=xmax_factor, bias=bias,
        window_param=window_param, k=cfg.k.tolist(),
        window_configspace_file=str(window_configspace_file),
    )
    wal = None
    cache_path = None
    fourier_path = None
    if window_fourier_file is not None:
        # np.save APPENDS '.npy' to a suffix-less path: normalise up front so
        # that save and load name the same file
        fourier_path = Path(window_fourier_file)
        if fourier_path.suffix != ".npy":
            fourier_path = fourier_path.with_name(fourier_path.name + ".npy")
        wal = _load_fourier_file(fourier_path, cfg, p, na, nl, meta)
    if wal is None and cache_dir is not None:
        key = hashlib.sha256(json.dumps(meta, sort_keys=True).encode()).hexdigest()[:16]
        cache_path = Path(cache_dir) / f"window_{key}.npz"
        if cache_path.exists():
            wal = np.load(cache_path)["wal"]
            log.info("window: loaded cached matrix %s", cache_path)
    if wal is None:
        if window_configspace_file is None:
            raise ValueError("window_configspace_file required to compute the window")
        log.info(
            "window: computing W_al from %s (na=%d nl=%d nmax=%d, cached -> %s)",
            window_configspace_file, na, nl, nmax, cache_path,
        )
        sw, qq = load_configspace_window(window_configspace_file, nq)
        wal = compute_wal(
            cfg, sw, qq, p, na, nl, nmax=nmax, xmin_factor=xmin_factor,
            xmax_factor=xmax_factor, bias=bias, window_param=window_param,
        )
        if cache_path is not None:
            atomic_save_npz(cache_path, wal=wal, meta=json.dumps(meta))
        if fourier_path is not None:
            # write the matrix back with its meta sidecar (upstream _save_Wal,
            # window.py:361-369), so the next run loads instead of recomputing
            try:
                fourier_path.parent.mkdir(parents=True, exist_ok=True)
                np.save(fourier_path, wal)
                with fourier_path.with_suffix(".json").open("w") as fjson:
                    json.dump(meta, fjson, indent=2)
                log.info("window: saved fourier matrix %s", fourier_path)
            except OSError:
                log.warning(
                    "window: could not write fourier matrix back to %s — "
                    "the next run will recompute", fourier_path, exc_info=True,
                )

    waldk = mask_and_weight(cfg, wal, p, withmask=withmask, windowk=windowk)
    # fuse the per-evaluation cubic interpolation k -> p into the window tensor
    interp = spline_matrix(cfg.k, p)  # (np, nk)
    wmat = np.einsum("alkp,pj->alkj", waldk, interp)
    return dict(
        wmat=wmat, wal=wal, p=p, na=na, nl=nl, window_st=window_st,
        icc=icc_tables, meta=meta,
    )


def window_tables_to(wt: dict, device, dtype) -> dict:
    """Device form of host window tables: the convolution tensor (W − W_icc
    when the integral constraint is coupled, subtracted in float64 on the
    host) and the icc shot-noise column ``psn`` (None without icc)."""
    icc = wt.get("icc")
    wmat = wt["wmat"] - icc["wmat"] if icc is not None else wt["wmat"]
    return dict(
        wmat=torch.as_tensor(np.ascontiguousarray(wmat), dtype=dtype, device=device),
        psn=None if icc is None else torch.as_tensor(icc["psn"], dtype=dtype, device=device),
        window_st=bool(wt["window_st"]),
    )


def _convolve(wmat, x):
    return torch.einsum("alkj,...lnj->...ank", wmat, x)


def apply_window(wt: dict, cfg: EFTConfig, bird: BirdState) -> BirdState:
    """Convolve all P-side tensors (window.py:389-415), including the
    integral-constraint subtraction when coupled.  ``wt``: device tables of
    :func:`window_tables_to`."""
    wmat = wt["wmat"]
    out = bird._replace(
        p11l=_convolve(wmat, bird.p11l),
        pctl=_convolve(wmat, bird.pctl),
        ploopl=_convolve(wmat, bird.ploopl),
        pct_nnlo_l=_convolve(wmat, bird.pct_nnlo_l),
        pstl=_convolve(wmat, bird.pstl) if wt["window_st"] else bird.pstl,
    )
    if wt["psn"] is not None:
        out = out._replace(picc=bird.picc - wt["psn"])
    return out


# ---------------------------------------------------------------------------
# precomputed window matrices ("Florian" format, upstream window.py:418-577)
# ---------------------------------------------------------------------------
