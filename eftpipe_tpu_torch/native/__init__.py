"""Native (C++) host-side helpers with a NumPy fallback (a copy of
``eftpipe_tpu/native/``).

``loadtxt(path)`` — fast whitespace-table parser (the reference flags its icc
table load at ~1 min with pandas / ~10 min with np.loadtxt, icc.py:90-95).
``panel_to_ndarray(arr)`` — the (l1,l2,s1,s2,value) → 4-D scatter, the C++
equivalent of the reference's optional numba kernel (icc.py:50-77).
``pair_zeff`` — the pair sums of the effective redshift.

The shared library is compiled from ``panelio.cpp`` on first use with g++
into ``build/eftpipe_tpu_torch/`` beside the package (the directory of
``ops/_build.py``; never next to the source), keyed by the source's hash
and the host's CPU features.  ``available()`` reports whether the native
path is active.  This is host code, not a kernel of the port: every entry
point falls back to NumPy if compilation or loading fails, as in the JAX
package, so the package works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import numpy as np
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "panelio.cpp"
_lock = threading.Lock()
_lib = None
_tried = False


def _host_key() -> str:
    """Fingerprint of the CPU ISA the cached .so was compiled for.  The
    library is built with -march=native, so a binary carried to a host with a
    different feature set would SIGILL at first call rather than fail to
    load — rebuild unless the fingerprint matches."""
    import hashlib

    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith(("flags", "features")):
                    return hashlib.sha256(
                        " ".join(sorted(line.split(":", 1)[1].split())).encode()
                    ).hexdigest()[:16]
    except OSError:
        pass
    import platform

    return hashlib.sha256(platform.machine().encode()).hexdigest()[:16]


def _lib_path() -> Path:
    """The library's path: keyed by the source's hash and the host's CPU
    features (it is built with -march=native, so a binary carried to a host
    with another feature set would SIGILL at its first call)."""
    import hashlib

    from ..ops._build import build_dir

    h = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    return build_dir() / f"libpanelio_{h}_{_host_key()}.so"


def _build(lib: Path) -> bool:
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120)
        if res.returncode != 0:
            return False
        os.replace(tmp, lib)
        return True
    except Exception:
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _lib_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.parse_table.restype = ctypes.c_int
        lib.parse_table.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.free_buffer.argtypes = [ctypes.POINTER(ctypes.c_double)]
        lib.panel_scatter.restype = ctypes.c_int
        dptr = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
        lib.panel_scatter.argtypes = [
            dptr, ctypes.c_int64, dptr, ctypes.c_int64, dptr, ctypes.c_int64,
            dptr, ctypes.c_int64, dptr, ctypes.c_int64, dptr,
        ]
        lib.pair_zeff.restype = ctypes.c_int
        lib.pair_zeff.argtypes = [
            dptr, dptr, dptr, dptr, dptr, ctypes.c_int64,
            dptr, dptr, dptr, dptr, dptr, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double, ctypes.c_int, dptr,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def loadtxt(path) -> np.ndarray:
    """Fast text-table reader; comment lines (#) skipped.  Falls back to
    np.loadtxt when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return np.loadtxt(path)
    out = ctypes.POINTER(ctypes.c_double)()
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    code = lib.parse_table(str(path).encode(), ctypes.byref(out),
                           ctypes.byref(rows), ctypes.byref(cols))
    if code != 0:
        if code == 1:
            raise FileNotFoundError(path)
        raise ValueError(f"native parse of {path} failed (code {code})")
    n = rows.value * cols.value
    try:
        arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.free_buffer(out)
    return arr.reshape(rows.value, cols.value)


def pair_zeff(x1, y1, z1, red1, w1, x2=None, y2=None, z2=None, red2=None,
              w2=None, smin: float = 25.0, smax: float = 150.0):
    """Pair-weighted (numerator, denominator) of the effective redshift over
    a random catalogue with smin < |r_i - r_j| < smax (the numba kernel of
    reference script/zeff.py).  Single-catalogue mode when the second set is
    omitted.  Falls back to a chunked NumPy implementation."""
    same = x2 is None
    arrs1 = [np.ascontiguousarray(a, dtype=np.float64) for a in (x1, y1, z1, red1, w1)]
    arrs2 = arrs1 if same else [
        np.ascontiguousarray(a, dtype=np.float64) for a in (x2, y2, z2, red2, w2)
    ]
    lib = _load()
    if lib is not None:
        out = np.zeros(2)
        lib.pair_zeff(*arrs1, arrs1[0].size, *arrs2, arrs2[0].size,
                      smin, smax, int(same), out)
        return out[0], out[1]
    # NumPy fallback: chunked pairwise distances
    X1 = np.stack(arrs1[:3], axis=1)
    X2 = np.stack(arrs2[:3], axis=1)
    r1, w1v = arrs1[3], arrs1[4]
    r2, w2v = arrs2[3], arrs2[4]
    num = den = 0.0
    chunk = 2048
    for i0 in range(0, X1.shape[0], chunk):
        sl = slice(i0, i0 + chunk)
        d2 = ((X1[sl, None, :] - X2[None, :, :]) ** 2).sum(-1)
        mask = (d2 > smin**2) & (d2 < smax**2)
        if same:
            jj = np.arange(X2.shape[0])[None, :]
            ii = np.arange(i0, min(i0 + chunk, X1.shape[0]))[:, None]
            mask &= jj > ii
        ww = w1v[sl, None] * w2v[None, :] * mask
        num += float((ww * 0.5 * (r1[sl, None] + r2[None, :])).sum())
        den += float(ww.sum())
    return num, den


def panel_to_ndarray(arr: np.ndarray):
    """(l1,l2,s1,s2,value) rows -> (value[l1,l2,s1,s2], grids meta); native
    scatter when available, NumPy otherwise (reference icc.py:50-77)."""
    arr = np.ascontiguousarray(arr, dtype=np.float64)
    grids = [np.ascontiguousarray(np.unique(c)) for c in arr.T[:4]]
    shape = tuple(g.size for g in grids)
    if arr.shape[0] != int(np.prod(shape)):
        raise ValueError("panel table is not a complete grid")
    meta = dict(l1=grids[0], l2=grids[1], s1=grids[2], s2=grids[3])
    lib = _load()
    if lib is None:
        idx = (
            np.searchsorted(grids[0], arr[:, 0]) * (shape[1] * shape[2] * shape[3])
            + np.searchsorted(grids[1], arr[:, 1]) * (shape[2] * shape[3])
            + np.searchsorted(grids[2], arr[:, 2]) * shape[3]
            + np.searchsorted(grids[3], arr[:, 3])
        )
        out = np.empty(int(np.prod(shape)))
        out[idx] = arr[:, 4]
        return out.reshape(shape), meta
    out = np.zeros(shape, dtype=np.float64)
    code = lib.panel_scatter(
        arr, arr.shape[0],
        grids[0], shape[0], grids[1], shape[1],
        grids[2], shape[2], grids[3], shape[3],
        out.reshape(-1),
    )
    if code != 0:
        raise ValueError("panel row outside the inferred grids")
    return out, meta
