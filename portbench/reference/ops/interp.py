"""Cubic-spline and fixed-grid interpolation (counterpart of
``eftpipe_tpu/ops/interp.py``).

1. ``spline_matrix(xin, xout)`` — host NumPy: a constant matrix ``M`` with
   ``M @ f == scipy CubicSpline(xin, f)(xout)`` (not-a-knot, end-segment
   polynomial extrapolation).  Cubic-spline interpolation is linear in the
   data, so wherever the evaluation points are fixed the interpolation is one
   constant matmul per evaluation.

2. ``SplineTable`` / ``spline_eval`` — evaluation of a not-a-knot cubic
   spline at query points that depend on the sampled parameters (the AP
   effect's distorted k' grid).  The second derivatives at the nodes are
   linear in the data: ``m = M2 @ f`` with ``M2`` a host-built constant.

3. ``MatmulInterp`` — linear interpolation on a fixed sorted grid with the
   segment lookups written as one-hot contractions; bitwise equal to the
   gather form of the same formula in IEEE arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch
from dataclasses import dataclass, field
from scipy.interpolate import CubicSpline


def spline_matrix(xin, xout, log_x: bool = False) -> np.ndarray:
    """Constant (m, n) float64 matrix form of a not-a-knot cubic spline.

    ``xout`` may lie outside [xin[0], xin[-1]]: the end-segment polynomial is
    extrapolated (``fill_value="extrapolate"``).  ``log_x`` interpolates in
    log(x)."""
    xin = np.asarray(xin, dtype=np.float64)
    xout = np.asarray(xout, dtype=np.float64)
    if log_x:
        xin, xout = np.log(xin), np.log(xout)
    n = xin.size
    eye = np.eye(n)
    cs = CubicSpline(xin, eye, axis=0, extrapolate=True)
    return cs(xout)  # (m, n)


def _notaknot_second_derivative_matrix(x: np.ndarray) -> np.ndarray:
    """Matrix M2 with ``m = M2 @ y`` = second derivatives of the not-a-knot
    cubic spline through (x, y) at the nodes."""
    n = x.size
    eye = np.eye(n)
    cs = CubicSpline(x, eye, axis=0)
    return cs(x, 2)


def segment_index(q, x):
    """Containing segment of each query on the sorted grid ``x`` (n,):
    #{j in [1, n-1): x[j] <= q} = clip(searchsorted(x, q, 'right') - 1, 0,
    n - 2).  ``q`` has any shape; returns int64 of that shape."""
    n = x.shape[0]
    return (q[..., None] >= x[1 : n - 1]).sum(dim=-1)


@dataclass(frozen=True)
class MatmulInterp:
    """Linear interpolation on a FIXED sorted grid with per-evaluation
    queries and data, the segment gathers written as one-hot contractions.

    A one-hot product is exact in IEEE arithmetic (each output is a sum of
    exact zeros and one ``1·x`` term), so the result is BITWISE equal to the
    gather form ``f0 + (delta/dx)·df`` with the segment choice of
    ``searchsorted(xp, q, 'right')`` and the endpoint clamping of
    ``np.interp``.  (The JAX counterpart's compiled ``a + b·c`` is contracted
    to an FMA, so the two packages agree to a few ulp, not bitwise.)"""

    xp: np.ndarray  # (n,) sorted grid
    # the grid as a tensor, made once per (device, dtype): a host-to-device
    # copy per call would synchronise the stream
    _grids: dict = field(default_factory=dict, compare=False, repr=False)

    @classmethod
    def build(cls, xp) -> "MatmulInterp":
        xp = np.asarray(xp, np.float64)
        if not np.all(np.diff(xp) > 0):
            raise ValueError("MatmulInterp needs a strictly increasing grid")
        return cls(xp=xp)

    def _grid(self, like):
        key = (like.device, like.dtype)
        if key not in self._grids:
            self._grids[key] = torch.as_tensor(self.xp, dtype=like.dtype, device=like.device)
        return self._grids[key]

    def interp(self, q, fp):
        """Interpolate ``fp`` at ``q``; q: (...,) queries, fp: (..., n)
        data values (leading axes broadcast).  Clamps to the endpoint values
        outside the grid."""
        xp = self._grid(q)
        n = self.xp.size
        qshape = q.shape
        qf = q.reshape(-1)
        idx = segment_index(qf, xp)
        onehot = (idx[:, None] == torch.arange(n - 1, device=q.device)[None, :]).to(q.dtype)
        x0 = torch.einsum("qj,j->q", onehot, xp[: n - 1])
        x1 = torch.einsum("qj,j->q", onehot, xp[1:])
        f0 = torch.einsum("qj,...j->...q", onehot, fp[..., : n - 1])
        f1 = torch.einsum("qj,...j->...q", onehot, fp[..., 1:])
        out = f0 + ((qf - x0) / (x1 - x0)) * (f1 - f0)
        out = torch.where(qf <= xp[0], fp[..., :1], out)
        out = torch.where(qf >= xp[-1], fp[..., -1:], out)
        return out.reshape(out.shape[:-1] + qshape)

    def interp_rows(self, q, fp):
        """Row-wise interpolation: q (..., m) queries and fp (..., n) data
        with the SAME leading axes (one query grid per walker) → (..., m).
        The gather form of :meth:`interp`'s formula, segment choice and
        clamping (a per-walker one-hot would be (W, m, n) large)."""
        xp = self._grid(q)
        n = self.xp.size
        # #{j in [1, n-1): xp[j] <= q}, as segment_index
        idx = torch.searchsorted(xp[1 : n - 1].contiguous(), q.contiguous(), right=True)
        x0, x1 = xp[idx], xp[idx + 1]
        f0, f1 = torch.gather(fp, -1, idx), torch.gather(fp, -1, idx + 1)
        out = f0 + ((q - x0) / (x1 - x0)) * (f1 - f0)
        out = torch.where(q <= xp[0], fp[..., :1], out)
        return torch.where(q >= xp[-1], fp[..., -1:], out)


@dataclass(frozen=True)
class SplineTable:
    """Host-precomputed constants of a cubic spline on fixed nodes; the
    fields become tensors after ``to_device``."""

    x: np.ndarray   # (n,) node locations
    m2: np.ndarray  # (n, n) second-derivative operator
    h: np.ndarray   # (n-1,) segment widths

    @classmethod
    def build(cls, x) -> "SplineTable":
        x = np.asarray(x, dtype=np.float64)
        return cls(x=x, m2=_notaknot_second_derivative_matrix(x), h=np.diff(x))


def spline_eval(table: SplineTable, y, xq):
    """Evaluate the not-a-knot cubic spline through (table.x, y) at xq.

    y : (..., n) data values; xq : (...q) query points (outside the domain
    the end-segment cubic is extrapolated).  Returns (..., *xq.shape); the
    leading axes of y broadcast over xq."""
    x = torch.as_tensor(table.x, dtype=y.dtype, device=y.device)
    h = torch.as_tensor(table.h, dtype=y.dtype, device=y.device)
    m2 = torch.as_tensor(table.m2, dtype=y.dtype, device=y.device)
    m = y @ m2.T  # (..., n) second derivatives

    qshape = xq.shape
    xq = xq.reshape(-1)
    idx = segment_index(xq, x)
    x0 = x[idx]
    hi = h[idx]
    t = (xq - x0) / hi
    y0, y1 = y[..., idx], y[..., idx + 1]
    m0, m1 = m[..., idx], m[..., idx + 1]
    # Hermite form in terms of second derivatives:
    # S(t) = y0 (1-t) + y1 t + h^2/6 [ m0 ((1-t)^3-(1-t)) + m1 (t^3-t) ]
    u = 1.0 - t
    out = y0 * u + y1 * t + hi * hi / 6.0 * (m0 * (u * u * u - u) + m1 * (t * t * t - t))
    return out.reshape(out.shape[:-1] + qshape)
