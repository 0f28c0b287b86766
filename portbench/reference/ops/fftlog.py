"""FFTLog — decomposition of a log-sampled function into complex power laws
(counterpart of ``eftpipe_tpu/ops/fftlog.py``).

``f(x) ≈ Σ_n c_n x^(bias + i η_n)`` with equally log-spaced frequencies η_n.

* ``HostFFTLog`` — NumPy/complex128, Phase-A table construction.  Behaviour
  mirrors upstream pybird/fftlog.py:43-166: power-law extrapolation at both
  ends, a cosine-taper spectral window, an optional multiplicative kernel.

* ``FFTLogPlan`` + ``fftlog_coef`` — the per-evaluation path.  For a fixed
  input grid the cubic-spline resampling onto the FFTLog grid is a constant
  matrix, and the small FFT (N ≤ 256) is a dense DFT matmul fused with the
  coefficient normalisation and the spectral window: two real matmuls per
  transform, batched over walkers, no complex dtype.  The power-law
  extrapolation beyond the input range is the only nonlinear piece.
"""

from __future__ import annotations

import numpy as np
import torch
from dataclasses import dataclass

from .interp import spline_matrix


def spectral_window(n: int, window: float = 1.0, left: bool = True, right: bool = True) -> np.ndarray:
    """Cosine taper sending the highest FFT frequencies to zero (upstream
    ``CoefWindow``, pybird/fftlog.py:17-40): frequencies are indexed
    m = -n/2 .. n/2 and the outer ``(1-window)`` fraction on each side is
    damped by θ - sin(2πθ)/(2π)."""
    m = np.arange(-(n // 2), n // 2 + 1)
    m_cut = n // 2 if window == 1 else int(window * n // 2.0)
    right_edge = m[-1] - m_cut
    left_edge = m[0] + m_cut
    w = np.ones(m.size)
    if right:
        sel = m > right_edge
        theta = (m[-1] - m[sel]) / float(m[-1] - right_edge - 1)
        w[sel] = theta - np.sin(2 * np.pi * theta) / (2 * np.pi)
    if left:
        sel = m < left_edge
        theta = (m[sel] - m[0]) / float(left_edge - m[0] - 1)
        w[sel] = theta - np.sin(2 * np.pi * theta) / (2 * np.pi)
    return w


class HostFFTLog:
    """NumPy FFTLog for Phase-A table construction (complex128): ``n`` even
    number of grid points on [xmin, xmax] (log-spaced, endpoints inclusive),
    ``bias`` the power-law tilt divided out before the FFT."""

    def __init__(self, n: int, xmin: float, xmax: float, bias: float):
        if n % 2 != 0:
            raise ValueError(f"FFTLog size must be even, got {n}")
        self.n = n
        self.xmin = xmin
        self.xmax = xmax
        self.bias = bias
        self.dx = np.log(xmax / xmin) / (n - 1.0)
        self.x = xmin * np.exp(self.dx * np.arange(n))
        # n+1 complex exponents, symmetric about the bias
        freq = 2.0 * np.pi / (n * self.dx) * (np.arange(n + 1) - n / 2.0)
        self.pow = self.bias + 1j * freq
        self._norm = self.xmin ** (-self.pow) / float(n)

    def _fill_grid(self, xin, f, extrap, log_interp, kernel):
        """Resample f onto the FFTLog grid (times the bias de-tilt factor)."""
        xin = np.asarray(xin, dtype=np.float64)
        f = np.asarray(f, dtype=np.float64)
        if isinstance(extrap, str):
            extrap = (extrap, extrap)
        for e in extrap:
            if e not in ("extrap", "padding"):
                raise ValueError(f"unknown extrap mode {e!r}")

        ileft = int(np.searchsorted(self.x, xin[0]))
        iright = int(np.searchsorted(self.x, xin[-1], side="right"))
        xmid = self.x[ileft:iright]

        detilt = np.exp(-self.bias * np.arange(ileft, iright) * self.dx)
        if kernel is not None:
            if tuple(extrap) != ("padding", "padding") and (
                    ileft > 0 or iright < self.n):
                raise ValueError(
                    "kernel= requires extrap='padding': the power-law "
                    "extrapolation branches do not carry the kernel factor")
            detilt = detilt * kernel(xmid)
        if xin.size <= 512:
            smat = spline_matrix(xin, xmid, log_x=log_interp)
            fmid = f @ smat.T
        else:
            # large input grids: building the (m, n) spline operator costs
            # O(n²) — spline the data directly instead
            from scipy.interpolate import CubicSpline

            xi, xo = (np.log(xin), np.log(xmid)) if log_interp else (xin, xmid)
            fmid = CubicSpline(xi, f, axis=-1, extrapolate=True)(xo)
        fmid = fmid * detilt
        fx = np.zeros(fmid.shape[:-1] + (self.n,), dtype=np.float64)
        fx[..., ileft:iright] = fmid

        if extrap[0] == "extrap" and ileft > 0:
            slope = (np.log(f[..., 1:2]) - np.log(f[..., 0:1])) / np.log(xin[1] / xin[0])
            amp = f[..., 0:1]
            fac = np.exp(-self.bias * np.arange(ileft) * self.dx)
            fx[..., :ileft] = amp * (self.x[:ileft] / xin[0]) ** slope * fac
        if extrap[1] == "extrap" and iright < self.n:
            slope = (np.log(f[..., -1:]) - np.log(f[..., -2:-1])) / np.log(xin[-1] / xin[-2])
            amp = f[..., -1:]
            fac = np.exp(-self.bias * np.arange(iright, self.n) * self.dx)
            fx[..., iright:] = amp * (self.x[iright:] / xin[-1]) ** slope * fac
        return fx

    def coef(self, xin, f, extrap="extrap", window: float | None = 1.0, log_interp=False, kernel=None):
        """FFTLog coefficients c_n, shape ``f.shape[:-1] + (n+1,)`` complex
        (upstream ``FFTLog.Coef``, pybird/fftlog.py:84-166): ``window=None``
        halves the two edge coefficients instead of tapering."""
        fx = self._fill_grid(xin, f, extrap, log_interp, kernel)
        spec = np.fft.rfft(fx, axis=-1)  # (..., n/2+1)
        coef = np.empty(fx.shape[:-1] + (self.n + 1,), dtype=complex)
        coef[..., : self.n // 2] = np.conj(spec[..., 1:][..., ::-1])
        coef[..., self.n // 2 :] = spec
        coef *= self._norm
        if window is not None:
            coef *= spectral_window(self.n, window)
        else:
            coef[..., 0] /= 2.0
            coef[..., -1] /= 2.0
        return coef

    def dft_matrix(self, window: float | None = 1.0) -> np.ndarray:
        """Dense matrix G with ``coef == fx @ G`` (fx the de-tilted grid
        values): G[t, j] = exp(-2πi (j - n/2) t / n) · norm[j] · w[j]."""
        t = np.arange(self.n)[:, None]
        j = np.arange(self.n + 1)[None, :] - self.n / 2.0
        g = np.exp(-2j * np.pi * j * t / self.n) * self._norm[None, :]
        if window is not None:
            g = g * spectral_window(self.n, window)[None, :]
        else:
            g = g.copy()
            g[:, 0] /= 2.0
            g[:, -1] /= 2.0
        return g


@dataclass(frozen=True)
class FFTLogPlan:
    """Constants of a per-evaluation FFTLog of data on a FIXED input grid.

    Built once on the host (float64 NumPy) by :func:`make_plan`; the array
    fields become tensors of the run-time dtype after ``to_device``."""

    n: int
    ileft: int
    iright: int
    smid: np.ndarray  # (iright-ileft, n_in) spline resampling × de-tilt
    # low-side extrapolation constants (empty arrays when padding)
    lo_logx: np.ndarray  # log(x[:ileft]/xin[0])
    lo_fac: np.ndarray   # de-tilt on [0, ileft)
    lo_dlog: float       # log(xin[1]/xin[0])
    hi_logx: np.ndarray
    hi_fac: np.ndarray
    hi_dlog: float
    extrap_lo: bool
    extrap_hi: bool
    gre: np.ndarray  # (n, n+1) Re of fused DFT·norm·window
    gim: np.ndarray  # (n, n+1) Im


def make_plan(fft: HostFFTLog, xin, extrap="extrap", window: float | None = 1.0, log_interp=False) -> FFTLogPlan:
    xin = np.asarray(xin, dtype=np.float64)
    if isinstance(extrap, str):
        extrap = (extrap, extrap)
    ileft = int(np.searchsorted(fft.x, xin[0]))
    iright = int(np.searchsorted(fft.x, xin[-1], side="right"))
    xmid = fft.x[ileft:iright]
    detilt = np.exp(-fft.bias * np.arange(ileft, iright) * fft.dx)
    smid = spline_matrix(xin, xmid, log_x=log_interp) * detilt[:, None]
    g = fft.dft_matrix(window)
    return FFTLogPlan(
        n=fft.n,
        ileft=ileft,
        iright=iright,
        smid=smid,
        lo_logx=np.log(fft.x[:ileft] / xin[0]),
        lo_fac=np.exp(-fft.bias * np.arange(ileft) * fft.dx),
        lo_dlog=float(np.log(xin[1] / xin[0])),
        hi_logx=np.log(fft.x[iright:] / xin[-1]),
        hi_fac=np.exp(-fft.bias * np.arange(iright, fft.n) * fft.dx),
        hi_dlog=float(np.log(xin[-1] / xin[-2])),
        extrap_lo=extrap[0] == "extrap" and ileft > 0,
        extrap_hi=extrap[1] == "extrap" and iright < fft.n,
        gre=np.ascontiguousarray(g.real),
        gim=np.ascontiguousarray(g.imag),
    )


def _t(a, like):
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def fftlog_coef(plan: FFTLogPlan, f):
    """FFTLog coefficients of ``f`` (..., n_in) sampled on the plan's input
    grid; ``f`` must be positive at the two first/last samples where the
    corresponding extrapolation is on.  Returns (cre, cim), each (..., n+1).
    The plan may hold NumPy arrays or tensors already on ``f``'s device."""
    parts = []
    if plan.ileft > 0:
        if plan.extrap_lo:
            slope = (torch.log(f[..., 1:2]) - torch.log(f[..., 0:1])) / plan.lo_dlog
            lo = f[..., 0:1] * torch.exp(slope * _t(plan.lo_logx, f))
            lo = lo * _t(plan.lo_fac, f)
        else:
            lo = f.new_zeros(f.shape[:-1] + (plan.ileft,))
        parts.append(lo)
    parts.append(f @ _t(plan.smid, f).T)
    if plan.iright < plan.n:
        if plan.extrap_hi:
            slope = (torch.log(f[..., -1:]) - torch.log(f[..., -2:-1])) / plan.hi_dlog
            hi = f[..., -1:] * torch.exp(slope * _t(plan.hi_logx, f))
            hi = hi * _t(plan.hi_fac, f)
        else:
            hi = f.new_zeros(f.shape[:-1] + (plan.n - plan.iright,))
        parts.append(hi)
    fx = torch.cat(parts, dim=-1)
    return fx @ _t(plan.gre, f), fx @ _t(plan.gim, f)
