"""2-D FFTLog for the integral-constraint double spherical-Bessel transform
(counterpart of ``eftpipe_tpu/ops/fftlog2d.py``).

Phase-A only (host NumPy, complex128).  Mirrors upstream eftpipe/fftlog2d.py
(41-160), with one deliberate divergence: upstream resamples the 2-D input
with ``scipy.interpolate.interp2d``, which was removed from SciPy; for the
regular (s1, s2) grids used here ``RectBivariateSpline`` (the documented
replacement, the same bicubic spline on gridded data) is used.
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import RectBivariateSpline
from scipy.special import loggamma


def bessel_matrix(p, l: int):
    """∫_0^∞ s^{2+p} j_l(s) ds via gamma functions (fftlog2d.py:14-38).

    Multiply by k^{-3-p} for the k dependence.
    """
    return np.sqrt(np.pi) * np.exp(
        (1.0 + p) * np.log(2.0) + loggamma(0.5 * (3.0 + l + p)) - loggamma(0.5 * (l - p))
    )


class HostFFTLog2D:
    """2-D power-law decomposition via fft2 (fftlog2d.py:41-104)."""

    def __init__(self, nx: int, ny: int, xmin: float, xmax: float,
                 ymin: float, ymax: float, xbias: float, ybias: float):
        self.nx, self.ny = nx, ny
        self.xmin, self.xmax = xmin, xmax
        self.ymin, self.ymax = ymin, ymax
        self.xbias, self.ybias = xbias, ybias
        self.dx = np.log(xmax / xmin) / (nx - 1)
        self.dy = np.log(ymax / ymin) / (ny - 1)
        self.x = np.geomspace(xmin, xmax, nx)
        self.y = np.geomspace(ymin, ymax, ny)
        self.xpow = xbias + 2j * np.pi * np.fft.fftfreq(nx, d=self.dx)
        self.ypow = ybias + 2j * np.pi * np.fft.fftfreq(ny, d=self.dy)

    def coef(self, xin, yin, zin, window: float | None = None) -> np.ndarray:
        """2-D coefficients; zero-padding outside the input domain."""
        spl = RectBivariateSpline(xin, yin, zin, kx=3, ky=3, s=0)
        farr = np.zeros((self.nx, self.ny))
        maskx = (self.x >= xin[0]) & (self.x <= xin[-1])
        masky = (self.y >= yin[0]) & (self.y <= yin[-1])
        farr[np.ix_(maskx, masky)] = spl(self.x[maskx], self.y[masky])

        detilt = np.outer(
            (self.x / self.x[0]) ** (-self.xbias),
            (self.y / self.y[0]) ** (-self.ybias),
        )
        norm = np.outer(self.x[0] ** self.xpow, self.y[0] ** self.ypow)
        out = np.fft.fft2(farr * detilt) / (self.nx * self.ny) / norm
        if window is not None:
            out *= self.window2d(window)
        return out

    def spherical_transform(self, xin, yin, zin, *, k1, k2, l1: int, l2: int,
                            window: float | None = None) -> np.ndarray:
        """∬ ds1 ds2 s1² s2² z(s1,s2) j_{l1}(k1 s1) j_{l2}(k2 s2) up to the
        reference's normalisation (fftlog2d.py:106-126)."""
        coef = self.coef(xin, yin, zin, window=window)  # (m, n)
        m1 = np.power(k1[:, None], (-3.0 - self.xpow)[None, :]) * bessel_matrix(self.xpow, l1)
        m2 = np.power(k2[:, None], (-3.0 - self.ypow)[None, :]) * bessel_matrix(self.ypow, l2)
        return np.einsum("mn,pm,qn->pq", coef, m1, m2, optimize=True).real

    def window2d(self, window: float) -> np.ndarray:
        """Separable cosine taper in fft2 frequency order (fftlog2d.py:128-160)."""

        def taper(n):
            f = np.fft.fftfreq(n, d=1.0)
            nf = int((1 - window) * n / 2)
            if nf >= n // 2:
                nf -= 1
            f_left, f_right = f[-nf], f[nf]
            f_min = f.min()
            f_max = -f_min
            w = np.ones(n)
            sel = f < f_left
            theta = (f[sel] - f_min) / (f_left - f_min)
            w[sel] = theta - np.sin(2 * np.pi * theta) / (2 * np.pi)
            sel = f > f_right
            theta = (f_max - f[sel]) / (f_max - f_right)
            w[sel] = theta - np.sin(2 * np.pi * theta) / (2 * np.pi)
            return w

        return np.outer(taper(self.nx), taper(self.ny))
