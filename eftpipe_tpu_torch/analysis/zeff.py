"""Effective redshift from a random catalogue (a copy of
``eftpipe_tpu/analysis/zeff.py``): pair-weighted mean redshift over
pairs with separation in [smin, smax], using comoving positions from (RA,
DEC, z) under a flat-LCDM fiducial cosmology.  The O(N²) pair sum runs in
the native C++ library (``eftpipe_tpu_torch/native``) with a chunked NumPy fallback.
"""

from __future__ import annotations

import numpy as np
from dataclasses import dataclass

from .. import native
from .convert import hubble

C_KMS = 299792.458


def sky_to_cartesian(ra, dec, dist, is_radian: bool = False):
    """(RA, DEC, comoving distance) → cartesian (reference zeff.py:8-15)."""
    if not is_radian:
        ra = np.asarray(ra) * np.pi / 180.0
        dec = np.asarray(dec) * np.pi / 180.0
    x = dist * np.cos(dec) * np.cos(ra)
    y = dist * np.cos(dec) * np.sin(ra)
    z = dist * np.sin(dec)
    return x, y, z


@dataclass
class ComovingDistance:
    """Vectorised comoving distance [Mpc/h·(100/h)=Mpc? — Mpc for h=H0/100]
    via a cumulative-trapezoid table (reference zeff.py:18-39 uses per-point
    quad; a dense table is equivalent to <1e-6 and vectorises)."""

    omegam: float
    zmax: float = 5.0
    npts: int = 20_000

    def __post_init__(self):
        zg = np.linspace(0.0, self.zmax, self.npts)
        hz = 100.0 * np.sqrt(self.omegam * (1 + zg) ** 3 + 1 - self.omegam)
        integ = C_KMS / hz
        table = np.concatenate([[0.0], np.cumsum(0.5 * (integ[1:] + integ[:-1]) * np.diff(zg))])
        self._zg, self._table = zg, table

    def __call__(self, z):
        return np.interp(np.asarray(z), self._zg, self._table)


def effective_redshift(
    ra, dec, z, weight=None, omegam: float = 0.31,
    smin: float = 25.0, smax: float = 150.0,
) -> float:
    """z_eff = Σ_pairs w_i w_j (z_i+z_j)/2 / Σ_pairs w_i w_j with the pair
    separation window (reference zeff.py pair kernel)."""
    z = np.asarray(z, dtype=np.float64)
    weight = np.ones_like(z) if weight is None else np.asarray(weight, np.float64)
    dist = ComovingDistance(omegam)(z)
    x, y, zz = sky_to_cartesian(ra, dec, dist)
    num, den = native.pair_zeff(x, y, zz, z, weight, smin=smin, smax=smax)
    if den == 0:
        raise ValueError("no pairs inside the separation window")
    return num / den
