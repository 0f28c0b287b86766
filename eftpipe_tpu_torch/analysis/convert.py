"""BAO/RSD parameter conversions (a copy of
``eftpipe_tpu/analysis/convert.py``, host NumPy/SciPy).

Converts template-fit parameters (fσ8, α⊥, α∥) into distance ratios
DH/r_d, DM/r_d, DV/r_d given the fiducial cosmology the template was built
with, and provides growth factor/rate quadratures for parameter-space
conversions (Ωm, σ8) on chains.
"""

from __future__ import annotations

import numpy as np
from dataclasses import dataclass
from scipy.integrate import quad

C_KMS = 299792.458


def hubble(om: float, z: float) -> float:
    """Dimensionless H(z)/H0 (flat LCDM)."""
    return float(np.sqrt(om * (1 + z) ** 3 + (1 - om)))


def comoving_distance(om: float, z: float) -> float:
    """Dimensionless H0·DC."""
    return quad(lambda x: 1.0 / hubble(om, x), 0.0, z)[0]


def growth_factor(om: float, z: float) -> float:
    """Unnormalised D(z) ∝ H ∫ da/(aH)³ (analysis.py growth quadrature)."""
    a = 1.0 / (1.0 + z)
    integ = quad(lambda x: 1.0 / (x * hubble(om, 1.0 / x - 1.0)) ** 3, 1e-5, a)[0]
    return 2.5 * om * hubble(om, z) * integ


def growth_rate(om: float, z: float, dz: float = 1e-4) -> float:
    """f = dlnD/dlna by central difference of the quadrature."""
    zp, zm = z + dz, z - dz
    lnd = np.log(growth_factor(om, zp) / growth_factor(om, zm))
    lna = np.log((1 + zm) / (1 + zp))
    return float(lnd / lna)


@dataclass
class LssConvertor:
    """Fiducial-cosmology context for template-fit conversions.

    Parameters mirror the reference: the template cosmology's Ωm, h and the
    sound horizon r_d [Mpc] at which the (α⊥, α∥) were defined.
    """

    om_fid: float
    h_fid: float
    rdrag_fid: float  # Mpc
    z: float

    # -- fiducial distances (Mpc) ------------------------------------------
    @property
    def dh_fid(self) -> float:
        """DH = c/H(z) in Mpc."""
        return C_KMS / (100.0 * self.h_fid * hubble(self.om_fid, self.z))

    @property
    def dm_fid(self) -> float:
        """Comoving transverse distance DM in Mpc (flat)."""
        return C_KMS / (100.0 * self.h_fid) * comoving_distance(self.om_fid, self.z)

    @property
    def dv_fid(self) -> float:
        return (self.z * self.dm_fid**2 * self.dh_fid) ** (1.0 / 3.0)

    # -- conversions (vectorised over chain columns) -------------------------
    def dm_over_rd(self, alperp) -> np.ndarray:
        return np.asarray(alperp) * self.dm_fid / self.rdrag_fid

    def dh_over_rd(self, alpara) -> np.ndarray:
        return np.asarray(alpara) * self.dh_fid / self.rdrag_fid

    def dv_over_rd(self, alperp, alpara) -> np.ndarray:
        dm = self.dm_over_rd(alperp)
        dh = self.dh_over_rd(alpara)
        return (self.z * dm**2 * dh) ** (1.0 / 3.0)

    def fsigma8(self, f, sigma8_z) -> np.ndarray:
        return np.asarray(f) * np.asarray(sigma8_z)

    def sigma8_z(self, sigma8_0, om=None) -> np.ndarray:
        """Scale σ8(0) to z with the fiducial (or given) growth history."""
        om = self.om_fid if om is None else om
        d = growth_factor(om, self.z) / growth_factor(om, 0.0)
        return np.asarray(sigma8_0) * d
