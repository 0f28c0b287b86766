"""Host-side LCDM background helpers (reference pybird.py:18-42).

Used for fiducial quantities and for providers that fix the background at
configuration time.  The on-device (batched tensor) versions live in eh98.py.
"""

from __future__ import annotations

import numpy as np
from scipy.integrate import quad


def _ch(om: float, a: float) -> float:
    return np.sqrt(om / a + a * a * (1 - om))


def growth_factor_lcdm(om: float, z: float) -> float:
    """Unnormalised D(z) (pybird.py:23-25)."""
    a = 1.0 / (1.0 + z)
    return 2.5 * om * _ch(om, a) / a * quad(lambda x: _ch(om, x) ** -3, 0, a)[0]


def growth_rate_lcdm(om: float, z: float) -> float:
    """f(z) = dlnD/dlna for flat LCDM (pybird.py:28-31)."""
    a = 1.0 / (1.0 + z)
    dg = growth_factor_lcdm(om, z)
    return (om * (5 * a - 3 * dg)) / (2.0 * (a**3 * (1 - om) + om) * dg)
