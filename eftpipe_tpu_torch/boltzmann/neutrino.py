"""Neutrino-hierarchy mass handling (a copy of
``eftpipe_tpu/boltzmann/neutrino.py``, host SciPy).

Given the summed mass Σm_ν and the measured mass-squared splittings, solve
for the individual masses in the normal or inverted hierarchy, and produce
the Boltzmann-code argument dict (N_ur / N_ncdm / m_ncdm) that the reference
injects into CLASS.  Pure host-side math (scipy brentq); the output feeds the
host Boltzmann bridge or an emulator.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import brentq

# PDG-style mass-squared splittings in eV² (defaults match the reference's
# classynu configuration)
DELTA_M21_SQ = 7.5e-5
DELTA_M31_SQ_NH = 2.55e-3   # m3² − m1² > 0 (normal)
DELTA_M32_SQ_IH = -2.45e-3  # m3² − m2² < 0 (inverted)


def minimal_mass_sum(hierarchy: str = "normal",
                     dm21: float = DELTA_M21_SQ,
                     dm31: float = DELTA_M31_SQ_NH,
                     dm32: float = DELTA_M32_SQ_IH) -> float:
    """Smallest Σm_ν consistent with the splittings (lightest state massless)."""
    if hierarchy in ("normal", "NH", "nh"):
        return float(np.sqrt(dm21) + np.sqrt(dm31))
    m2 = np.sqrt(-dm32)
    m1 = np.sqrt(m2**2 - dm21)
    return float(m1 + m2)


def get_masses(mnu_sum: float, hierarchy: str = "normal",
               dm21: float = DELTA_M21_SQ,
               dm31: float = DELTA_M31_SQ_NH,
               dm32: float = DELTA_M32_SQ_IH) -> tuple[float, float, float]:
    """(m1, m2, m3) in eV from Σm_ν and the splittings (classy.py:12-49).

    Normal: m1 < m2 < m3 with m2² = m1² + Δm21², m3² = m1² + Δm31².
    Inverted: m3 < m1 < m2 with m1² = m2² − Δm21², m3² = m2² + Δm32².
    """
    if mnu_sum == 0.0:
        return 0.0, 0.0, 0.0
    floor = minimal_mass_sum(hierarchy, dm21, dm31, dm32)
    if mnu_sum < floor - 1e-12:
        raise ValueError(
            f"sum m_nu = {mnu_sum} below the minimal {hierarchy} value {floor:.4f}"
        )
    if hierarchy in ("normal", "NH", "nh"):
        def total(m1):
            return m1 + np.sqrt(m1**2 + dm21) + np.sqrt(m1**2 + dm31) - mnu_sum

        m1 = brentq(total, 0.0, mnu_sum)
        return (float(m1), float(np.sqrt(m1**2 + dm21)),
                float(np.sqrt(m1**2 + dm31)))
    if hierarchy in ("inverted", "IH", "ih"):
        def total(m2):
            m1sq = m2**2 - dm21
            m3sq = m2**2 + dm32
            return np.sqrt(m1sq) + m2 + np.sqrt(max(m3sq, 0.0)) - mnu_sum

        lo = max(np.sqrt(dm21), np.sqrt(-dm32))
        m2 = brentq(total, lo, mnu_sum)
        return (float(np.sqrt(m2**2 - dm21)), float(m2),
                float(np.sqrt(max(m2**2 + dm32, 0.0))))
    if hierarchy in ("degenerate", "single"):
        return (mnu_sum / 3.0,) * 3
    raise ValueError(f"unknown hierarchy {hierarchy!r}")


def neutrino_boltzmann_args(mnu_sum: float, hierarchy: str = "normal",
                            neff: float = 3.044,
                            mass_threshold: float = 1e-5) -> dict:
    """CLASS-style argument dict (classy.py:156-177): massive states become
    ncdm species, the remainder stays ultra-relativistic."""
    masses = get_masses(mnu_sum, hierarchy)
    massive = [m for m in masses if m > mass_threshold]
    n_massive = len(massive)
    return {
        "N_ncdm": n_massive,
        "m_ncdm": ", ".join(f"{m:.8f}" for m in massive) if massive else None,
        "N_ur": neff - n_massive * (neff / 3.0),
    }
