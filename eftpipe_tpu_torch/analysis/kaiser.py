"""Linear Kaiser model + least-squares fitter (a copy of
``eftpipe_tpu/analysis/kaiser.py``, host NumPy).

P(k, µ) = (b1 + f µ²)² P_lin(k) − 2 c (b1 + f µ²) k²/km² P_lin(k) + 1/n̄,
projected onto multipoles analytically, with a weighted linear least-squares
fit of the coefficients that enter linearly.
"""

from __future__ import annotations

import numpy as np
from dataclasses import dataclass


def kaiser_multipoles(k, plin, b1, f, c: float = 0.0, km: float = 0.7,
                      shot: float = 0.0):
    """(P0, P2, P4) of the linear Kaiser model with a k² counterterm.

    Uses the exact µ-integrals of (b1 + f µ²)² and (b1 + f µ²) against the
    Legendre polynomials.
    """
    k = np.asarray(k)
    plin = np.asarray(plin)
    # moments of µ^{2n} against L0/L2/L4
    # ∫ µ^0,2,4 L0 dµ/2 = 1, 1/3, 1/5 ; L2: 0, 2/3·1/5·... use closed forms:
    b2 = b1 * b1
    p0 = (b2 + 2.0 / 3.0 * b1 * f + 1.0 / 5.0 * f * f) * plin
    p2 = (4.0 / 3.0 * b1 * f + 4.0 / 7.0 * f * f) * plin
    p4 = (8.0 / 35.0 * f * f) * plin
    if c:
        kk = (k / km) ** 2
        p0 = p0 - 2.0 * c * (b1 + f / 3.0) * kk * plin
        p2 = p2 - 2.0 * c * (2.0 * f / 3.0) * kk * plin
    p0 = p0 + shot
    return p0, p2, p4


@dataclass
class KaiserModel:
    """Weighted least-squares Kaiser fit with fixed growth rate f.

    The model is linear in x = (b1², b1·f-combination handled via two basis
    functions, counterterm, shot): we fit the coefficient vector
    (A ≡ b1², B ≡ b1, C ≡ c·b1-term, S) by linearising around the quadratic
    structure: for fixed f the multipoles are linear in (b1², b1, c, shot)
    after dropping the small c·f cross term, then b1 = B/(2·sqrt(A))-free
    choice; we instead do a 1-D golden-section scan over b1 with the linear
    (c, shot) solved exactly — robust and dependency-free.
    """

    k: np.ndarray
    plin: np.ndarray
    f: float
    km: float = 0.7

    def _design(self, b1):
        """Columns of the linear part (c, shot) given b1, plus the offset."""
        p0, p2, _ = kaiser_multipoles(self.k, self.plin, b1, self.f)
        kk = (self.k / self.km) ** 2
        dc0 = -2.0 * (b1 + self.f / 3.0) * kk * self.plin
        dc2 = -2.0 * (2.0 * self.f / 3.0) * kk * self.plin
        ones = np.ones_like(self.k)
        zeros = np.zeros_like(self.k)
        offset = np.concatenate([p0, p2])
        design = np.column_stack([
            np.concatenate([dc0, dc2]),
            np.concatenate([ones, zeros]),
        ])
        return offset, design

    def chi2_at(self, b1, data0, data2, invcov=None):
        y = np.concatenate([np.asarray(data0), np.asarray(data2)])
        offset, design = self._design(b1)
        r0 = y - offset
        if invcov is None:
            coef, *_ = np.linalg.lstsq(design, r0, rcond=None)
        else:
            a = design.T @ invcov @ design
            b = design.T @ invcov @ r0
            coef = np.linalg.solve(a, b)
        res = r0 - design @ coef
        chi2 = float(res @ invcov @ res) if invcov is not None else float(res @ res)
        return chi2, coef

    def fit(self, data0, data2, invcov=None, b1_bounds=(0.1, 5.0), tol=1e-6):
        """Golden-section minimisation over b1; returns dict of bestfit params."""
        gr = (np.sqrt(5.0) - 1.0) / 2.0
        a, b = b1_bounds
        c = b - gr * (b - a)
        d = a + gr * (b - a)
        fc = self.chi2_at(c, data0, data2, invcov)[0]
        fd = self.chi2_at(d, data0, data2, invcov)[0]
        while abs(b - a) > tol:
            if fc < fd:
                b, d, fd = d, c, fc
                c = b - gr * (b - a)
                fc = self.chi2_at(c, data0, data2, invcov)[0]
            else:
                a, c, fc = c, d, fd
                d = a + gr * (b - a)
                fd = self.chi2_at(d, data0, data2, invcov)[0]
        b1 = 0.5 * (a + b)
        chi2, coef = self.chi2_at(b1, data0, data2, invcov)
        return dict(b1=float(b1), c=float(coef[0]), shot=float(coef[1]), chi2=chi2)

    def predict(self, b1, c=0.0, shot=0.0):
        return kaiser_multipoles(self.k, self.plin, b1, self.f, c=c,
                                 km=self.km, shot=shot)
