"""Analytic Gaussian multipole covariance (reference
upstream eftpipe/covariance.py:96-309).

Cov[P_{l1}^{ab}(k), P_{l2}^{cd}(k)] = (2l1+1)(2l2+1)/(2 N_modes(k)) ×
    Σ_{la, lb} [P^{ac}_{la} P^{bd}_{lb} + P^{ad}_{la} P^{bc}_{lb}] G_{l1 l2 la lb}

with G the integral of four Legendre polynomials, computed here directly by
Gauss–Legendre quadrature instead of a hard-coded table.  Host-side only
(used to generate synthetic covariances and for the analysis tooling).
"""

from __future__ import annotations

import numpy as np
from dataclasses import dataclass
from functools import lru_cache


@lru_cache(maxsize=None)
def legendre4_integral(a: int, b: int, c: int, d: int) -> float:
    """∫_{-1}^{1} L_a L_b L_c L_d dµ (exact via Gauss–Legendre)."""
    deg = a + b + c + d
    x, w = np.polynomial.legendre.leggauss(deg // 2 + 2)
    vals = np.ones_like(x) * w
    for ell in (a, b, c, d):
        coeffs = np.zeros(ell + 1)
        coeffs[ell] = 1.0
        vals = vals * np.polynomial.legendre.legval(x, coeffs)
    return float(vals.sum())


@dataclass(eq=False)
class Multipole:
    p0: np.ndarray
    p2: np.ndarray
    p4: np.ndarray | None = None

    def __post_init__(self):
        if self.p4 is None:
            self.p4 = np.zeros_like(self.p0)

    def get(self, ell: int) -> np.ndarray:
        return {0: self.p0, 2: self.p2, 4: self.p4}[ell]


def parse_subscripts(subscripts: str):
    """'aa,bb,ab->abab' -> operand indices for (P_ac, P_bd, P_ad, P_bc)
    (covariance.py:109-132)."""
    import re

    subscripts = "".join(subscripts.split())
    m = re.match(r"([a-zA-Z0-9]{2})((,[a-zA-Z0-9]{2})*)->([a-zA-Z0-9]{4})", subscripts)
    if not m:
        raise ValueError(f"invalid subscripts {subscripts!r}")
    first, more, _, result = m.groups()
    ops = [first] + [s for s in (more or ",")[1:].split(",") if s]
    norm = lambda s: "".join(sorted(s))
    ops = [norm(s) for s in ops]
    a, b, c, d = result
    needed = [norm(s) for s in (a + c, b + d, a + d, b + c)]
    for s in needed:
        if s not in ops:
            raise ValueError(f"missing input multipole {s!r}")
    return tuple(ops.index(s) for s in needed)


def copy_block_diag(cov: np.ndarray, nblock: int) -> np.ndarray:
    """Keep only the per-(block, block) diagonals of a covariance — the
    reference's covariance-surgery utility (data/noric_cutsky/dcov.py:12-20),
    used to build 'diagonal' covariances that retain multipole-multipole
    correlations only on matching k bins."""
    cov = np.asarray(cov)
    n = cov.shape[0]
    if n % nblock:
        raise ValueError(f"covariance size {n} not divisible by {nblock} blocks")
    nvec = n // nblock
    out = np.zeros_like(cov)
    for i in range(nblock):
        for j in range(nblock):
            sl_i = slice(i * nvec, (i + 1) * nvec)
            sl_j = slice(j * nvec, (j + 1) * nvec)
            np.fill_diagonal(out[sl_i, sl_j], np.diagonal(cov[sl_i, sl_j]))
    return out


class GaussianCovariance:
    """Thin-shell Gaussian covariance on a binned k grid."""

    def __init__(self, kedges, nmodes=None, volume: float | None = None, kavg=None):
        self.kedges = np.asarray(kedges, dtype=np.float64)
        self._kavg = np.asarray(kavg, dtype=np.float64) if kavg is not None else None
        if nmodes is not None:
            nmodes = np.asarray(nmodes, dtype=np.float64)
            if nmodes.size != self.kedges.size - 1:
                raise ValueError("nmodes should have length kedges.size - 1")
            self.nmodes = nmodes
        else:
            if volume is None:
                raise ValueError("either nmodes or volume (in (Gpc/h)³) is required")
            self.nmodes = volume * 1e9 * self.kvolume / (2 * np.pi) ** 3

    @property
    def kvolume(self):
        lo, hi = self.kedges[:-1], self.kedges[1:]
        return (4 * np.pi / 3) * (hi**3 - lo**3)

    @property
    def kavg(self):
        if self._kavg is not None:
            return self._kavg
        lo, hi = self.kedges[:-1], self.kedges[1:]
        return 0.75 * (hi**4 - lo**4) / (hi**3 - lo**3)

    def __call__(self, ell1, ell2, subscripts: str, /, *multipoles: Multipole):
        pac, pbd, pad, pbc = (multipoles[i] for i in parse_subscripts(subscripts))
        ell1 = np.atleast_1d(ell1)
        ell2 = np.atleast_1d(ell2)
        blocks = {}
        for l1 in ell1:
            for l2 in ell2:
                key = tuple(sorted((int(l1), int(l2))))
                if key in blocks:
                    continue
                sig = 0.0
                for la in (0, 2, 4):
                    for lb in (0, 2, 4):
                        g = legendre4_integral(key[0], key[1], la, lb)
                        if g == 0.0:
                            continue
                        sig = sig + (pac.get(la) * pbd.get(lb) + pad.get(la) * pbc.get(lb)) * g
                blocks[key] = (2 * l1 + 1) * (2 * l2 + 1) / 2.0 * sig / self.nmodes
        if ell1.size == ell2.size == 1:
            return blocks[tuple(sorted((int(ell1[0]), int(ell2[0]))))]
        return np.block([
            [np.diag(blocks[tuple(sorted((int(l1), int(l2))))]) for l2 in ell2]
            for l1 in ell1
        ])

    def fullcov(self, paa: Multipole, pbb: Multipole, pab: Multipole,
                ells: list[int] = [0, 2, 4]) -> np.ndarray:
        """Joint (aa, bb, ab) covariance (covariance.py:200-219)."""
        aaaa = self(ells, ells, "aa->aaaa", paa)
        aabb = self(ells, ells, "aa,bb,ab->aabb", paa, pbb, pab)
        aaab = self(ells, ells, "aa,bb,ab->aaab", paa, pbb, pab)
        bbbb = self(ells, ells, "bb->bbbb", pbb)
        bbba = self(ells, ells, "aa,bb,ab->bbba", paa, pbb, pab)
        abab = self(ells, ells, "aa,bb,ab->abab", paa, pbb, pab)
        return np.block([[aaaa, aabb, aaab], [aabb, bbbb, bbba], [aaab, bbba, abab]])
