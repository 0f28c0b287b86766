"""Closed-form one-loop EFT matrices in the FFTLog power-law basis.

With the linear power spectrum decomposed as P_lin(k) = Σ_n c_n k^(ν_n), the
one-loop redshift-space contributions become exact double/single sums over the
complex exponents (FFT-PT formalism, arXiv 1708.08130; redshift-space bias
decomposition of PyBird, arXiv 2003.07956):

    P22_b(k) = k³ Re[ Σ_{nm} c_n c_m k^{ν_n+ν_m} M22_{b,nm} ]   (28 structures)
    P13_b(k) = k³ P11(k) Re[ Σ_n c_n k^{ν_n} M13_{b,n} ]        (10 structures)

The rational-function tables below reproduce the published matrices used by
the reference (upstream pybird/pybird.py:98-156); the bias
structures are ordered identically so the downstream f-power regrouping into
the 12 bias-independent loop channels carries over unchanged.

``mpc`` is the analytic spherical-Bessel moment
(1/2π²)∫ t^{2-2p} j_l(t) dt used for P↔ξ transforms
(pybird.py:159-173), and ``mu_coeff``/``legendre_weights`` are the
µ-power → Legendre-multipole projection tables (pybird.py:89-95, 562-582).
"""

from __future__ import annotations

import numpy as np
from scipy.special import loggamma

N22 = 28
N13 = 10


def mpc(l, pn):
    """(1/2π²) ∫ t^{2-2·pn} j_l(t) dt, via gamma functions (pybird.py:159-173).

    Multiply by s^{2·pn-3} for the full Bessel-transform contribution.
    Accepts broadcasting arrays for ``l`` and complex ``pn``.
    """
    return (
        np.pi**-1.5
        * 2.0 ** (-2.0 * pn)
        * np.exp(loggamma(1.5 + l / 2.0 - pn) - loggamma(l / 2.0 + pn))
    )


def m13_common(n1):
    """Common (gamma-function) factor of the 13-type matrices (pybird.py:112-114)."""
    return np.tan(n1 * np.pi) / (14.0 * (n1 - 3.0) * (n1 - 2.0) * (n1 - 1.0) * n1 * np.pi)


def m13_matrices(pow_exponents: np.ndarray) -> np.ndarray:
    """All 10 13-type matrices, shape (10, N), complex.

    ``pow_exponents`` are the FFTLog exponents ν_n (``HostFFTLog.pow``); the
    kernel variable is n1 = -ν/2 (pybird.py:1018-1023).  Structure-specific
    rational factors from pybird.py:98-109.
    """
    n1 = -0.5 * np.asarray(pow_exponents)
    a = m13_common(n1)
    one = np.ones_like(n1)
    rows = [
        1.125 * one,
        -1.0 / (1.0 + n1),
        2.25 * one,
        3.0 * (3.0 * n1 - 1.0) / (4.0 * (1.0 + n1)),
        -1.0 / (1.0 + n1),
        -9.0 / (4.0 * (1.0 + n1)),
        (9.0 + 18.0 * n1) / (4.0 * (1.0 + n1)),
        3.0 * (3.0 * n1 - 5.0) / (8.0 * (1.0 + n1)),
        -9.0 / (4.0 * (1.0 + n1)),
        9.0 * n1 / (4.0 * (1.0 + n1)),
    ]
    return np.stack([a * r for r in rows], axis=0)


def m22_common(n1, n2):
    """Common gamma-function factor of the 22-type matrices (pybird.py:152-156)."""
    return np.exp(
        loggamma(1.5 - n1) + loggamma(1.5 - n2) + loggamma(n1 + n2 - 1.5)
        - loggamma(n1) - loggamma(n2) - loggamma(3.0 - n1 - n2)
    ) / (8.0 * np.pi**1.5)


def m22_matrices(pow_exponents: np.ndarray) -> np.ndarray:
    """All 28 22-type matrices, shape (28, N, N), complex.

    Rational structure factors from pybird.py:119-148 (kernel variables
    n1 = -ν_n/2, n2 = -ν_m/2); the common gamma factor regularises the poles.
    """
    nu = -0.5 * np.asarray(pow_exponents)
    n1 = nu[:, None]
    n2 = nu[None, :]
    a = m22_common(n1, n2)

    # frequently used combinations
    s = n1 + n2           # total power
    d1 = n1 * (1 + n1) * (2 * n1 - 1)
    d2 = n2 * (1 + n2) * (2 * n2 - 1)
    e1 = n1 * (1 + n1)
    e2 = n2 * (1 + n2)

    rows = np.empty((N22,) + np.broadcast_shapes(n1.shape, n2.shape), dtype=complex)
    rows[0] = (
        6 + n1**4 * (4 - 24 * n2) - 7 * n2 + 8 * n1**5 * n2 - 13 * n2**2 + 4 * n2**3
        + 4 * n2**4 + n1**2 * (-13 + 38 * n2 + 12 * n2**2 - 8 * n2**3)
        + 2 * n1**3 * (2 - 5 * n2 - 4 * n2**2 + 8 * n2**3)
        + n1 * (-7 - 6 * n2 + 38 * n2**2 - 10 * n2**3 - 24 * n2**4 + 8 * n2**5)
    ) / (4.0 * d1 * d2)
    rows[1] = (
        -18 + n1**2 * (1 - 11 * n2) - 12 * n2 + n2**2 + 10 * n2**3
        + 2 * n1**3 * (5 + 7 * n2) + n1 * (-12 - 38 * n2 - 11 * n2**2 + 14 * n2**3)
    ) / (7.0 * e1 * e2)
    rows[2] = (n1 * (2 * n1 - 3) + n2 * (2 * n2 - 3)) / (n1 * n2)
    rows[3] = (
        -4 * (-24 + n2 + 10 * n2**2) + 2 * n1 * (-2 + 51 * n2 + 21 * n2**2)
        + n1**2 * (-40 + 42 * n2 + 98 * n2**2)
    ) / (49.0 * e1 * e2)
    rows[4] = 4 * (3 - 2 * n2 + n1 * (7 * n2 - 2)) / (7.0 * n1 * n2)
    rows[5] = 2.0 + 0 * n1 * n2
    rows[6] = (2 * s - 3) * (
        -2 + 3 * n2 + 4 * n1**4 * n2 + 3 * n2**2 - 2 * n2**3
        + n1**3 * (-2 - 2 * n2 + 4 * n2**2)
        + n1**2 * (3 - 10 * n2 - 4 * n2**2 + 4 * n2**3)
        + n1 * (3 + 2 * n2 - 10 * n2**2 - 2 * n2**3 + 4 * n2**4)
    ) / (2.0 * d1 * d2)
    rows[7] = (2 * s - 3) * (
        2 + 4 * n2 + 5 * n2**2 + n1**2 * (5 + 7 * n2)
        + n1 * (4 + 10 * n2 + 7 * n2**2)
    ) / (7.0 * e1 * e2)
    rows[8] = s * (2 * s - 3) / (n1 * n2)
    rows[9] = (2 * s - 3) * (
        10 - 23 * n2 + 28 * n1**4 * n2 + 5 * n2**2 + 2 * n2**3
        + n1**3 * (2 - 46 * n2 + 28 * n2**2)
        + n1**2 * (5 - 38 * n2 - 28 * n2**2 + 28 * n2**3)
        + n1 * (-23 + 94 * n2 - 38 * n2**2 - 46 * n2**3 + 28 * n2**4)
    ) / (14.0 * d1 * d2)
    rows[10] = (2 * s - 3) * (
        -58 + 4 * n2 + 35 * n2**2 + 7 * n1**2 * (5 + 7 * n2)
        + n1 * (4 + 14 * n2 + 49 * n2**2)
    ) / (49.0 * e1 * e2)
    rows[11] = (2 * s - 3) * (7 * s - 8) / (7.0 * n1 * n2)
    rows[12] = (2 * s - 3) * (2 * s - 1) * (
        2 + 2 * n1**3 - n2 - n2**2 + 2 * n2**3
        - n1**2 * (1 + 2 * n2) - n1 * (1 + 2 * n2 + 2 * n2**2)
    ) / (8.0 * d1 * d2)
    rows[13] = (1 + s) * (2 + s) * (2 * s - 3) * (2 * s - 1) / (8.0 * e1 * e2)
    rows[14] = -(2 * s - 3) * (-6 - n1 + 2 * n1**2 - n2 + 2 * n2**2) / (8.0 * e1 * e2)
    rows[15] = (2 * s - 3) * (2 * s - 1) * (
        38 + 41 * n2 + 112 * n1**3 * n2 - 66 * n2**2
        + 2 * n1**2 * (-33 - 18 * n2 + 56 * n2**2)
        + n1 * (41 - 232 * n2 - 36 * n2**2 + 112 * n2**3)
    ) / (56.0 * d1 * d2)
    rows[16] = -(2 * s - 3) * (9 + 3 * s + 7 * n1 * n2) / (14.0 * e1 * e2)
    rows[17] = (2 * s - 3) * (2 * s - 1) * (5 + 5 * s + 7 * n1 * n2) / (14.0 * e1 * e2)
    rows[18] = (3 - 2 * s) / (2.0 * n1 * n2)
    rows[19] = (2 * s - 3) * (2 * s - 1) / (2.0 * n1 * n2)
    rows[20] = (2 * s - 3) * (2 * s - 1) * (
        50 - 9 * n2 + 98 * n1**3 * n2 - 35 * n2**2
        + 7 * n1**2 * (-5 - 18 * n2 + 28 * n2**2)
        + n1 * (-9 - 66 * n2 - 126 * n2**2 + 98 * n2**3)
    ) / (196.0 * d1 * d2)
    rows[21] = (2 * s - 3) * (2 * s - 1) * (
        2 + n1 + 4 * n1**3 + n2 - 8 * n1 * n2 - 8 * n1**2 * n2
        - 8 * n1 * n2**2 + 4 * n2**3
    ) / (8.0 * d1 * d2)
    rows[22] = (2 + s) * (2 * s - 3) * (2 * s - 1) * (2 * s + 1) / (8.0 * e1 * e2)
    rows[23] = -(2 * s - 3) * (2 * s - 1) * (7 * s - 2) / (56.0 * e1 * e2)
    rows[24] = (2 * s - 3) * (2 * s - 1) * (
        26 + 9 * n2 + 56 * n1**3 * n2 - 38 * n2**2
        + 2 * n1**2 * (-19 - 18 * n2 + 56 * n2**2)
        + n1 * (9 - 84 * n2 - 36 * n2**2 + 56 * n2**3)
    ) / (56.0 * d1 * d2)
    rows[25] = 3.0 * (2 * s - 3) * (2 * s - 1) / (32.0 * e1 * e2)
    rows[26] = (2 * s - 3) * (2 * s - 1) * (2 * s + 1) * (
        1 + 2 * n1**2 - 8 * n1 * n2 + 2 * n2**2
    ) / (16.0 * d1 * d2)
    rows[27] = (2 * s - 3) * (2 * s - 1) * (2 * s + 1) * (2 * s + 3) / (32.0 * e1 * e2)

    return a[None, ...] * rows


# -- µ-power → Legendre projection ------------------------------------------
# L_l coefficient of µ^(2j): mu_coeff[j][l] with j = 0..4, l ∈ {0, 2, 4}
# (pybird.py:89-95).
_MU = {
    0: {0: 1.0, 2: 0.0, 4: 0.0},
    2: {0: 1.0 / 3.0, 2: 2.0 / 3.0, 4: 0.0},
    4: {0: 1.0 / 5.0, 2: 4.0 / 7.0, 4: 8.0 / 35.0},
    6: {0: 1.0 / 7.0, 2: 10.0 / 21.0, 4: 24.0 / 77.0},
    8: {0: 1.0 / 9.0, 2: 40.0 / 99.0, 4: 48.0 / 148.0},
}


def mu_coeff(mu_power: int, ell: int) -> float:
    return _MU[mu_power][ell]


def legendre_weights(nl: int):
    """Multipole projection tables l11/lct/lctNNLO/l22/l13, shapes (nl, ·).

    Row i corresponds to ℓ = 2i; columns list the µ-powers carried by each
    bias structure (pybird.py:562-582).
    """
    l11 = np.empty((nl, 3))
    lct = np.empty((nl, 6))
    lct_nnlo = np.empty((nl, 3))
    l22 = np.empty((nl, N22))
    l13 = np.empty((nl, N13))
    # µ-powers of each structure, in reference order
    p22 = [0] * 6 + [2] * 7 + [4, 2, 4, 2, 4, 2] + [4] * 3 + [6, 4, 6, 4, 6, 8]
    p13 = [0] * 2 + [2] * 4 + [4] * 3 + [6]
    for i in range(nl):
        ell = 2 * i
        l11[i] = [_MU[0][ell], _MU[2][ell], _MU[4][ell]]
        lct[i] = [_MU[0][ell], _MU[2][ell], _MU[4][ell], _MU[2][ell], _MU[4][ell], _MU[6][ell]]
        lct_nnlo[i] = [_MU[4][ell], _MU[6][ell], _MU[8][ell]]
        l22[i] = [_MU[p][ell] for p in p22]
        l13[i] = [_MU[p][ell] for p in p13]
    return dict(l11=l11, lct=lct, lct_nnlo=lct_nnlo, l22=l22, l13=l13)
