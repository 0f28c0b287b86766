"""Linear bird transforms: k-binning and chained multipoles (counterpart of
``eftpipe_tpu/models/transforms.py``).

Binning (upstream eftpipe/binning.py:17-162) bin-averages k²P(k) over each
data bin with a 100·accboost-point trapezoid after cubic interpolation from
the internal grid — exactly linear with fixed coefficients, so Phase A
reduces it to one (nbins, nk) matrix applied to the last axis of every
P-side tensor.  Chained multipoles (upstream chained.py) are one constant
(nl-1, nl) matrix on the multipole axis.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.interp import spline_matrix
from .config import EFTConfig
from .bird import BirdState

_PK_FIELDS = ("p11l", "ploopl", "pctl", "pct_nnlo_l", "pstl", "picc")


def map_pk_fields(bird: BirdState, fn) -> BirdState:
    """Apply ``fn`` to every power-spectrum-side tensor of the bird."""
    return bird._replace(**{f: fn(getattr(bird, f)) for f in _PK_FIELDS})


def infer_kedges(kout: np.ndarray, decimals: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """Bin edges from the data grid spacing (binning.py:100-111).

    Upstream rounds the last spacing to a fixed number of decimals (valid
    only for dk like 0.01, 0.005, 0.001).  Here the decimal count adapts: it
    grows until the rounded spacing agrees with the measured one to 1%, so
    the upstream behaviour is kept wherever it is valid."""
    kout = np.asarray(kout, dtype=np.float64)
    dk = kout[-1] - kout[-2]
    delta_k = np.round(dk, decimals)
    while decimals < 12 and not np.isclose(delta_k, dk, rtol=1e-2, atol=0):
        decimals += 1
        delta_k = np.round(dk, decimals)
    kcentral = (kout[-1] - delta_k * np.arange(kout.size))[::-1]
    kmin, kmax = kcentral - delta_k / 2.0, kcentral + delta_k / 2.0
    if kmin[0] < 0:
        raise ValueError(
            f"inferred bin edges start below zero (delta_k={delta_k}); "
            "the data k-grid is not linearly spaced — pass explicit "
            "kstart/kend/nbins"
        )
    return kmin, kmax


def explicit_kedges(kout, kstart: float, kend: float, nbins: int):
    """Explicit linear bin edges, trimmed to cover kout (binning.py:89-95)."""
    kout = np.asarray(kout, dtype=np.float64)
    kedges = np.linspace(kstart, kend, nbins + 1)
    ileft = int(np.searchsorted(kedges, kout[0])) - 1
    iright = int(np.searchsorted(kedges, kout[-1], side="right")) + 1
    kedges = kedges[ileft:iright]
    return kedges[:-1], kedges[1:]


def build_binning_matrix(
    cfg: EFTConfig,
    kout,
    accboost: int = 1,
    decimals: int = 2,
    kstart: float | None = None,
    kend: float | None = None,
    nbins: int | None = None,
) -> dict:
    """Host: constant (nbins, nk) bin-average matrix + effective k
    (binning.py:100-159), float64 NumPy; the likelihood moves ``matrix`` to
    its device."""
    if kstart is None and kend is None and nbins is None:
        binmin, binmax = infer_kedges(kout, decimals)
    else:
        if kstart is None or kend is None or nbins is None:
            raise ValueError("need kstart, kend and nbins together")
        binmin, binmax = explicit_kedges(kout, kstart, kend, nbins)
    binvol = (binmax**3 - binmin**3) / 3.0
    keff = (binmax**4 - binmin**4) / 4.0 / binvol
    npts = 100 * accboost
    rows = []
    for lo, hi, vol in zip(binmin, binmax, binvol):
        pts = np.linspace(lo, hi, npts)
        w = np.full(npts, pts[1] - pts[0])
        w[0] *= 0.5
        w[-1] *= 0.5
        s = spline_matrix(cfg.k, pts)  # (npts, nk)
        rows.append((w * pts**2) @ s / vol)
    return dict(matrix=np.stack(rows), keff=keff, binmin=binmin, binmax=binmax)


def apply_binning(matrix, bird: BirdState) -> BirdState:
    """``matrix``: the (nbins, nk) tensor of the binning tables, on the
    bird's device and in its dtype."""
    return map_pk_fields(bird, lambda x: x @ matrix.T)


# ---------------------------------------------------------------------------
# chained multipoles
# ---------------------------------------------------------------------------

def chain_coeff(ell: int) -> float:
    """A_ℓ = (2ℓ+1) L_ℓ(0) / ((2ℓ+5) L_{ℓ+2}(0)) (chained.py:13-28)."""
    from scipy.special import legendre

    return ((2 * ell + 1) * legendre(ell)(0)) / ((2 * ell + 5) * legendre(ell + 2)(0))


def chained_matrix(nl: int) -> np.ndarray:
    """(nl-1, nl) matrix P_ℓ − A_ℓ P_{ℓ+2} (chained.py:32-54)."""
    if nl < 2 or nl > 4:
        raise NotImplementedError(f"chained multipoles need 2 <= nl <= 4, got {nl}")
    m = np.zeros((nl - 1, nl))
    for i in range(nl - 1):
        m[i, i] = 1.0
        m[i, i + 1] = -chain_coeff(2 * i)
    return m


# (nl, device, dtype) → the chained matrix on the card: made once, since a
# host array put on the card per call synchronises the stream
_CHAINED: dict = {}


def _chained_tensor(nl: int, like):
    key = (nl, like.device, like.dtype)
    if key not in _CHAINED:
        _CHAINED[key] = torch.as_tensor(chained_matrix(nl), dtype=like.dtype, device=like.device)
    return _CHAINED[key]


def apply_chained(cfg: EFTConfig, bird: BirdState) -> BirdState:
    m = _chained_tensor(cfg.nl, bird.p11l)
    tensor = lambda x: torch.einsum("al,...lnx->...anx", m, x)  # (W, nl, n, nk)
    plain = lambda x: torch.einsum("al,...lx->...ax", m, x)     # picc: (W, nl, nk)
    return bird._replace(
        p11l=tensor(bird.p11l),
        ploopl=tensor(bird.ploopl),
        pctl=tensor(bird.pctl),
        pct_nnlo_l=tensor(bird.pct_nnlo_l),
        pstl=tensor(bird.pstl),
        picc=plain(bird.picc),
    )
