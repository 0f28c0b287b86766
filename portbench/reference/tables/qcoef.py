"""IR-resummation Q coefficients as Chebyshev tensors (counterpart of
``eftpipe_tpu/tables/qcoef.py``).  The data files are byte copies of the
``qcoef_nir8.npz`` / ``qcoef_nir16.npz`` that the program ships too: the
one table the reference does not work out again, as the upstream
expressions it was fitted from are not in the repository.  A fault in it
(its index layout, the a/l mapping, the fit) is shared by the program and
the reference, and the comparison cannot see it.

The bulk coefficients Q^{ll'}_{||N-j}(n, α, f) are polynomials in the growth
rate f; as dense Chebyshev-coefficient tensors the per-evaluation ``makeQ``
(upstream pybird/pybird.py:1367-1380) is one einsum, batched over walkers.
"""

from __future__ import annotations

import numpy as np
import torch
from functools import lru_cache
from importlib import resources


@lru_cache(maxsize=None)
def load_qcoef(nir: int) -> tuple[np.ndarray, float]:
    """Return (coef[2, nl, nl, nn, deg+1], fmax) for NIR ∈ {8, 16}."""
    if nir not in (8, 16):
        raise NotImplementedError(f"NIR={nir} not available (upstream supports 8 and 16)")
    ref = resources.files(__package__) / "data" / f"qcoef_nir{nir}.npz"
    with resources.as_file(ref) as path:
        data = np.load(path)
        return data["coef"], float(data["fmax"])


def chebyshev_t_vector(x, deg: int):
    """[T_0(x), ..., T_deg(x)] for batched x, stacked on axis -1."""
    ts = [torch.ones_like(x), x]
    for _ in range(deg - 1):
        ts.append(2.0 * x * ts[-1] - ts[-2])
    return torch.stack(ts[: deg + 1], dim=-1)


def make_q(coef, fmax: float, f):
    """Q[a, l, l', u] as a function of the growth rate f (..., ) → (..., 2,
    nl, nl, nn)."""
    u = 2.0 * f / fmax - 1.0
    t = chebyshev_t_vector(u, coef.shape[-1] - 1)  # (..., deg+1)
    return torch.einsum("...d,alpud->...alpu", t, coef)
