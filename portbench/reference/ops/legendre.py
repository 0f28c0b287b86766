"""Even Legendre polynomials, explicit forms (tensors or NumPy arrays)."""

from __future__ import annotations


def legendre_even(i: int, x):
    """L_{2i}(x) for 2i ≤ 8 (sufficient for Nl ≤ 4 + chained + NNLO µ-powers)."""
    x2 = x * x
    if i == 0:
        return 1.0 + 0.0 * x
    if i == 1:
        return 1.5 * x2 - 0.5
    if i == 2:
        return ((35.0 * x2 - 30.0) * x2 + 3.0) / 8.0
    if i == 3:
        return (((231.0 * x2 - 315.0) * x2 + 105.0) * x2 - 5.0) / 16.0
    if i == 4:
        return ((((6435.0 * x2 - 12012.0) * x2 + 6930.0) * x2 - 1260.0) * x2 + 35.0) / 128.0
    raise NotImplementedError(f"L_{2*i} not implemented")
