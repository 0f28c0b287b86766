"""Split-complex helpers (counterpart of ``eftpipe_tpu/ops/cplx.py``).

Complex tensors are carried as (real, imag) pairs of real tensors so the
float32 kernels and matmuls see real operands only.  Constants are split on
the host; the contractions produce either the full complex result or
directly its real part (half the work wherever the imaginary part is
discarded — everywhere in the loop engine, the final spectra being real).
"""

from __future__ import annotations

import numpy as np
import torch


def split(x: np.ndarray):
    """Host-side: complex ndarray -> (re, im) float64 pair."""
    x = np.asarray(x)
    return np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag)


def cmul(a, b):
    """Elementwise complex product of two (re, im) pairs, with broadcasting."""
    ar, ai = a
    br, bi = b
    return ar * br - ai * bi, ar * bi + ai * br


def ceinsum(sub: str, a, b):
    """Complex einsum of two split operands -> split result."""
    ar, ai = a
    br, bi = b
    re = torch.einsum(sub, ar, br) - torch.einsum(sub, ai, bi)
    im = torch.einsum(sub, ar, bi) + torch.einsum(sub, ai, br)
    return re, im


def ceinsum_real(sub: str, a, b):
    """Real part of a complex einsum of two split operands."""
    return torch.einsum(sub, a[0], b[0]) - torch.einsum(sub, a[1], b[1])
