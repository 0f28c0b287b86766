"""The yardstick of the kernels: the card's peaks and the work of the
quadratic form counted from its shapes, the same whatever implements it.

``qf_real``: C[w, b, s] = Σ_{n,m} w[w,n,s] M[b,n,m] w[w,m,s] for W walkers,
BL matrices of N×N (N the unpadded folded dofs) and S columns.  Only the
symmetric part of M enters, so the algorithm's operations are those of one
lower triangle: N(N+1)/2 multiply-adds per vector and output (W·BL·S·N(N+1)
flops), and the reduction against w (2·W·BL·N·S).  No implementation's
passes, padding or split are counted.  Bytes: each input read once (M, w)
and the output written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.  float32 work
# is held against the dense bf16/fp16 tensor rate, the fastest rate at which
# any route that keeps float32 accuracy (3xTF32, a bf16 hi/lo split) could
# issue it; float64 against the float64 tensor cores (DMMA).
PEAK_FLOPS = {"f32": 989e12, "f64": 67e12}
PEAK_BYTES_PER_S = 3.35e12
ITEMSIZE = {"f32": 4, "f64": 8}


def qf_real_flops(w: int, n: int, s: int, bl: int) -> float:
    return float(w) * bl * s * n * (n + 1) + 2.0 * w * bl * n * s


def qf_real_bytes(w: int, n: int, s: int, bl: int, dtype: str) -> float:
    return float(ITEMSIZE[dtype]) * (bl * n * n + w * n * s + w * bl * s)


def qf_real_least_seconds(w: int, n: int, s: int, bl: int, dtype: str) -> float:
    """The least time of one launch: the larger of the operations at the
    peak rate and the bytes at the peak bandwidth."""
    return max(qf_real_flops(w, n, s, bl) / PEAK_FLOPS[dtype],
               qf_real_bytes(w, n, s, bl, dtype) / PEAK_BYTES_PER_S)
