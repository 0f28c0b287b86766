"""Quadratic forms of the loop engine, plain versions only.

    C[w, b, s] = Re Σ_{n,m} z[w,n,s] M[b,n,m] z[w,m,s]

z are the walker-dependent FFTLog coefficients times k- or s-powers and M
constant matrices.  z comes from an rfft of real grid values, so writing
z = A w with w the independent real dofs gives a real form with the real
matrix ``M̃ = Re(Aᵀ M A)`` (``herm_fold``).

Every form here is two einsums with the V = M w intermediate in memory, on
whatever device the tensors lie; nothing is launched by hand, and the
backward of ``quad_form_real`` is ``g ⊙ ((M + Mᵀ) w)`` in plain torch.
"""

from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# host side: the Hermitian fold
# ---------------------------------------------------------------------------

def herm_fold_matrix(n1: int) -> np.ndarray:
    """The (N, 2·nc+1) complex map A with z = A w (N = 2nc+1 odd)."""
    nc = n1 // 2
    a = np.zeros((n1, n1), dtype=complex)
    a[nc, 0] = 1.0
    j = np.arange(1, nc + 1)
    a[nc + j, j] = 1.0
    a[nc - j, j] = 1.0
    a[nc + j, nc + j] = 1j
    a[nc - j, nc + j] = -1j
    return a


def herm_fold(m: np.ndarray) -> np.ndarray:
    """Host: fold a (..., N, N) complex quadratic-form matrix to the real
    M̃ = Re(Aᵀ M A) acting on the independent dofs.

    A has at most two nonzeros per column (±1 / ±i pairing the n = nc±j
    rows), so the fold is slicing + adds, O(N²) per matrix instead of the
    O(N³) dense congruence; every stage writes into a preallocated buffer."""
    nc = m.shape[-1] // 2
    n1 = m.shape[-1]
    batch = m.shape[:-2]
    mr, mi = m.real, m.imag
    mar = np.empty(batch + (n1, n1))      # Re(MA)
    mai = np.empty(batch + (n1, n1))      # Im(MA)
    # columns of A: w=0 -> e_nc; w=j -> e_{nc+j}+e_{nc-j}; w=nc+j -> i(e_+ - e_-)
    mar[..., :, 0] = mr[..., :, nc]
    np.add(mr[..., :, nc + 1:], mr[..., :, nc - 1::-1],
           out=mar[..., :, 1:nc + 1])
    np.subtract(mi[..., :, nc - 1::-1], mi[..., :, nc + 1:],
                out=mar[..., :, nc + 1:])
    mai[..., :, 0] = mi[..., :, nc]
    np.add(mi[..., :, nc + 1:], mi[..., :, nc - 1::-1],
           out=mai[..., :, 1:nc + 1])
    np.subtract(mr[..., :, nc + 1:], mr[..., :, nc - 1::-1],
                out=mai[..., :, nc + 1:])
    # rows: Re(Aᵀ (MA)) with the same index pattern
    out = np.empty(batch + (n1, n1))
    out[..., 0, :] = mar[..., nc, :]
    np.add(mar[..., nc + 1:, :], mar[..., nc - 1::-1, :],
           out=out[..., 1:nc + 1, :])
    np.subtract(mai[..., nc - 1::-1, :], mai[..., nc + 1:, :],
                out=out[..., nc + 1:, :])
    return out


def trim_nyquist(m_fold: np.ndarray, nc: int) -> np.ndarray:
    """Host: drop the two exactly-zero Nyquist dofs (Re index nc, Im index
    2·nc) from a herm-folded (..., 2nc+1, 2nc+1) quadratic-form matrix."""
    keep = np.delete(np.arange(2 * nc + 1), [nc, 2 * nc])
    return np.ascontiguousarray(m_fold[..., keep[:, None], keep[None, :]])


def herm_w(coef, pw_half, nc: int):
    """Per-evaluation w(s) from split coefficients and the HALF power table.

    coef: (cre, cim) each (..., N); pw_half: (pr, pi) each (nh, S) — the
    n ≥ nc slice of the k/s-power factors.  With nh = nc+1 this is the full
    2·nc+1-dof parametrisation; with nh = nc the exactly-zero Nyquist pair is
    dropped and w has 2·nc−1 dofs (fold matrices trimmed by
    :func:`trim_nyquist`).  Returns (..., 2·nh−1, S), contiguous."""
    pr, pi = pw_half
    nh = pr.shape[-2]
    cr = coef[0][..., nc : nc + nh, None]
    ci = coef[1][..., nc : nc + nh, None]
    zr = cr * pr - ci * pi
    zi = cr * pi + ci * pr
    return torch.cat([zr, zi[..., 1:, :]], dim=-2)


# ---------------------------------------------------------------------------
# plain versions (CPU tensors, tests, and the on-card comparison)
# ---------------------------------------------------------------------------

_PLAIN_V_BYTES = 1 << 30  # bound on the V = M w intermediate of a plain call


def _walker_chunks(nw: int, per_walker_bytes: int):
    step = max(1, min(nw, _PLAIN_V_BYTES // max(1, per_walker_bytes)))
    return [(i, min(nw, i + step)) for i in range(0, nw, step)]


def qf_real_plain(w, m):
    """w: (W, N, S); m: (BL, N, N) → (W, BL, S): two einsums with the
    V = M w intermediate in memory, chunked over walkers to bound it."""
    per = m.shape[0] * m.shape[1] * w.shape[-1] * w.element_size()
    outs = []
    for a, b in _walker_chunks(w.shape[0], per):
        v = torch.einsum("wms,bnm->wbns", w[a:b], m)
        outs.append(torch.einsum("wns,wbns->wbs", w[a:b], v))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
