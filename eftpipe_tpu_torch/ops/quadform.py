"""Quadratic forms of the loop engine and their Hopper kernels (counterpart
of ``eftpipe_tpu/ops/pallas_kernels.py``).

The dominant per-evaluation cost of the one-loop engine is

    C[w, b, s] = Re Σ_{n,m} z[w,n,s] M[b,n,m] z[w,m,s]

with z the walker-dependent FFTLog coefficients times k- or s-powers and M
constant matrices.  The FFTLog coefficients come from an rfft of REAL grid
values, so z_{nc-j} = conj(z_{nc+j}); writing z = A w with w the independent
real dofs turns it into a real form with a real constant matrix,
``Re(zᵀ M z) = wᵀ M̃ w`` with ``M̃ = Re(Aᵀ M A)`` (``herm_fold``), one real
product per b instead of four.

Names here and in the JAX module:

==========================  =============================================
here                        ``eftpipe_tpu/ops/pallas_kernels.py``
==========================  =============================================
``herm_fold_matrix``        ``herm_fold_matrix``
``herm_fold``               ``herm_fold``
``trim_nyquist``            ``trim_nyquist``
``herm_w``                  ``herm_w``
``qf_real_plain``           ``qf_real_xla``
``cf_contract_plain``       ``cf_contract_xla``
``cf_half_plain``           the body of ``_cf_half_kernel`` as einsums
``qf_real_cuda``            ``qf_real_pallas`` (kernel ``_qf_real_kernel``)
``cf_half_cuda``            ``_cf_half`` (kernel ``_cf_half_kernel``)
``quad_form_real``          ``quad_form_real`` (+ ``qf_real_grouped``)
``cf_contract``             ``cf_contract`` / ``cf_contract_pallas``
``quad_form``               ``quad_form``
``lowrank_factors``         ``lowrank_factors``
``quad_form_lowrank``       ``quad_form_lowrank`` / ``qf_lowrank_xla``
==========================  =============================================

The walker axis is explicit: every op takes ``(W, N, S)`` (any leading axes
are flattened into W); the JAX module's ``custom_vmap`` dispatch and its
walker-grouped layouts have no counterpart.

The low-rank form (``lowrank_factors`` on the host, ``quad_form_lowrank``
per evaluation) is the JAX package's float32 route: the truncated
eigenbasis of sym(M), two products with an elementwise square between.  It
was two XLA einsums there, not a Pallas kernel, and is two ``torch.matmul``
here on either device, differentiated by autograd.

Dispatch is by the tensor's device alone: a CPU tensor takes the plain
version, a CUDA tensor launches a kernel or raises.  float32 runs on the
tensor cores with a 3xTF32 split (``csrc/quadform_tc.cu``), float64 on the
float64 tensor cores (``csrc/quadform.cu``, ``mma.sync`` m16n8k16).  Only
the symmetric part of M enters these forms, so the kernels multiply a lower
triangle: ``kernel_matrices(m)`` makes the layout a kernel reads (the fold,
padded as its library asks: to a multiple of 64 rows for float32, 16 for
float64; the float32 kernels split it into TF32 hi and lo parts on the
chip).  Constant matrices get it once per model
(``models/nonlinear.py``, ``api/flagship.py``) and hand it to the ops as
``prepared``; a raw ``m`` is prepared on the fly.  The plain versions and the
backward always use ``m``.
Each wrapper counts its launches in ``LAUNCHES``.  The kernels have no
backward kernel (neither had the TPU ones): the ``autograd.Function``s use
the forward kernel and a backward in plain torch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

# launches of each CUDA kernel since the last reset (one per kernel launch),
# in total and by (kernel, dtype suffix, W, N, S, BL)
LAUNCHES = {"qf_real": 0, "cf_half": 0}
LAUNCHES_BY_SHAPE: dict[tuple, int] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_BY_SHAPE.clear()


def _count_launch(kernel: str, dtype, nw: int, n: int, s: int, bl: int) -> None:
    LAUNCHES[kernel] += 1
    key = (kernel, _SUFFIX[dtype], nw, n, s, bl)
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1


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


def qf_real_backward_plain(g, w, m):
    """The backward of ``qf_real``: ∂/∂w of Σ g ⊙ (wᵀ M w) = g ⊙ ((M + Mᵀ) w),
    g (W, BL, S), w (W, N, S), m (BL, N, N) → (W, N, S); the (M + Mᵀ) w
    intermediate is chunked over walkers like the plain forward's.  Plain
    torch on either device: the JAX package's JVP of the form is two XLA
    einsums too (``pallas_kernels.py:423-438``)."""
    msym = m + m.transpose(-1, -2)
    per = m.shape[0] * m.shape[1] * w.shape[-1] * w.element_size()
    outs = []
    for a, b in _walker_chunks(w.shape[0], per):
        v = torch.einsum("wms,bnm->wbns", w[a:b], msym)
        outs.append(torch.einsum("wbs,wbns->wns", g[a:b], v))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def cf_half_plain(m, zr, zi):
    """One real part ``m`` of a complex M against both parts of z:
    out1 = Σ_n zr⊙(m zr) − zi⊙(m zi), out2 = Σ_n zr⊙(m zi) + zi⊙(m zr)."""
    per = 2 * m.shape[0] * m.shape[1] * zr.shape[-1] * zr.element_size()
    o1, o2 = [], []
    for a, b in _walker_chunks(zr.shape[0], per):
        vr = torch.einsum("wms,bnm->wbns", zr[a:b], m)
        vi = torch.einsum("wms,bnm->wbns", zi[a:b], m)
        o1.append(torch.einsum("wns,wbns->wbs", zr[a:b], vr)
                  - torch.einsum("wns,wbns->wbs", zi[a:b], vi))
        o2.append(torch.einsum("wns,wbns->wbs", zr[a:b], vi)
                  + torch.einsum("wns,wbns->wbs", zi[a:b], vr))
    if len(o1) == 1:
        return o1[0], o2[0]
    return torch.cat(o1, dim=0), torch.cat(o2, dim=0)


def cf_contract_plain(zr, zi, mr, mi):
    """Re(zᵀ M z): zr/zi (W, N, S); mr/mi (BL, N, N) → (W, BL, S)."""
    out1, _ = cf_half_plain(mr, zr, zi)
    _, out2 = cf_half_plain(mi, zr, zi)
    return out1 - out2


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# the source of each dtype's kernels: float32 on the tensor cores in a 3xTF32
# split, float64 on the float64 tensor cores
_LIB = {torch.float32: "quadform_tc", torch.float64: "quadform"}
_FUNCS: dict[str, object] = {}


def _lib(dtype):
    """The loaded library of ``dtype``'s kernels (built at first use), with
    the argument types of its C functions set."""
    name = _LIB[dtype]
    if name not in _FUNCS:
        lib = _build.load(name)
        ptr, i = ctypes.c_void_p, ctypes.c_int
        suffix = _SUFFIX[dtype]
        for fn, nptr in ((f"eft_qf_real_{suffix}", 3), (f"eft_cf_half_{suffix}", 5)):
            getattr(lib, fn).argtypes = [ptr] * nptr + [i] * 5 + [ptr]
            getattr(lib, fn).restype = i
        for fn in ("eft_qf_tc_pad", "eft_quadform_pad"):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = []
                getattr(lib, fn).restype = i
        lib.eft_cuda_error_string.argtypes = [i]
        lib.eft_cuda_error_string.restype = ctypes.c_char_p
        _FUNCS[name] = lib
    return _FUNCS[name]


def _raise_cuda(dtype, code: int, what: str):
    msg = _lib(dtype).eft_cuda_error_string(code).decode()
    raise RuntimeError(f"{what}: CUDA error {code}: {msg}")


def _check(name, t, shape, like):
    if not isinstance(t, torch.Tensor) or t.device != like.device:
        raise ValueError(f"{name} must be a tensor on {like.device}")
    if t.dtype != like.dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {like.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_w(w, what):
    if not w.is_cuda:
        raise ValueError(f"{what}: needs CUDA tensors")
    if w.dtype not in _SUFFIX:
        raise ValueError(f"{what}: dtype {w.dtype} not supported (float32, float64)")
    if w.dim() != 3 or not w.is_contiguous():
        raise ValueError(f"{what}: w/z must be a contiguous (W, N, S) tensor")


def tril_fold(m, multiple: int):
    """The matrices the kernels multiply.  Only the symmetric part of M enters
    zᵀ M z, so m (BL, N, N) becomes L = the strict lower triangle of M + Mᵀ
    with the diagonal of M — zᵀ L z = zᵀ M z, and for two vectors
    xᵀ L y + yᵀ L x = xᵀ M y + yᵀ M x — zero-padded to (BL, NP, NP), NP the next
    multiple of ``multiple``: rows are then 16-byte aligned and the kernels
    skip everything right of the diagonal."""
    n = m.shape[-1]
    low = torch.tril(m + m.transpose(-1, -2), -1)
    low.diagonal(dim1=-2, dim2=-1).copy_(m.diagonal(dim1=-2, dim2=-1))
    extra = -n % multiple
    return torch.nn.functional.pad(low, (0, extra, 0, extra))


def kernel_matrices(m):
    """The layout the kernels read of a CUDA tensor ``m`` (BL, N, N):
    ``tril_fold`` padded to the multiple its dtype's library asks for (BL, NP,
    NP).  Made once per model for constant matrices, and handed to the ops as
    ``prepared``."""
    if not m.is_cuda or m.dtype not in _LIB or m.dim() != 3:
        raise ValueError("kernel_matrices: needs a (BL, N, N) float32/float64 CUDA tensor")
    with torch.cuda.device(m.device):
        lib = _lib(m.dtype)
        pad = lib.eft_qf_tc_pad() if m.dtype == torch.float32 else lib.eft_quadform_pad()
        return tril_fold(m, pad)


def _prepared(m, prepared, n, like, what):
    """``prepared`` checked against m (BL, N, N), or made from m now."""
    if m.dim() != 3:
        raise ValueError(f"{what}: m must be (BL, N, N)")
    _check("m", m, (m.shape[0], n, n), like)
    lay = kernel_matrices(m) if prepared is None else prepared
    if (not isinstance(lay, torch.Tensor) or lay.device != like.device or lay.dtype != like.dtype
            or lay.dim() != 3 or lay.shape[0] != m.shape[0] or lay.shape[1] != lay.shape[2]
            or lay.shape[1] < n or not lay.is_contiguous()):
        raise ValueError(f"{what}: prepared must be kernel_matrices(m), "
                         f"got {getattr(lay, 'shape', type(lay))}")
    return lay


def qf_real_cuda(w, m, prepared=None):
    """Launch the fused kernel: w (W, N, S), m (BL, N, N) → (W, BL, S);
    ``prepared`` = ``kernel_matrices(m)``, made now when None."""
    _check_w(w, "qf_real_cuda")
    nw, n, s = w.shape
    with torch.cuda.device(w.device):
        lay = _prepared(m, prepared, n, w, "qf_real_cuda")
        bl, np_ = lay.shape[0], lay.shape[-1]
        out = torch.empty((nw, bl, s), dtype=w.dtype, device=w.device)
        if out.numel() == 0:
            return out
        fn = getattr(_lib(w.dtype), f"eft_qf_real_{_SUFFIX[w.dtype]}")
        code = fn(w.data_ptr(), lay.data_ptr(), out.data_ptr(), nw, n, np_, s, bl,
                  torch.cuda.current_stream().cuda_stream)
    if code != 0:
        _raise_cuda(w.dtype, code, "qf_real_cuda")
    _count_launch("qf_real", w.dtype, nw, n, s, bl)
    return out


def cf_half_cuda(m, zr, zi, prepared=None):
    """Launch the fused kernel for one real part of M: → (out1, out2);
    ``prepared`` = ``kernel_matrices(m)``, made now when None."""
    _check_w(zr, "cf_half_cuda")
    nw, n, s = zr.shape
    _check("zi", zi, (nw, n, s), zr)
    with torch.cuda.device(zr.device):
        lay = _prepared(m, prepared, n, zr, "cf_half_cuda")
        bl, np_ = lay.shape[0], lay.shape[-1]
        out1 = torch.empty((nw, bl, s), dtype=zr.dtype, device=zr.device)
        out2 = torch.empty_like(out1)
        if out1.numel() == 0:
            return out1, out2
        fn = getattr(_lib(zr.dtype), f"eft_cf_half_{_SUFFIX[zr.dtype]}")
        code = fn(lay.data_ptr(), zr.data_ptr(), zi.data_ptr(), out1.data_ptr(),
                  out2.data_ptr(), nw, n, np_, s, bl, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        _raise_cuda(zr.dtype, code, "cf_half_cuda")
    _count_launch("cf_half", zr.dtype, nw, n, s, bl)
    return out1, out2


def _qf_real_forward(w, m, prepared=None):
    return qf_real_cuda(w, m, prepared) if w.is_cuda else qf_real_plain(w, m)


def _cf_half_forward(m, zr, zi, prepared=None):
    return cf_half_cuda(m, zr, zi, prepared) if zr.is_cuda else cf_half_plain(m, zr, zi)


# ---------------------------------------------------------------------------
# differentiable public ops
# ---------------------------------------------------------------------------

class _QuadFormReal(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU).  Backward:
    :func:`qf_real_backward_plain` on either device."""

    @staticmethod
    def forward(ctx, w, m, prepared):
        ctx.save_for_backward(w, m)
        return _qf_real_forward(w, m, prepared)

    @staticmethod
    def backward(ctx, g):
        w, m = ctx.saved_tensors
        if ctx.needs_input_grad[1]:
            raise NotImplementedError(
                "quad_form_real: no gradient with respect to the constant matrices")
        return qf_real_backward_plain(g, w, m), None, None


class _CfContract(torch.autograd.Function):
    """Forward: two launches of the half kernel (CUDA) or the plain version
    (CPU).  Backward: autograd of the plain version."""

    @staticmethod
    def forward(ctx, zr, zi, mr, mi, prepared):
        ctx.save_for_backward(zr, zi, mr, mi)
        lr, li = (None, None) if prepared is None else prepared
        out1, _ = _cf_half_forward(mr, zr, zi, lr)
        _, out2 = _cf_half_forward(mi, zr, zi, li)
        return out1 - out2

    @staticmethod
    def backward(ctx, g):
        zr, zi, mr, mi = ctx.saved_tensors
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            raise NotImplementedError(
                "cf_contract: no gradient with respect to the constant matrices")
        with torch.enable_grad():
            a = zr.detach().requires_grad_(True)
            b = zi.detach().requires_grad_(True)
            out = cf_contract_plain(a, b, mr, mi)
            ga, gb = torch.autograd.grad(out, (a, b), g)
        return ga, gb, None, None, None


def _flat3(x):
    return x.reshape((-1,) + tuple(x.shape[-2:])).contiguous()


def quad_form_real(w, m, prepared=None):
    """wᵀ M̃ w over the folded spectral index: w (..., N, S), m (BL, N, N) →
    (..., BL, S).  On a CUDA tensor this launches the fused kernel, on
    ``prepared`` = ``kernel_matrices(m)`` when given (made now otherwise)."""
    lead = w.shape[:-2]
    out = _QuadFormReal.apply(_flat3(w), m.contiguous(), prepared)
    return out.reshape(tuple(lead) + tuple(out.shape[-2:]))


def cf_contract(zr, zi, mr, mi, prepared=None):
    """Re(zᵀ M z), the complex A/B reference of the folded form: zr/zi
    (..., N, S), mr/mi (BL, N, N) → (..., BL, S).  On CUDA tensors this
    launches the half kernel twice (once per real part of M), on
    ``prepared`` = (``kernel_matrices(mr)``, ``kernel_matrices(mi)``) when
    given (made now otherwise)."""
    lead = zr.shape[:-2]
    out = _CfContract.apply(_flat3(zr), _flat3(zi), mr.contiguous(), mi.contiguous(),
                            prepared)
    return out.reshape(tuple(lead) + tuple(out.shape[-2:]))


quad_form = cf_contract


# ---------------------------------------------------------------------------
# the low-rank (truncated eigenbasis) real quadratic form
# ---------------------------------------------------------------------------
#
# Only the symmetric part of M̃ enters wᵀ M̃ w, and the folded loop matrices are
# numerically low-rank.  With sym(M̃_b) = Σ_r λ_r u_r u_rᵀ and the rows
# q_r = √|λ_r|·u_r of all matrices stacked into Q (R, N):
#
#     Y = Q w   (R, S),      C_b = Σ_{r∈b} sign(λ_r) Y_r² = (S Y∘Y)_b
#
# An approximation (the truncation), taken only when a builder is asked for
# quadform="lowrank" (models/nonlinear.py).  Its products run in IEEE float32
# on the card (the package switches TF32 off): C sums squares of both signs,
# and a TF32 product (10-bit mantissa, ~5e-4 relative) would leave the 1e-4
# multipole budget before any cancellation.


def lowrank_factors(m_fold: np.ndarray, tol: float = 1e-8, pad_to: int = 128,
                    whiten: np.ndarray | None = None):
    """Host: eigendecompose sym(M̃) per matrix, truncate at ``tol`` relative
    to each matrix's spectral radius, and stack (a copy of the JAX package's
    ``lowrank_factors``, operation for operation, so that the factors are
    bitwise equal).

    ``whiten`` (optional, (N,) positive): eigendecompose D·sym(M̃)·D with
    D = diag(whiten) and unscale the kept rows by D⁻¹, so that the cut ranks
    eigenpairs by their contribution to the output for inputs w of the
    typical per-dof magnitude ``whiten``; the kept subspace is exact.

    Returns (q, smat): q (R, N) float64 rows √|λ|·uᵀ (·D⁻¹ when whitened),
    smat (BL, R) float64 with sign(λ_r) at (owner(r), r) and 0 elsewhere,
    R zero-padded to a multiple of ``pad_to``."""
    ms = 0.5 * (m_fold + np.swapaxes(m_fold, -1, -2))
    if whiten is not None:
        ms = ms * (whiten[:, None] * whiten[None, :])
    lam, u = np.linalg.eigh(ms)            # (BL, N), (BL, N, N) columns
    alam = np.abs(lam)
    mask = alam > tol * alam.max(axis=-1, keepdims=True)
    q_all = np.swapaxes(u, -1, -2) * np.sqrt(alam)[..., None]  # (BL, N, N) rows
    q = q_all[mask]                         # (R, N)
    if whiten is not None:
        q = q / whiten[None, :]
    owner = np.nonzero(mask)[0]             # (R,)
    sgn = np.sign(lam[mask])
    r = q.shape[0]
    rp = -(-r // pad_to) * pad_to
    if rp != r:
        q = np.concatenate([q, np.zeros((rp - r, q.shape[1]))], axis=0)
    smat = np.zeros((m_fold.shape[0], rp))
    smat[owner, np.arange(r)] = sgn
    return q, smat


def lowrank_rank(smat) -> int:
    """The number of kept eigenpairs of factors (q, smat), padding excluded."""
    return int((smat != 0).sum())


def quad_form_lowrank(w, q, smat):
    """smat @ (Q w)∘(Q w): w (..., N, S), q (R, N), smat (BL, R) →
    (..., BL, S), the truncated-eigenbasis form of :func:`quad_form_real`.

    Two matmuls on whatever device w lies on, chunked over the leading
    (walker) axes so that Y stays under 1 GiB: the unpremixed CF factors
    (R ≈ 5000) at W = 1024 would otherwise hold ~1.6 GB of Y in float32.
    Autograd differentiates it, twice where asked (``laplace_cov``)."""
    lead = w.shape[:-2]
    w3 = w.reshape((-1,) + tuple(w.shape[-2:]))
    per = q.shape[0] * w.shape[-1] * w.element_size()
    outs = []
    for a, b in _walker_chunks(w3.shape[0], per):
        y = torch.matmul(q, w3[a:b])          # (w, R, S)
        outs.append(torch.matmul(smat, y * y))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
    return out.reshape(tuple(lead) + tuple(out.shape[-2:]))
