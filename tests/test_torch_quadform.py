"""Port of the quadratic-form ops (eftpipe_tpu_torch/ops/quadform.py) against
the JAX module (eftpipe_tpu/ops/pallas_kernels.py): same NumPy inputs from a
seed through both sides.  On the CPU the port's wrappers take their plain
versions; the Pallas kernels run in interpret mode."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from eftpipe_tpu.ops import pallas_kernels as jk
from eftpipe_tpu_torch.ops import quadform as tq

W, N, S, BL = 12, 33, 10, 7   # the shapes of tests/test_quadform.py


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal(shape) for shape in
                 [(W, N, S), (W, N, S), (BL, N, N), (BL, N, N)])


def t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def test_qf_real_plain_matches_xla(data):
    """float64, identical inputs: 1e-12 relative (same two einsums)."""
    zr, _, mr, _ = data
    want = np.asarray(jk.qf_real_xla(jnp.asarray(zr), jnp.asarray(mr)))
    got = tq.qf_real_plain(t(zr), t(mr)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_cf_contract_plain_matches_xla(data):
    zr, zi, mr, mi = data
    want = np.asarray(jk.cf_contract_xla(*map(jnp.asarray, data)))
    got = tq.cf_contract_plain(t(zr), t(zi), t(mr), t(mi)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    z, m = zr + 1j * zi, mr + 1j * mi
    dense = np.einsum("wns,bnm,wms->wbs", z, m, z).real
    np.testing.assert_allclose(got, dense, rtol=1e-10, atol=1e-12 * np.abs(dense).max())


@pytest.mark.parametrize("op", ["quad_form_real", "cf_contract", "quad_form"])
def test_public_ops_on_cpu_take_plain_and_keep_leading_axes(data, op):
    """Public ops: (W, N, S) and extra leading axes; equal to the JAX public
    op under vmap (1e-10, float64)."""
    zr, zi, mr, mi = data
    if op == "quad_form_real":
        got = tq.quad_form_real(t(zr), t(mr)).numpy()
        want = np.asarray(jax.vmap(lambda a: jk.quad_form_real(a, jnp.asarray(mr)))(jnp.asarray(zr)))
        got4 = tq.quad_form_real(t(zr).reshape(3, 4, N, S), t(mr)).numpy()
    else:
        fn = getattr(tq, op)
        got = fn(t(zr), t(zi), t(mr), t(mi)).numpy()
        want = np.asarray(jax.vmap(
            lambda a, b: jk.quad_form(a, b, jnp.asarray(mr), jnp.asarray(mi)))(
                jnp.asarray(zr), jnp.asarray(zi)))
        got4 = fn(t(zr).reshape(3, 4, N, S), t(zi).reshape(3, 4, N, S), t(mr), t(mi)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12 * np.abs(want).max())
    np.testing.assert_array_equal(got4.reshape(got.shape), got)


def test_qf_real_plain_matches_pallas_interpret():
    """The shapes of test_qf_real_pallas_interpret_matches_xla (non-multiple
    BL, non-128 lanes), float32.  Tolerance rtol 2e-4 + 2e-3·max|ref|: the
    Pallas kernel multiplies in three bf16 passes and sums N² terms in
    another order."""
    rng = np.random.default_rng(5)
    nw, n, s, bl, g = 8, 33, 20, 11, 4
    w = rng.standard_normal((nw, n, s)).astype(np.float32)
    m = rng.standard_normal((bl, n, n)).astype(np.float32)
    m = m + np.swapaxes(m, -1, -2)
    wg = jnp.swapaxes(jnp.asarray(w).reshape(nw // g, g, n, s), 1, 2).reshape(nw // g, n, g * s)
    pal = np.asarray(jk.qf_real_pallas(wg, jnp.asarray(m), tile_bl=8, interpret=True))
    pal = pal.reshape(nw // g, bl, g, s).transpose(0, 2, 1, 3).reshape(nw, bl, s)
    got = tq.quad_form_real(t(w, torch.float32), t(m, torch.float32)).numpy()
    np.testing.assert_allclose(got, pal, rtol=2e-4, atol=2e-3 * np.abs(pal).max())


def test_cf_half_plain_matches_pallas_interpret(data):
    """Both halves against ``_cf_half`` in interpret mode and the combined op
    against ``cf_contract_pallas`` (float32, rtol 2e-4 + 2e-3·max|ref|)."""
    zr, zi, mr, mi = (np.asarray(x, np.float32) for x in data)
    o1, o2 = jk._cf_half(jnp.asarray(mr), jnp.asarray(zr), jnp.asarray(zi), 8, True)
    g1, g2 = tq.cf_half_plain(t(mr, torch.float32), t(zr, torch.float32), t(zi, torch.float32))
    for got, want in ((g1, o1), (g2, o2)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-3 * np.abs(want).max())
    pal = np.asarray(jk.cf_contract_pallas(*map(jnp.asarray, (zr, zi, mr, mi)),
                                           tile_bl=8, interpret=True))
    got = tq.cf_contract(*(t(x, torch.float32) for x in (zr, zi, mr, mi))).numpy()
    np.testing.assert_allclose(got, pal, rtol=2e-4, atol=2e-3 * np.abs(pal).max())


@pytest.mark.parametrize("n1", [9, 33])
def test_fold_helpers_bitwise(n1):
    """Host NumPy copies: bitwise equal to the JAX package's."""
    rng = np.random.default_rng(n1)
    m = rng.standard_normal((3, n1, n1)) + 1j * rng.standard_normal((3, n1, n1))
    np.testing.assert_array_equal(tq.herm_fold_matrix(n1), jk.herm_fold_matrix(n1))
    f = tq.herm_fold(m)
    np.testing.assert_array_equal(f, jk.herm_fold(m))
    np.testing.assert_array_equal(tq.trim_nyquist(f, n1 // 2), jk.trim_nyquist(f, n1 // 2))
    # the fold is the congruence Re(Aᵀ M A)
    a = tq.herm_fold_matrix(n1)
    np.testing.assert_allclose(f, np.real(np.einsum("ni,bnm,mj->bij", a, m, a)), atol=1e-12)


@pytest.mark.parametrize("nh_full", [True, False])
def test_herm_w_matches_jax(nh_full):
    rng = np.random.default_rng(2)
    nc, s, nw = 8, 5, 3
    nh = nc + 1 if nh_full else nc
    cre, cim = rng.standard_normal((2, nw, 2 * nc + 1))
    pr, pi = rng.standard_normal((2, nh, s))
    want = np.asarray(jk.herm_w((jnp.asarray(cre), jnp.asarray(cim)),
                                (jnp.asarray(pr), jnp.asarray(pi)), nc))
    got = tq.herm_w((t(cre), t(cim)), (t(pr), t(pi)), nc)
    assert got.is_contiguous() and got.shape == (nw, 2 * nh - 1, s)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-15)


def test_gradcheck_quad_form_real():
    rng = np.random.default_rng(3)
    w = t(rng.standard_normal((3, 9, 5))).requires_grad_(True)
    m = t(rng.standard_normal((4, 9, 9)))
    assert torch.autograd.gradcheck(tq.quad_form_real, (w, m))
    # and equal to the JAX custom-JVP gradient of the same scalar
    g = torch.autograd.grad(tq.quad_form_real(w, m).sum(), w)[0].numpy()
    jm = jnp.asarray(m.numpy())
    gj = jax.grad(lambda x: jnp.sum(jax.vmap(lambda a: jk.quad_form_real(a, jm))(x)))(
        jnp.asarray(w.detach().numpy()))
    np.testing.assert_allclose(g, np.asarray(gj), rtol=1e-10, atol=1e-12)


def test_gradcheck_cf_contract():
    rng = np.random.default_rng(4)
    zr = t(rng.standard_normal((3, 9, 5))).requires_grad_(True)
    zi = t(rng.standard_normal((3, 9, 5))).requires_grad_(True)
    mr, mi = t(rng.standard_normal((4, 9, 9))), t(rng.standard_normal((4, 9, 9)))
    assert torch.autograd.gradcheck(tq.cf_contract, (zr, zi, mr, mi))


def test_wrappers_refuse_cpu_tensors_and_count_nothing(data):
    """The CUDA wrappers raise on what the kernel does not take; the public op
    on a CPU tensor launches nothing."""
    zr, zi, mr, _ = data
    tq.reset_launch_counts()
    with pytest.raises(ValueError):
        tq.qf_real_cuda(t(zr), t(mr))
    with pytest.raises(ValueError):
        tq.cf_half_cuda(t(mr), t(zr), t(zi))
    tq.quad_form_real(t(zr), t(mr))
    assert tq.LAUNCHES == {"qf_real": 0, "cf_half": 0} and not tq.LAUNCHES_BY_SHAPE


@pytest.mark.parametrize("n, multiple, n_padded", [
    (33, 8, 40), (255, 8, 256), (32, 8, 32),
    (33, 16, 48), (255, 16, 256), (257, 16, 272)])  # 16: the float64 kernels' pad
def test_tril_fold_keeps_the_quadratic_forms(n, multiple, n_padded):
    """The layout the kernels read: lower triangular, zero-padded, and the
    same forms as the full matrix — zᵀ L z = zᵀ M z, and both outputs of the
    half kernel (float64, 1e-12 of the largest value: the sums are reordered)."""
    rng = np.random.default_rng(5)
    m = t(rng.standard_normal((3, n, n)))
    zr, zi = t(rng.standard_normal((2, n, 4))), t(rng.standard_normal((2, n, 4)))
    low = tq.tril_fold(m, multiple)
    assert low.shape == (3, n_padded, n_padded) and low.is_contiguous()
    assert low.data_ptr() % 16 == 0
    assert torch.equal(low, torch.tril(low)) and low[:, n:, :].abs().sum() == 0
    assert torch.equal(low.diagonal(dim1=-2, dim2=-1)[:, :n], m.diagonal(dim1=-2, dim2=-1))
    pad = lambda z: torch.nn.functional.pad(z, (0, 0, 0, n_padded - n))

    def close(got, want):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12 * float(want.abs().max()))

    close(tq.qf_real_plain(pad(zr), low), tq.qf_real_plain(zr, m))
    for got, want in zip(tq.cf_half_plain(low, pad(zr), pad(zi)), tq.cf_half_plain(m, zr, zi)):
        close(got, want)


@pytest.mark.parametrize("n", [33, 64, 255, 257])
def test_kernel_layout_is_the_fold_padded(n):
    """The layout the float32 CUDA kernels read, as ``kernel_matrices`` makes
    it once per model: ``tril_fold`` at the float32 kernel's padding, (BL,
    NP, NP) with NP the next multiple of 64; the lower triangle of M + Mᵀ
    with M's diagonal, nothing right of the diagonal and nothing in the
    padding."""
    rng = np.random.default_rng(n)
    m = t(rng.standard_normal((3, n, n)) * 10.0 ** rng.uniform(-3, 3, (3, n, n)), torch.float32)
    lay = tq.tril_fold(m, 64)
    npad = -(-n // 64) * 64
    assert lay.shape == (3, npad, npad) and lay.is_contiguous()
    assert torch.equal(lay, torch.tril(lay))
    assert not lay[:, n:, :].any() and not lay[:, :, n:].any()
    sym = m + m.transpose(-1, -2)
    assert torch.equal(lay[:, :n, :n].tril(-1), sym.tril(-1))
    assert torch.equal(lay[:, :n, :n].diagonal(dim1=-2, dim2=-1), m.diagonal(dim1=-2, dim2=-1))


@pytest.mark.parametrize("n", [33, 255])
def test_tf32_split_of_the_layout(n):
    """The split the float32 kernels make on the chip: L_hi = the float32
    fold as the tensor core reads it (the low 13 bits dropped), L_lo = the
    rest rounded to TF32.  Both are exactly TF32 (low 13 mantissa bits zero)
    and hi + lo is within 2⁻²¹ of the fold, relative."""
    rng = np.random.default_rng(n + 1)
    m = t(rng.standard_normal((3, n, n)) * 10.0 ** rng.uniform(-3, 3, (3, n, n)), torch.float32)
    fold = tq.tril_fold(m, 64)
    hi = _tf32_bits(fold, False)
    lo = _tf32_bits(fold - hi, True)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    err = ((hi.double() + lo.double()) - fold.double()).abs()
    assert bool((err <= 2.0 ** -21 * fold.double().abs()).all())
    assert bool(((fold - hi).abs() <= 2.0 ** -10 * fold.abs()).all())


def _tf32_bits(x, rounded: bool):
    """TF32 by bit masking: the low 13 bits of the float32 pattern cleared,
    after adding half their range when ``rounded`` (nearest, ties away), as
    the tensor core reads an operand when not (truncation)."""
    bits = x.contiguous().view(torch.int32)
    if rounded:
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


def _qf_tf32(w, m, passes: int):
    """The float32 kernel's arithmetic in plain torch on the fold L of m:
    w split into hi = TF32(w) and lo = w − hi (which the tensor core reads
    truncated), L into hi = L as the tensor core reads a float32 operand
    (truncated) and lo = TF32(L − hi); V = L w as lo·hi + hi·lo + hi·hi
    (passes = 3) or hi·hi alone (passes = 1), every product and sum in
    float32; then Σ_n w ⊙ V in float32."""
    low = tq.tril_fold(m, 64)
    wp = torch.nn.functional.pad(w, (0, 0, 0, low.shape[-1] - w.shape[1]))
    wh = _tf32_bits(wp, True)
    wl = _tf32_bits(wp - wh, False)
    lh = _tf32_bits(low, False)
    ll = _tf32_bits(low - lh, True)
    prod = lambda a, b: torch.einsum("bnm,wms->wbns", a, b)
    v = prod(lh, wh) if passes == 1 else prod(ll, wh) + prod(lh, wl) + prod(lh, wh)
    return torch.einsum("wns,wbns->wbs", wp, v)


def test_3xtf32_arithmetic_keeps_float32_grade_accuracy():
    """At the flagship's N = 255 (W=2, S=80, BL=8): the 3xTF32 arithmetic of
    the float32 kernels, emulated in float32, stays within ``chip_smoke.py``'s
    float32 kernel-check tolerance (rtol 2e-4 + 2e-3·max|ref|) of the float64
    plain version, and 30 times closer to it than a lone TF32 pass, which the
    kernels do not use."""
    rng = np.random.default_rng(11)
    w = t(rng.standard_normal((2, 255, 80)), torch.float32)
    m = t(rng.standard_normal((8, 255, 255)), torch.float32)
    ref = tq.qf_real_plain(w.double(), m.double())
    scale = float(ref.abs().max())
    err3 = (_qf_tf32(w, m, 3).double() - ref).abs()
    err1 = (_qf_tf32(w, m, 1).double() - ref).abs()
    assert bool((err3 <= 2e-4 * ref.abs() + 2e-3 * scale).all())
    assert float(err3.max()) * 30 < float(err1.max()), (float(err3.max()), float(err1.max()))


def test_gradcheck_quad_form_real_with_prepared_layout():
    """``prepared`` is a forward-only argument: no gradient, the same value
    and gradient as without it (the CPU path ignores it)."""
    rng = np.random.default_rng(6)
    w = t(rng.standard_normal((3, 9, 5))).requires_grad_(True)
    m = t(rng.standard_normal((4, 9, 9)))
    lay = tq.tril_fold(m, 32)
    assert torch.autograd.gradcheck(lambda x: tq.quad_form_real(x, m, lay), (w,))
    assert torch.equal(tq.quad_form_real(w, m, lay), tq.quad_form_real(w, m))


def test_cf_contract_with_prepared_layouts():
    """``prepared`` of ``cf_contract`` (the kernel layouts of mr and mi) is a
    forward-only argument: on the CPU the same value and gradient as
    without it."""
    rng = np.random.default_rng(8)
    zr, zi = (t(rng.standard_normal((2, 9, 4))).requires_grad_(True) for _ in range(2))
    mr, mi = (t(rng.standard_normal((3, 9, 9))) for _ in range(2))
    lays = (tq.tril_fold(mr, 8), tq.tril_fold(mi, 8))
    assert torch.autograd.gradcheck(lambda a, b: tq.cf_contract(a, b, mr, mi, lays), (zr, zi))
    assert torch.equal(tq.cf_contract(zr, zi, mr, mi, lays), tq.cf_contract(zr, zi, mr, mi))


def _kernel_constants():
    """RB, KT, PAD, TP of the float64 kernels, read from their source."""
    import re
    from pathlib import Path

    src = (Path(tq.__file__).parent.parent / "csrc" / "quadform.cu").read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in ("RB", "KT", "PAD", "TP")}


def _dmma_schedule(lay, z0, z1=None):
    """The float64 kernels' schedule (csrc/quadform.cu) in float64 torch.

    Columns j = w * S + s in tiles of TP product columns (qf_real: TP of w;
    cf_half: TP / 2 of zr beside the same of zi), zero-filled past N and past
    W * S; per tile and b, row blocks of RB rows of the fold L, each against
    the depths left of and on its diagonal block in stages of KT depths, a
    stage in m16n8k16 steps of 16, steps 0, 1 to the first depth half of
    the warps and 2, 3 to the second; a 16-row tile is skipped at a step
    right of its diagonal (checked to hold only zeros of L); when a row
    block ends each half multiplies its part of V by z and sums over the
    rows; per b the second half's sums are added to the first's."""
    k = _kernel_constants()
    rb, kt, tp = k["RB"], k["KT"], k["TP"]
    nz = 1 if z1 is None else 2
    nw, n, s = z0.shape
    bl, np_, _ = lay.shape
    tj, ncol = tp // nz, nw * s
    assert np_ % k["PAD"] == 0 and np_ >= n
    zc = [z.permute(1, 0, 2).reshape(n, ncol) for z in ((z0,) if nz == 1 else (z0, z1))]
    outs = [torch.zeros(bl, ncol, dtype=torch.float64) for _ in range(nz)]
    skipped = 0
    for ct in range(-(-ncol // tj)):
        j0, j1 = ct * tj, min(ncol, (ct + 1) * tj)
        ws = torch.zeros(np_, tp, dtype=torch.float64)  # the resident tile
        for p in range(nz):
            ws[:n, p * tj:p * tj + j1 - j0] = zc[p][:, j0:j1]
        for b in range(bl):
            sums = torch.zeros(2, nz, tj, dtype=torch.float64)  # [depth half][output][column]
            for h in range(-(-np_ // rb)):
                dend = min(np_, rb * (h + 1))
                nti = min(rb // 16, (np_ - rb * h) // 16)
                v = torch.zeros(2, rb, tp, dtype=torch.float64)  # each half's part of V
                for m0 in range(0, dend, kt):
                    for ks in range(kt // 16):
                        d = m0 + 16 * ks
                        if d >= dend:
                            break
                        i0 = max(0, d - rb * h) // 16
                        for i in range(nti):
                            rows = slice(rb * h + 16 * i, rb * h + 16 * i + 16)
                            blk = lay[b, rows, d:d + 16]
                            if i < i0:
                                assert not blk.any()
                                skipped += 1
                                continue
                            v[ks // (kt // 32), 16 * i:16 * i + 16] += blk @ ws[d:d + 16]
                zt = ws[rb * h:rb * h + 16 * nti]
                for half in range(2):
                    vh = v[half, :16 * nti]
                    if nz == 1:
                        sums[half, 0] += (zt * vh).sum(0)
                    else:
                        zr, zi, vr, vi = zt[:, :tj], zt[:, tj:], vh[:, :tj], vh[:, tj:]
                        sums[half, 0] += (zr * vr - zi * vi).sum(0)
                        sums[half, 1] += (zr * vi + zi * vr).sum(0)
            for p in range(nz):
                outs[p][b, j0:j1] = (sums[0, p] + sums[1, p])[:j1 - j0]
    res = tuple(o.reshape(bl, nw, s).permute(1, 0, 2) for o in outs)
    return (res[0] if nz == 1 else res), skipped


@pytest.mark.parametrize("n", [33, 255, 257])
def test_float64_kernel_schedule_covers_the_triangle(n):
    """The walk of the float64 DMMA kernels over the lower triangle (row
    blocks, stages, the k16 steps dealt to the two depth halves, 16-row tiles
    skipped right of the diagonal, the pad to a multiple of 16), emulated in
    float64, gives qf_real and both cf_half outputs of the plain versions to
    1e-12 relative; W * S = 3 * 30 = 90 is not a multiple of either column
    tile (64 of w, 32 of [zr | zi]), and the skipped tiles hold only zeros."""
    rng = np.random.default_rng(n + 7)
    nw, s, bl = 3, 30, 2
    m = t(rng.standard_normal((bl, n, n)))
    zr, zi = (t(rng.standard_normal((nw, n, s))) for _ in range(2))
    pad = _kernel_constants()["PAD"]
    lay = tq.tril_fold(m, pad)
    assert lay.shape[-1] == -(-n // pad) * pad

    def close(got, want):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12 * float(want.abs().max()))

    got, skipped = _dmma_schedule(lay, zr)
    close(got, tq.qf_real_plain(zr, m))
    assert skipped > 0
    (g1, g2), _ = _dmma_schedule(lay, zr, zi)
    r1, r2 = tq.cf_half_plain(m, zr, zi)
    close(g1, r1)
    close(g2, r2)
