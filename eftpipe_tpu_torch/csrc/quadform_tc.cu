// Fused quadratic forms  out[w,b,s] = sum_n w[w,n,s] * sum_m M[b,n,m] w[w,m,s]
// in float32 on Hopper's tensor cores (sm_90a), plain C interface, loaded with
// ctypes.
//
// Replaces the two Pallas TPU kernels of eftpipe_tpu/ops/pallas_kernels.py:
//   qf_real  <- _qf_real_kernel  (real, Hermitian-folded form, the main path)
//   cf_half  <- _cf_half_kernel  (one real part of a complex M against both
//                                 parts of z; the A/B reference of the fold)
// The float64 instances stay on the FMA template of quadform.cu.
//
// The instruction: wgmma.mma_async.sync.aligned.m64nNk8.f32.tf32.tf32, A from
// registers, B from shared memory (N = 64; 48, 32, 16 on the diagonal).
// The split (3xTF32, the counterpart of the TPU kernel's three bf16 passes):
// every operand is hi + lo, and each product is lo*hi + hi*lo + hi*hi.  For w,
// hi = w rounded to TF32 (10-bit mantissa, nearest, ties away) and lo = w -
// hi; for L, hi = L itself (the tensor core reads the top 19 bits of a
// float32 operand: a truncation) and lo = L - hi rounded to TF32.  Both lo
// errors have zero mean, and the dropped lo*lo term is below 2^-21 of the
// product.  The tensor cores also truncate the sums they accumulate, and a
// running sum of a few hundred such steps drifts toward zero by several
// float32 ulps: each staged tile's passes therefore go into a fresh
// accumulator, added to the running sum by an IEEE float32 add.
//
// What bounds it: operations.  Per b the form is a GEMM V_b = L_b w with
// N x N x (W*S) multiply-adds and a few bytes per column, far above the
// card's ridge; three TF32 passes on the tensor cores are the least time.
// In practice the kernel reaches about 40 % of that: on the H100 a third of
// the tensor work saves a fifth of the time, and so does dropping the lo
// pass of the producers, while twice the bytes of L from L2 cost more than
// the lo pass (PERF.md, PR 3).
// The design, with D = V^T (M = 64 columns of w a warpgroup, N = 64 rows of
// L, K = depth):
//
//  * Only the symmetric part of M enters w^T M w.  The model hands over, once
//    (ops/quadform.py kernel_matrices), L = the lower triangle of M + M^T
//    with the diagonal of M, zero-padded to (NP, NP), NP a multiple of 64,
//    in float32.
//  * One L_b is 256 KB, more than a block's shared memory, so a block keeps a
//    COLUMN tile of w resident instead: NP rows of 128 columns of the
//    flattened (walker, s) axis (64 each of zr and zi for cf_half), stored
//    column-major, loaded by cp.async, and serving a run of b.
//  * Persistent grid: one block an SM, each walking an equal share of the
//    (column tile, b) pairs in order and reloading its resident tile when
//    the column tile changes.  A grid of one block per (column tile, run of
//    b) left the last of its waves part-empty.
//  * Warp-specialised: two consumer warpgroups each own 64 of those columns
//    (cf_half: one of zr, zi); their A fragments come from the resident tile
//    by ldmatrix and are split into hi and lo in registers.  A producer
//    warpgroup streams L_b: float32 tiles (the 64 rows of a row block, 32
//    deep, 16 when N > 256) land by cp.async in one of a few shared buffers,
//    laid out as the 8 x 16-byte core matrices of a no-swizzle K-major wgmma
//    operand (wgmma reads B from shared memory only); the tile serves as L_hi
//    in place and the producers write L_lo beside it, a few tiles behind the
//    copies in flight.  Full and empty mbarriers hand the buffers over; the
//    consumers never meet the producers at a block barrier.  (L_hi and L_lo
//    split once at build instead, read as two planes, took twice the bytes
//    from L2 and was slower on the main path: PERF.md.)
//  * Only rows on or below the diagonal are loaded and multiplied: left of
//    the diagonal block a tile is one N = 64 wgmma per pass and k-step; the
//    diagonal block's tiles, unrolled at compile time, take the rows from
//    the 16-row group of their depth on (N = 64, 48, 32, 16, each with an
//    accumulator of its own); 34,816 multiply-adds per column at NP = 256,
//    where the exact triangle needs 32,896.
//  * When a row block ends a warpgroup multiplies its V by w and sums over
//    the rows in registers and by shuffles: V never reaches device memory.
//    Per b the two warpgroups combine through shared memory and store: no
//    atomics, sums in a fixed order, bitwise repeatable runs.
//  * Ragged edges (rows past N, columns past W*S) are zero-filled in the
//    resident tile and never stored.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int CONSUMERS = 256;                  // two consumer warpgroups: warps 0-7
constexpr int PRODUCERS = 128;                  // a producer warpgroup: warps 8-11
constexpr int THREADS = PRODUCERS + CONSUMERS;
constexpr int RBN = 64;                         // rows of L in a row block: one wgmma's N
constexpr int PAD = RBN;                        // NP is a multiple of it
constexpr int LBO = 128;                        // bytes between core matrices along the depth
constexpr int RED_FLOATS = 2 * 2 * 2 * 64;      // [b parity][warpgroup][sum][row]
constexpr int BAR_PRODUCERS = 1, BAR_CONSUMERS = 2;  // named barriers

// A staged tile of L: the 64 rows of a row block at KT depths, in one of SS
// buffers, its hi plane followed by its lo plane: the float32 tile lands as
// the hi plane (the tensor core reads its top 19 bits) and the producers
// write the lo plane LAG tiles behind the copies they issue.
template <int NZ, int KT>
struct Cfg {
  static constexpr int TJ = 128 / NZ;           // columns of the resident tile
  static constexpr int KS = KT / 8;             // wgmma k-steps in a tile
  static constexpr int TILE = RBN * KT * 4;     // bytes of one plane of a tile
  static constexpr int SBO = (KT / 4) * 128;    // bytes between 8-row core-matrix groups
  static constexpr int SS = KT == 32 ? 5 : 6;
  static constexpr int LAG = SS - 3;
  static constexpr int RING = SS * 2 * TILE;
  static_assert(RBN % KT == 0 && KT % 16 == 0, "tile depth");
};

template <int NZ, int KT>
size_t smem_bytes(int np) {
  using C = Cfg<NZ, KT>;
  return size_t(C::RING) + sizeof(float) * (size_t(NZ) * C::TJ * (np + 4) + RED_FLOATS)
         + 2 * sizeof(long long) * C::TJ + 2 * sizeof(uint64_t) * C::SS;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return unsigned(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               ::"r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void copy16(unsigned dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(b)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(b)), "r"(parity) : "memory");
}

__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// hi = x rounded to TF32 (nearest, ties away: the low 13 bits cleared),
// lo = x - hi, exact (the tensor core reads its top 11 bits)
__device__ __forceinline__ void split(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// the part of a float32 L element past what the tensor core reads of it (its
// top 19 bits, a truncation), rounded to TF32
__device__ __forceinline__ float lo_part(float x) {
  const float hi = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  return __uint_as_float((__float_as_uint(x - hi) + 0x1000u) & 0xffffe000u);
}

// no-swizzle K-major descriptor of the B tile starting at shared address addr
__device__ __forceinline__ uint64_t desc(unsigned addr, int sbo) {
  return uint64_t((addr >> 4) & 0x3FFF) | (uint64_t(LBO >> 4) << 16) | (uint64_t(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// keeps the compiler from touching an accumulator across an asynchronous wgmma
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// D (N/2 registers a thread) = A (registers) x B (descriptor) [+ D when acc]
__device__ __forceinline__ void wgmma_n16(float* d, const uint32_t (&a)[4], uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

__device__ __forceinline__ void wgmma_n32(float* d, const uint32_t (&a)[4], uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

__device__ __forceinline__ void wgmma_n48(float* d, const uint32_t (&a)[4], uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t (&a)[4], uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

template <int I, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    static_for<I + 1, N>(f);
  }
}

// NZ = 1: out0 = sum_n z0 .* (L z0)                          (qf_real)
// NZ = 2: out0 = sum_n z0 .* (L z0) - z1 .* (L z1)
//         out1 = sum_n z0 .* (L z1) + z1 .* (L z0)            (cf_half)
// z*: (W, N, S), out*: (W, BL, S), contiguous; l: (BL, NP, NP), the LOWER
// TRIANGULAR matrices L zero-padded to NP = a multiple of 64, 16-byte aligned.
template <int NZ, int KT>
__global__ void __launch_bounds__(THREADS, 1)
qf_wg_kernel(const float* __restrict__ z0, const float* __restrict__ z1,
             const float* __restrict__ l, float* __restrict__ out0,
             float* __restrict__ out1, int W, int N, int NP, int S, int BL) {
  using C = Cfg<NZ, KT>;
  constexpr int TJ = C::TJ, KS = C::KS, TILE = C::TILE, SBO = C::SBO, SS = C::SS, LAG = C::LAG;
  const int ldw = NP + 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ws = reinterpret_cast<float*>(smem_raw + C::RING);                // NZ x [TJ][ldw]
  float* red = ws + size_t(NZ) * TJ * ldw;                                // [2][2][2][64]
  long long* colbase = reinterpret_cast<long long*>(red + RED_FLOATS);    // [TJ]
  long long* outbase = colbase + TJ;                                       // [TJ]
  uint64_t* full = reinterpret_cast<uint64_t*>(outbase + TJ);             // [SS]
  uint64_t* empty = full + SS;                                             // [SS]
  const unsigned bufs = smem_addr(smem_raw);                  // SS hi/lo buffers

  const int tid = threadIdx.x;
  const long long ncol = (long long)W * S;
  const int nrb = NP / RBN;
  // the block's pairs u = (column tile) * BL + b, u0 <= u < u1
  const long long pairs = (ncol + TJ - 1) / TJ * BL;
  const long long u0 = blockIdx.x * pairs / gridDim.x;
  const long long u1 = (blockIdx.x + 1) * pairs / gridDim.x;
  const int total = int(u1 - u0) * (nrb * (nrb + 1) / 2) * (RBN / KT);  // tiles of its run

  if (tid == 0) {
    for (int s = 0; s < SS; ++s) {
      mbar_init(full + s, PRODUCERS);
      mbar_init(empty + s, CONSUMERS);
    }
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producers: tile t = (b, row block h, depth m0) in the consumers'
    // order; rows max(RBN*h, m0) .. RBN*(h+1)-1 (the rows above lie above
    // the diagonal)
    int b = int(u0 % BL), h = 0, m0 = 0;
    // each producer thread copies the same 16-byte chunk (k4) of NI rows of
    // a tile; the eight lanes that share a chunk take eight consecutive rows,
    // whose chunks are 128 contiguous bytes of the staged tile (no two in a
    // bank)
    constexpr int CPR = KT / 4, GP = PRODUCERS / (8 * CPR), NI = RBN / (8 * GP);
    static_assert(GP * 8 * CPR == PRODUCERS && NI * 8 * GP == RBN, "copy map");
    const int pt = tid - CONSUMERS;
    const int r8 = pt & 7, k4 = (pt >> 3) % CPR, g8 = pt / (8 * CPR);
    auto issue = [&](unsigned dst) {
      const int r0 = max(RBN * h, m0) - RBN * h;  // first row of the tile to load
      const float* src = l + size_t(b) * NP * NP + size_t(RBN * h) * NP + m0 + 4 * k4;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int nl = (g8 + GP * i) * 8 + r8;
        if (nl >= r0)
          copy16(dst + ((nl >> 3) * CPR + k4) * 128 + (nl & 7) * 16, src + size_t(nl) * NP);
      }
      m0 += KT;
      if (m0 == RBN * (h + 1)) {
        m0 = 0;
        if (++h == nrb) {
          h = 0;
          if (++b == BL) b = 0;
        }
      }
    };
    // tile t's copies have landed (for every producer): write its lo plane
    // and hand it over
    auto finish = [&](int t) {
      named_barrier(BAR_PRODUCERS, PRODUCERS);
      const int s = t % SS;
      const float4* hi = reinterpret_cast<const float4*>(smem_raw + s * 2 * TILE);
      float4* lo = reinterpret_cast<float4*>(smem_raw + s * 2 * TILE + TILE);
#pragma unroll
      for (int i = pt; i < TILE / 16; i += PRODUCERS) {
        const float4 x = hi[i];
        lo[i] = make_float4(lo_part(x.x), lo_part(x.y), lo_part(x.z), lo_part(x.w));
      }
      fence_proxy_async();
      mbar_arrive(full + s);
    };
    for (int t = 0; t < total; ++t) {
      const int s = t % SS, k = t / SS;
      if (k > 0) mbar_wait(empty + s, (k - 1) & 1);  // the consumers are done with buffer s
      issue(bufs + s * 2 * TILE);
      commit();
      if (t >= LAG) {
        wait_group<LAG>();  // tile t - LAG landed
        finish(t - LAG);
      }
    }
    wait_group<0>();
    for (int t = max(0, total - LAG); t < total; ++t) finish(t);
    return;
  }

  // ---- consumers
  const int ct = tid;
  const int lane = ct & 31, warp = ct >> 5;
  const int wg = warp >> 2, wl = warp & 3;                 // warpgroup, warp in it
  const int g = lane >> 2, t4 = lane & 3;                  // fragment coordinates
  const int q = lane >> 3, rr = lane & 7;                  // ldmatrix address of this lane
  const float* wz = ws + size_t(NZ == 2 ? wg : 0) * TJ * ldw;   // the plane it multiplies
  const float* wx = ws + size_t(NZ == 2 ? 1 - wg : 0) * TJ * ldw;
  const int cb = NZ == 2 ? 0 : wg * 64;                    // its first column of the tile
  const int row0 = cb + 16 * wl + g;                       // its rows of D: row0, row0 + 8

  // the row block's accumulators, and one fresh accumulator for each row
  // range a tile's k-steps take: rows 0.., 16.., 32.., 48..
  float acc[32], t64[32], t48[24], t32[16], t16[8];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float same[2] = {0.f, 0.f}, cross[2] = {0.f, 0.f};

  // One tile at depth m0 of row block h.  OFF < 0: left of the diagonal
  // block, all 64 rows; OFF = 0 .. RBN/KT - 1: the diagonal block's tile at
  // depth KT * OFF, whose k-step at depth d takes rows 16 * (d / 16) ..
  // (the rest lies above the diagonal).
  int t = 0;
  auto tile = [&](auto OFF, int h, int m0, bool last_of_b, int b) {
    constexpr int off = decltype(OFF)::value;
    auto first_row = [](int ks) { return off < 0 ? 0 : (KT * off + 8 * ks) / 16; };
    const int s = t % SS;
    uint32_t ah[KS][4], al[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      ldmatrix4(a, wz + (cb + 16 * wl + (q & 1) * 8 + rr) * ldw + m0 + ks * 8 + (q >> 1) * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) split(a[e], ah[ks][e], al[ks][e]);
    }
    mbar_wait(full + s, (t / SS) & 1);
    const unsigned sb = bufs + s * 2 * TILE;
    wgmma_fence();
    static_for<0, KS>([&](auto KSC) {
      constexpr int ks = decltype(KSC)::value;
      constexpr int o = off < 0 ? 0 : (KT * off + 8 * ks) / 16;
      constexpr int init = ks == 0 || (off >= 0 && (KT * off + 8 * (ks - 1)) / 16 != o);
      const unsigned k = sb + 2 * o * SBO + ks * 2 * LBO;
      float* d = o == 0 ? t64 : o == 1 ? t48 : o == 2 ? t32 : t16;
      auto mm = [&](const uint32_t (&a)[4], unsigned b, int accumulate) {
        if constexpr (o == 0) wgmma_n64(d, a, desc(b, SBO), accumulate);
        if constexpr (o == 1) wgmma_n48(d, a, desc(b, SBO), accumulate);
        if constexpr (o == 2) wgmma_n32(d, a, desc(b, SBO), accumulate);
        if constexpr (o == 3) wgmma_n16(d, a, desc(b, SBO), accumulate);
      };
      // small terms first, into the fresh accumulator of this row range
      mm(al[ks], k, init ? 0 : 1);
      mm(ah[ks], k + TILE, 1);
      mm(ah[ks], k, 1);
    });
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(t64[i]);
#pragma unroll
    for (int i = 0; i < 24; ++i) fence_reg(t48[i]);
#pragma unroll
    for (int i = 0; i < 16; ++i) fence_reg(t32[i]);
#pragma unroll
    for (int i = 0; i < 8; ++i) fence_reg(t16[i]);
    mbar_arrive(empty + s);
    ++t;
    // add the row ranges this tile took into the row block's sums
    static_for<0, 4>([&](auto OC) {
      constexpr int o = decltype(OC)::value;
      constexpr bool used = off < 0 ? o == 0
                                    : (KT * off) / 16 <= o && o <= (KT * off + KT - 8) / 16;
      if constexpr (used) {
        const float* d = o == 0 ? t64 : o == 1 ? t48 : o == 2 ? t32 : t16;
#pragma unroll
        for (int i = 0; i < 32 - 8 * o; ++i) acc[8 * o + i] += d[i];
      }
    });
    if constexpr (off == RBN / KT - 1) {
      // the row block is done: V times w, summed over this thread's rows
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int n = RBN * h + 8 * i + 2 * t4;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 x = *reinterpret_cast<const float2*>(wz + (row0 + 8 * hh) * ldw + n);
          same[hh] += x.x * acc[4 * i + 2 * hh] + x.y * acc[4 * i + 2 * hh + 1];
          if constexpr (NZ == 2) {
            const float2 y = *reinterpret_cast<const float2*>(wx + (row0 + 8 * hh) * ldw + n);
            cross[hh] += y.x * acc[4 * i + 2 * hh] + y.y * acc[4 * i + 2 * hh + 1];
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * i + e] = 0.f;
      }
      if (last_of_b) {
        // the b is done: sums over this thread's quad, the two warpgroups
        // through `red`, and the store
        float* rd = red + (b & 1) * (RED_FLOATS / 2);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int sh = 1; sh < 4; sh *= 2) {
            same[hh] += __shfl_xor_sync(0xffffffffu, same[hh], sh);
            if constexpr (NZ == 2) cross[hh] += __shfl_xor_sync(0xffffffffu, cross[hh], sh);
          }
          if (t4 == 0) {
            rd[wg * 128 + 16 * wl + g + 8 * hh] = same[hh];
            if constexpr (NZ == 2) rd[wg * 128 + 64 + 16 * wl + g + 8 * hh] = cross[hh];
          }
          same[hh] = 0.f;
          cross[hh] = 0.f;
        }
        named_barrier(BAR_CONSUMERS, CONSUMERS);
        if (ct < TJ) {
          const long long ob = outbase[ct];
          if (ob >= 0) {
            const long long at = ob + (long long)b * S;
            if constexpr (NZ == 1) {
              out0[at] = rd[(ct / 64) * 128 + ct % 64];
            } else {
              out0[at] = rd[ct] - rd[128 + ct];
              out1[at] = rd[128 + 64 + ct] + rd[64 + ct];
            }
          }
        }
      }
    }
  };

  long long loaded = -1;  // the column tile resident in ws
  for (long long u = u0; u < u1; ++u) {
    const long long ctile = u / BL;
    const int b = int(u % BL);
    if (ctile != loaded) {
      // ---- the resident tile: columns ctile*TJ .. +TJ-1, all NP rows,
      // column-major; the consumers are done with the previous one
      named_barrier(BAR_CONSUMERS, CONSUMERS);
      if (ct < TJ) {
        const long long j = ctile * TJ + ct;
        const bool ok = j < ncol;
        colbase[ct] = ok ? (j / S) * (long long)N * S + (j % S) : -1;
        outbase[ct] = ok ? (j / S) * (long long)BL * S + (j % S) : -1;
      }
      named_barrier(BAR_CONSUMERS, CONSUMERS);
      for (int idx = ct; idx < TJ * NP; idx += CONSUMERS) {
        // a warp covers 8 columns x 4 rows: 32 distinct banks
        const int grp = idx >> 5, ln = idx & 31;
        const int jj = (grp % (TJ / 8)) * 8 + (ln & 7);
        const int n = (grp / (TJ / 8)) * 4 + (ln >> 3);
        const long long base = colbase[jj];
        const bool ok = base >= 0 && n < N;
        const long long off = ok ? base + (long long)n * S : 0;
        copy4(ws + jj * ldw + n, z0 + off, ok);
        if constexpr (NZ == 2) copy4(ws + size_t(TJ) * ldw + jj * ldw + n, z1 + off, ok);
      }
      commit();
      wait_group<0>();
      named_barrier(BAR_CONSUMERS, CONSUMERS);
      loaded = ctile;
    }
    for (int h = 0; h < nrb; ++h) {
      for (int kk = 0; kk < (RBN / KT) * h; ++kk)
        tile(std::integral_constant<int, -1>{}, h, kk * KT, false, b);
      static_for<0, RBN / KT>([&](auto D) {
        tile(D, h, RBN * h + KT * decltype(D)::value, h == nrb - 1, b);
      });
    }
  }
}

template <int NZ, int KT>
cudaError_t launch_kernel(const float* z0, const float* z1, const float* l, float* out0,
                          float* out1, int W, int N, int NP, int S, int BL, cudaStream_t stream) {
  constexpr int TJ = Cfg<NZ, KT>::TJ;
  const size_t smem = smem_bytes<NZ, KT>(NP);
  auto kernel = qf_wg_kernel<NZ, KT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // one block an SM (as many as fit), or one per (column tile, b) pair
  const long long pairs = ((long long)W * S + TJ - 1) / TJ * BL;
  const long long blocks = std::min((long long)sms * per_sm, pairs);
  if (blocks <= 0) return cudaErrorInvalidConfiguration;
  kernel<<<unsigned(blocks), THREADS, smem, stream>>>(z0, z1, l, out0, out1, W, N, NP, S, BL);
  return cudaGetLastError();
}

constexpr size_t SMEM_LIMIT = 232448;  // bytes of shared memory a block may use

template <int NZ>
int launch(const void* z0, const void* z1, const void* l, void* out0, void* out1,
           int W, int N, int NP, int S, int BL, void* stream) {
  if (W <= 0 || N <= 0 || S <= 0 || BL <= 0 || NP < N || NP % PAD != 0 ||
      reinterpret_cast<size_t>(l) % 16 != 0)
    return int(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(z0);
  const float* c = static_cast<const float*>(z1);
  const float* m = static_cast<const float*>(l);
  float* o0 = static_cast<float*>(out0);
  float* o1 = static_cast<float*>(out1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the deepest tiles whose buffers fit beside the resident tile
  if (smem_bytes<NZ, 32>(NP) <= SMEM_LIMIT)
    return int(launch_kernel<NZ, 32>(a, c, m, o0, o1, W, N, NP, S, BL, st));
  if (smem_bytes<NZ, 16>(NP) <= SMEM_LIMIT)
    return int(launch_kernel<NZ, 16>(a, c, m, o0, o1, W, N, NP, S, BL, st));
  return int(cudaErrorInvalidValue);  // N too large for a resident column tile
}

}  // namespace

extern "C" {

// Each function enqueues one kernel on `stream`, does not synchronise and
// returns cudaGetLastError() as an int (0 = launched).  `l` holds the
// (BL, NP, NP) lower-triangular fold, NP a multiple of eft_qf_tc_pad(); see
// ops/quadform.py kernel_matrices.

int eft_qf_tc_pad() { return PAD; }

int eft_qf_real_f32(const void* w, const void* l, void* out,
                    int W, int N, int NP, int S, int BL, void* stream) {
  return launch<1>(w, nullptr, l, out, nullptr, W, N, NP, S, BL, stream);
}

int eft_cf_half_f32(const void* l, const void* zr, const void* zi, void* out1, void* out2,
                    int W, int N, int NP, int S, int BL, void* stream) {
  return launch<2>(zr, zi, l, out1, out2, W, N, NP, S, BL, stream);
}

const char* eft_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
