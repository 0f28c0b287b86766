// Fused quadratic forms  out[w,b,s] = sum_n w[w,n,s] * sum_m M[b,n,m] w[w,m,s]
// in FLOAT64 on Hopper's float64 tensor cores (sm_90a), plain C interface,
// loaded with ctypes.
//
// Replaces, in float64, the two Pallas TPU kernels of
// eftpipe_tpu/ops/pallas_kernels.py:
//   qf_real  <- _qf_real_kernel  (real, Hermitian-folded form)
//   cf_half  <- _cf_half_kernel  (one real part of a complex M against both
//                                 parts of z; the A/B reference of the fold)
// Both compute V = L z and reduce z .* V over n without V ever reaching
// device memory.  The float32 instances are in quadform_tc.cu (3xTF32).
//
// What bounds it: operations.  Per b the form is a product V_b = L_b Z with
// N x N x (W*S) multiply-adds (half of them, L being a triangle) and a few
// bytes per column, far above the card's ridge; the least time is the
// triangle's operations at the 67 TFLOP/s of the float64 tensor cores (the
// FMA pipe outside them gives half that).
//
// The instruction: mma.sync.aligned.m16n8k16.row.col.f64 (DMMA.16x8x16).
// wgmma has no float64.  On the H100 the m16n8k{4,8,16} shapes all run near
// the float64 tensor-core peak from registers with one warp per SM
// sub-partition; the sm_80 shape m8n8k4 at about half of it.  The design, with D = V
// (M = 16 rows of L, N = 8 columns of z, K = 16 depths):
//
//  * Only the symmetric part of M enters z^T M z.  The model hands over, once
//    (ops/quadform.py kernel_matrices), L = the lower triangle of M + M^T
//    with the diagonal of M, zero-padded to (NP, NP), NP a multiple of 16.
//  * One L_b (NP = 256: 512 KB) is more than a block's shared memory, so a
//    block keeps a COLUMN tile of z resident instead: all NP rows of TP = 64
//    product columns (qf_real: 64 columns of w; cf_half: the same 32 columns
//    of zr and of zi, so that V_r and V_i are one product of L against
//    [zr | zi]), stored column-major with a row pitch of NP + 2 doubles,
//    loaded by cp.async, zero-filled past N and past W*S.
//  * Persistent grid: one block an SM, each walking an equal share of the
//    (column tile, b) pairs in order and reloading its resident tile when
//    the column tile changes.
//  * Warp-specialised: a producer warp streams L through a ring of up to 3
//    shared stages (64 rows x 64 depths, 32 KB) by cp.async 16-byte copies,
//    handed over by full and empty mbarriers (the copies arrive on the full
//    one by cp.async.mbarrier.arrive.noinc); the 8 consumer warps never meet
//    it at a block barrier.  Only the lower triangle is copied and
//    multiplied: a 16-row tile is skipped at the 16 depths right of its
//    diagonal, 34,816 multiply-adds a column at NP = 256 (exact: 32,640).
//  * Consumer warp (cg, kh): the 16 product columns of column group cg (two
//    n8 tiles), all 64 rows of the row block (four m16 tiles), the k16 steps
//    2 kh, 2 kh + 1 of every stage: 16 DMMAs and 40 16-byte shared loads a
//    lane a stage, 32 float64 accumulators.  The two warps of a
//    sub-partition share cg, so the triangle's work is the same on all
//    four.  The DMMA's depth is permuted (k-slot t + 4q is depth 4t + q), so
//    that a lane's A and B fragments are 32 contiguous bytes; the staged
//    rows are XOR-swizzled by the row's parity at 16 bytes and the resident
//    tile's pitch NP + 2 puts neighbouring columns 16 bytes apart: no bank
//    conflicts.
//  * When a row block ends a warp multiplies its part of V by z and sums
//    over its rows in registers; per b it sums over its lanes by shuffles,
//    the second depth half adds its sums to the first's through shared
//    memory, and the first stores.  No V in device memory, no atomics, sums
//    in a fixed order: bitwise repeatable runs.
//
// Bytes: L is read from L2 once per column tile and b, its triangle trimmed
// as multiplied: 34,816 doubles per b at NP = 256, 41 GB a launch at W =
// 1024, S = 80, BL = 114 (1,280 column tiles), ~2 TB/s at the kernel's time.
// A wider tile does not fit: 64 columns of float64 at NP = 272 take 140 KB of
// the 227 KB beside the ring.
//
// What holds it at ~47 % of the bound (PERF.md, PR 7): shared memory feeds
// 0.73 B a multiply-add (the L tile is read by the four column groups), and
// with the producer warp three warps share sub-partition 0, which caps the
// registers at 168 a thread: no room for wider warp tiles or for loads a
// step ahead of the DMMAs.  Slower on the H100: one warp a sub-partition
// with a block barrier a stage, 32-deep stages, wider warp tiles (spills),
// the copies spread over the consumers, L by TMA boxes from one thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int CWARPS = 8;                  // consumer warps: 4 column groups x 2 depth halves
constexpr int CONSUMERS = 32 * CWARPS;
constexpr int THREADS = CONSUMERS + 32;    // and one producer warp
constexpr int RB = 64;                     // rows of L in a row block: four m16 tiles
constexpr int KT = 64;                     // depths of a staged tile: four m16n8k16 steps
constexpr int PAD = 16;                    // NP is a multiple of it
constexpr int TP = 64;                     // product columns of a block
constexpr int STAGE = RB * KT;             // doubles of a staged tile
constexpr int MAX_STAGES = 3;
constexpr int RED = 4 * 16;                // doubles of the depth halves' exchange
static_assert(KT == 64 && RB == 64, "a producer lane copies one 16-byte chunk of a staged row");
constexpr int BAR_CONSUMERS = 1;           // named barriers: the consumers, and
constexpr int BAR_PAIR = 2;                // BAR_PAIR + g: the two warps of column group g
constexpr size_t SMEM_LIMIT = 232448;      // bytes of shared memory a block may use

__host__ __device__ constexpr int ldw_of(int np) { return np + 2; }

size_t smem_bytes(int np, int stages) {
  return sizeof(double) * (size_t(stages) * STAGE + size_t(TP) * ldw_of(np) + RED)
         + 2 * sizeof(uint64_t) * stages;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return unsigned(__cvta_generic_to_shared(p));
}

// 8 bytes from device to shared memory, or zeros
__device__ __forceinline__ void copy8(double* dst, const double* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;"
               ::"r"(smem_addr(dst)), "l"(src), "r"(valid ? 8 : 0) : "memory");
}

__device__ __forceinline__ void copy16(double* dst, const double* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
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

// the barrier's pending arrival of this thread happens when all its earlier
// cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(b))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(b)), "r"(parity) : "memory");
}

// D += A B: A 16 x 16 (a[2q] = A[g][t+4q], a[2q+1] = A[g+8][t+4q]),
// B 16 x 8 (b[q] = B[t+4q][g]), D 16 x 8 (d = D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1]); g = lane / 4, t = lane % 4
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[8], const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
        "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// where a staged row's 16-byte chunk c lies (in doubles): swizzled by the
// row's parity, so that the two rows a quarter-warp reads fill all 32 banks
__device__ __forceinline__ int chunk_at(int row, int c) { return 2 * (c ^ (row & 1)); }

// The walk over the stages of a block's run: column tile `ctile`, matrix b,
// row block h, depth m0; a row block takes the depths left of and on its
// diagonal block, up to NP; the pairs (column tile, b) come in the order
// ctile * BL + b.
struct Walk {
  long long ctile;
  int b, h, m0;
  __device__ int depth_end(int np) const { return min(np, RB * (h + 1)); }
  __device__ void next(int np, int nrb, int bl) {
    m0 += KT;
    if (m0 >= depth_end(np)) {
      m0 = 0;
      if (++h == nrb) {
        h = 0;
        if (++b == bl) {
          b = 0;
          ++ctile;
        }
      }
    }
  }
};

// NZ = 1: out0 = sum_n z0 .* (L z0)                          (qf_real)
// NZ = 2: out0 = sum_n z0 .* (L z0) - z1 .* (L z1)
//         out1 = sum_n z0 .* (L z1) + z1 .* (L z0)            (cf_half)
// z*: (W, N, S), out*: (W, BL, S), contiguous; l: (BL, NP, NP), the LOWER
// TRIANGULAR matrices L zero-padded to NP = a multiple of 16, 16-byte aligned;
// `stages` buffers in the ring.
template <int NZ>
__global__ void __launch_bounds__(THREADS, 1)
qf_dmma_kernel(const double* __restrict__ z0, const double* __restrict__ z1,
               const double* __restrict__ l, double* __restrict__ out0,
               double* __restrict__ out1, int W, int N, int NP, int S, int BL, int stages) {
  constexpr int TJ = TP / NZ;  // columns of z in a tile
  const int ldw = ldw_of(NP);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  double* ring = reinterpret_cast<double*>(smem_raw);               // [stages][RB][KT]
  double* ws = ring + stages * STAGE;                                  // [TP][ldw]
  double* red = ws + TP * ldw;                                         // [4][16]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + RED);            // [stages]
  uint64_t* empty = full + stages;                                     // [stages]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long ncol = (long long)W * S;
  const int nrb = (NP + RB - 1) / RB;
  int per_pair = 0;
  for (int h = 0; h < nrb; ++h) per_pair += (min(NP, RB * (h + 1)) + KT - 1) / KT;
  // the block's pairs u0 <= u < u1, u = (column tile) * BL + b
  const long long pairs = (ncol + TJ - 1) / TJ * BL;
  const long long u0 = blockIdx.x * pairs / gridDim.x;
  const long long u1 = (blockIdx.x + 1) * pairs / gridDim.x;
  const long long total = (u1 - u0) * per_pair;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, CWARPS);
    }
  }
  __syncthreads();

  if (warp == CWARPS) {
    // ---- the producer warp: stage k of the run into buffer k % stages,
    // once every consumer warp is done with the stage before it there.  A
    // warp instruction copies a row (32 chunks of 16 bytes); a chunk is not
    // copied for the 16-row tiles right of whose diagonal it lies.
    Walk pw{u0 / BL, int(u0 % BL), 0, 0};
    int s = 0, parity = 0;
    for (long long k = 0; k < total; ++k) {
      if (k >= stages) mbar_wait(empty + s, parity ^ 1);
      const int dend = pw.depth_end(NP);
      const int nch = (min(KT, dend - pw.m0)) / 2;  // 16-byte chunks of a row
      const int r0 = max(0, pw.m0 - RB * pw.h);
      const int r1 = min(RB, NP - RB * pw.h);
      const double* src = l + (size_t(pw.b) * NP + size_t(RB) * pw.h) * NP + pw.m0;
      double* dst = ring + s * STAGE;
      const int c = lane;
      // the chunk's depth from the diagonal block, and its first row on or
      // below the diagonal
      const int rel = pw.m0 + 2 * c - RB * pw.h;
      const int rfirst = max(r0, rel >= 0 ? rel & ~15 : 0);
      if (c < nch)
        for (int r = rfirst; r < r1; ++r)
          copy16(dst + r * KT + chunk_at(r, c), src + size_t(r) * NP + 2 * c);
      mbar_arrive_on_copies(full + s);
      pw.next(NP, nrb, BL);
      if (++s == stages) {
        s = 0;
        parity ^= 1;
      }
    }
    return;
  }

  // ---- the consumer warps: warp (cg, kh) owns the 16 product columns of
  // column group cg and the k16 steps 2 kh, 2 kh + 1 (depths 32 kh .. 32 kh +
  // 31) of every stage; warps w and w + 4 share a sub-partition and cg
  const int cg = warp & 3, kh = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  auto colbase = [&](int c) { return NZ == 1 ? 16 * cg + 8 * c : 32 * c + 8 * cg; };
  double acc[4][2][4];
  double sum[2][2];  // qf_real: [n8 tile][column pair]; cf_half: [out0, out1][column pair]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.0;
#pragma unroll
  for (int c = 0; c < 2; ++c) sum[c][0] = sum[c][1] = 0.0;

  Walk cw{u0 / BL, int(u0 % BL), 0, 0};
  long long loaded = -1;  // the column tile resident in ws
  int s = 0, parity = 0;  // the buffer of stage k and the phase of its barriers
  for (long long k = 0; k < total; ++k) {
    const long long ctile = cw.ctile;
    const int h = cw.h, m0 = cw.m0, dend = cw.depth_end(NP);
    if (ctile != loaded) {
      // ---- the resident tile, column-major, once every consumer is done
      // with the last one; a warp covers 4 columns x 8 rows, so that it
      // reads whole 32-byte sectors of z
      named_barrier(BAR_CONSUMERS, CONSUMERS);
      for (int idx = tid; idx < TP * NP; idx += CONSUMERS) {
        const int grp = idx >> 5, ln = idx & 31;
        const int pc = (grp % (TP / 4)) * 4 + (ln & 3);
        const int n = (grp / (TP / 4)) * 8 + (ln >> 2);
        const long long j = ctile * TJ + pc % TJ;
        const bool ok = j < ncol && n < N;
        const double* z = NZ == 2 && pc >= TJ ? z1 : z0;
        copy8(ws + pc * ldw + n, z + (ok ? (j / S) * N * (long long)S + (long long)n * S + j % S : 0),
              ok);
      }
      asm volatile("cp.async.wait_all;" ::: "memory");
      named_barrier(BAR_CONSUMERS, CONSUMERS);
      loaded = ctile;
    }

    mbar_wait(full + s, parity);
    const double* st = ring + s * STAGE;
#pragma unroll
    for (int ks = 2 * kh; ks < 2 * kh + 2; ++ks) {
      const int kc = 8 * ks;      // the step's first chunk in a staged row
      const int d = m0 + 2 * kc;  // the step's depths d .. d + 15
      if (d >= dend) break;
      const int i0 = max(0, d - RB * h) / 16;    // first tile on or below the diagonal
      const int nti = min(4, (NP - RB * h) / 16);  // tiles inside NP
      double bf[2][4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const double* p = ws + (colbase(c) + g) * ldw + d + 4 * t;
        const double2 x = *reinterpret_cast<const double2*>(p);
        const double2 y = *reinterpret_cast<const double2*>(p + 2);
        bf[c][0] = x.x; bf[c][1] = x.y; bf[c][2] = y.x; bf[c][3] = y.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < i0 || i >= nti) continue;
        const int r = 16 * i + g;
        const double* p0 = st + r * KT;
        const double* p1 = p0 + 8 * KT;  // row r + 8, of the same parity
        const int c0 = chunk_at(r, kc + 2 * t), c1 = chunk_at(r, kc + 2 * t + 1);
        const double2 x0 = *reinterpret_cast<const double2*>(p0 + c0);
        const double2 x1 = *reinterpret_cast<const double2*>(p0 + c1);
        const double2 y0 = *reinterpret_cast<const double2*>(p1 + c0);
        const double2 y1 = *reinterpret_cast<const double2*>(p1 + c1);
        const double a[8] = {x0.x, y0.x, x0.y, y0.y, x1.x, y1.x, x1.y, y1.y};
#pragma unroll
        for (int c = 0; c < 2; ++c) dmma(acc[i][c], a, bf[c]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);  // the warp's reads of stage k are done
    if (++s == stages) {
      s = 0;
      parity ^= 1;
    }

    if (m0 + KT >= dend) {
      // the row block is done: this warp's part of V times z, summed over
      // this lane's rows (the sum over depths is linear, so the two depth
      // halves may reduce apart)
      const int nti = min(4, (NP - RB * h) / 16);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < nti) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = RB * h + 16 * i + g + 8 * (e >> 1), q = e & 1;
            if constexpr (NZ == 1) {
#pragma unroll
              for (int c = 0; c < 2; ++c)
                sum[c][q] += ws[(colbase(c) + 2 * t + q) * ldw + n] * acc[i][c][e];
            } else {
              const double zr = ws[(colbase(0) + 2 * t + q) * ldw + n];
              const double zi = ws[(colbase(1) + 2 * t + q) * ldw + n];
              sum[0][q] += zr * acc[i][0][e] - zi * acc[i][1][e];
              sum[1][q] += zr * acc[i][1][e] + zi * acc[i][0][e];
            }
          }
        }
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.0;
      }
      if (h == nrb - 1) {
        // the b is done: sums over the lanes of a column, then the second
        // depth half's sums added to the first's through `red`, and the store
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
#pragma unroll
            for (int off = 4; off < 32; off *= 2)
              sum[c][q] += __shfl_xor_sync(0xffffffffu, sum[c][q], off);
          }
        double* rd = red + cg * 16 + 4 * t;
        if (kh == 1 && g == 0) {
#pragma unroll
          for (int c = 0; c < 2; ++c) rd[2 * c] = sum[c][0], rd[2 * c + 1] = sum[c][1];
        }
        named_barrier(BAR_PAIR + cg, 64);
        if (kh == 0 && g == 0) {
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int jt = colbase(NZ == 1 ? c : 0) + 2 * t + q;
              const long long j = ctile * TJ + jt;
              if (j < ncol) {
                const size_t o = ((size_t)(j / S) * BL + cw.b) * S + (size_t)(j % S);
                const double v = sum[c][q] + rd[2 * c + q];
                if constexpr (NZ == 1) out0[o] = v;
                else (c == 0 ? out0 : out1)[o] = v;
              }
            }
        }
        named_barrier(BAR_PAIR + cg, 64);  // `red` is free again
#pragma unroll
        for (int c = 0; c < 2; ++c) sum[c][0] = sum[c][1] = 0.0;
      }
    }
    cw.next(NP, nrb, BL);
  }
}

template <int NZ>
int launch(const void* z0, const void* z1, const void* l, void* out0, void* out1,
           int W, int N, int NP, int S, int BL, void* stream) {
  if (W <= 0 || N <= 0 || S <= 0 || BL <= 0 || NP < N || NP % PAD != 0 ||
      reinterpret_cast<size_t>(l) % 16 != 0)
    return int(cudaErrorInvalidValue);
  // as many ring buffers as fit beside the resident tile, up to MAX_STAGES
  int stages = MAX_STAGES;
  while (stages > 2 && smem_bytes(NP, stages) > SMEM_LIMIT) --stages;
  const size_t smem = smem_bytes(NP, stages);
  if (smem > SMEM_LIMIT) return int(cudaErrorInvalidValue);  // N too large for a resident tile
  auto kernel = qf_dmma_kernel<NZ>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return int(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return int(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return int(err);
  if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
  // as many blocks as run at once, or one per (column tile, b) pair
  const long long pairs = ((long long)W * S + TP / NZ - 1) / (TP / NZ) * BL;
  const long long blocks = std::min((long long)sms * per_sm, pairs);
  kernel<<<unsigned(blocks), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(z0), static_cast<const double*>(z1),
      static_cast<const double*>(l), static_cast<double*>(out0), static_cast<double*>(out1),
      W, N, NP, S, BL, stages);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each function enqueues one kernel on `stream`, does not synchronise and
// returns cudaGetLastError() as an int (0 = launched).  `m` holds the
// (BL, NP, NP) lower-triangular fold, NP a multiple of eft_quadform_pad(); see
// ops/quadform.py kernel_matrices.

int eft_quadform_pad() { return PAD; }

int eft_qf_real_f64(const void* w, const void* m, void* out,
                    int W, int N, int NP, int S, int BL, void* stream) {
  return launch<1>(w, nullptr, m, out, nullptr, W, N, NP, S, BL, stream);
}

int eft_cf_half_f64(const void* m, const void* zr, const void* zi, void* out1, void* out2,
                    int W, int N, int NP, int S, int BL, void* stream) {
  return launch<2>(zr, zi, m, out1, out2, W, N, NP, S, BL, stream);
}

const char* eft_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
