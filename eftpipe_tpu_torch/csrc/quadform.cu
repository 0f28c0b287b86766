// Fused quadratic forms  out[w,b,s] = sum_n w[w,n,s] * sum_m M[b,n,m] w[w,m,s]
// for NVIDIA Hopper (sm_90a), plain C interface, loaded with ctypes: the
// FLOAT64 instances, on the FMA pipe.
//
// Replaces, in float64, the two Pallas TPU kernels of
// eftpipe_tpu/ops/pallas_kernels.py:
//   qf_real  <- _qf_real_kernel  (real, Hermitian-folded form)
//   cf_half  <- _cf_half_kernel  (one real part of a complex M against both
//                                 parts of z; the A/B reference of the fold)
// Both compute V = M w and reduce w .* V over n without V ever reaching
// device memory.  The float32 main path runs on the tensor cores
// (quadform_tc.cu, 3xTF32); these float64 instances serve the on-card
// float64 checks and are not on the float32 main path.  The FMA template
// below is the design of the first slice of the port, kept as it was apart
// from its float32 settings, which went with its float32 instances.
//
// What bounds it on this card: operations, and in practice the shared-memory
// reads that feed them.  With N = 255, S = 80, BL = 114 the work is hundreds of
// flops per byte moved once, far above the float64-FMA ridge of the card, so
// the design is a register-tiled float64 FMA product with the reduction fused
// into its epilogue, and it does as little of the product as the form allows:
//
//  * Only the symmetric part of M enters w^T M w.  The wrapper hands over
//    L = the lower triangle of M + M^T with the diagonal of M (w^T L w =
//    w^T M w), zero-padded to (NP, NP), NP a multiple of TK; the kernel reads
//    and multiplies the tiles on and left of the diagonal only: (N/RB + 1)/2
//    of N/RB row blocks' worth, 56 % at N = 255.  Rows of L are 16-byte
//    aligned, so its tiles are fetched as 16-byte vectors with no column mask.
//  * One M_b (255*255*8 = 520 KB) does not fit a block's 227 KB of shared
//    memory, so a block keeps a COLUMN tile of w resident instead: all N rows
//    of TJ = 64 columns of the flattened (walker, s) axis.  It arrives by
//    asynchronous copies (cp.async), all of its elements in flight at once,
//    and serves a run of matrices L_b0 .. L_b0+bchunk-1; BL is split over
//    blocks only as far as it takes to fill the card.
//  * The sum over n and m is linear, so the tiles of L_b may be dealt to the
//    warps in any way: in row-block order they are cut into 8 equal runs, one
//    a warp.  A warp streams its tiles (RB rows x TK deep) through two small
//    staging buffers of its own, synchronising with itself only; every element
//    of V it produces is consumed at once by sum_n w[n,j] V[n,j] in registers.
//    The block meets once per b, to add up the warps' column sums: no V in
//    device memory, no cross-block reduction, no atomics, sums in a fixed order.
//  * A block indexes its own b (no padding of BL), and reads w in its
//    (W, N, S) layout as it is (no walker regrouping or transposes).  Ragged
//    edges of w (rows past N, W*S not a multiple of TJ) are zero-filled and
//    never stored.
//  * Blocks that run at the same time share a few w tiles and the lower
//    triangles of L (about 30 MB at BL = 114), which stay in the 50 MB L2.
//
// Each thread owns an RW x 8 micro-tile of V, RW = 4 rows: 64-bit values
// (and, in cf_half, two accumulator sets) leave registers for no more.
// The staged tile is stored transposed (ms[k][row]) so a thread reads its rows
// as 16-byte vectors; a thread's columns are four 16-byte chunks TX vectors
// apart, so that a quarter-warp reads 128 contiguous bytes
// without bank conflicts; the next tile is fetched into registers while the
// current one is multiplied.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TK = 8;   // depth of one staged tile of M; M is padded to a multiple of it
constexpr int CW = 8;   // columns per thread
constexpr int BLOCKS_PER_SM = 16;  // blocks the grid aims at for every SM

template <typename T, int TJ, int NZ, int RW>
struct Tile {
  static constexpr int VEC = 16 / int(sizeof(T));    // elements of a 16-byte vector
  static constexpr int TX = TJ / CW;                  // threads across columns
  static constexpr int WTY = 32 / TX;                 // threads across rows, one warp
  static constexpr int RB = WTY * RW;                 // rows of M a warp multiplies at a time
  static constexpr int MS_LD = RB + VEC;              // padded, keeps 16-byte alignment
  static constexpr int KV = TK / VEC;                 // 16-byte vectors per staged row
  static constexpr int PFV = RB * KV / 32;            // vectors of M a lane prefetches
  static constexpr int MS_ELEMS = WARPS * 2 * TK * MS_LD;  // two staging buffers a warp
  static constexpr int RED_ELEMS = 2 * NZ * WARPS * TJ;  // cross-warp reduction, two b in turn
  static_assert(TJ % CW == 0 && 32 % TX == 0 && THREADS % TJ == 0, "tile shape");
  static_assert((RB * KV) % 32 == 0 && RW % VEC == 0 && CW % VEC == 0, "tile shape");
};

template <typename T, int TJ, int NZ, int RW>
size_t smem_bytes(int np) {
  using L = Tile<T, TJ, NZ, RW>;
  return sizeof(T) * (size_t(NZ) * np * TJ + size_t(L::MS_ELEMS) + size_t(L::RED_ELEMS));
}

// 16-byte loads of COUNT contiguous, 16-byte aligned elements
template <int COUNT>
__device__ inline void load_vec(const double* p, double* d) {
#pragma unroll
  for (int i = 0; i < COUNT / 2; ++i) {
    const double2 v = reinterpret_cast<const double2*>(p)[i];
    d[2 * i] = v.x; d[2 * i + 1] = v.y;
  }
}

// asynchronous copy of one element from device to shared memory, or a zero
template <typename T>
__device__ inline void copy_async(T* dst, const T* src, bool valid) {
  static_assert(sizeof(T) == 8, "element size");
  const unsigned d = unsigned(__cvta_generic_to_shared(dst));
  const int bytes = valid ? int(sizeof(T)) : 0;  // fewer than the size: zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d), "l"(src), "r"(bytes) : "memory");
}

// the thread's CW columns of row `row` of a resident tile: CW / VEC chunks of
// VEC contiguous columns, chunk q at column q * TX * VEC + tx * VEC
template <typename T, int TJ, int VEC, int TX>
__device__ inline void load_cols(const T* tile, int row, int tx, T (&d)[CW]) {
#pragma unroll
  for (int q = 0; q < CW / VEC; ++q)
    load_vec<VEC>(tile + size_t(row) * TJ + q * TX * VEC + tx * VEC, d + q * VEC);
}

// NZ = 1: out0 = sum_n z0 .* (L z0)                         (qf_real)
// NZ = 2: out0 = sum_n z0 .* (L z0) - z1 .* (L z1)
//         out1 = sum_n z0 .* (L z1) + z1 .* (L z0)           (cf_half)
// z*: (W, N, S), out*: (W, BL, S), contiguous; m: (BL, NP, NP), the LOWER
// TRIANGULAR (N, N) matrices L zero-padded to NP = a multiple of TK, 16-byte
// aligned.  Nothing right of the diagonal blocks (RB x RB) is read; inside
// them m must be zero right of the diagonal, as tril_fold of the wrapper makes it.
template <typename T, int TJ, int NZ, int RW>
__global__ void __launch_bounds__(THREADS, 1)
quadform_kernel(const T* __restrict__ z0, const T* __restrict__ z1,
                const T* __restrict__ m, T* __restrict__ out0, T* __restrict__ out1,
                int W, int N, int NP, int S, int BL, int bchunk) {
  using L = Tile<T, TJ, NZ, RW>;
  constexpr int VEC = L::VEC, TX = L::TX, RB = L::RB, MS_LD = L::MS_LD, KV = L::KV,
                PFV = L::PFV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ws0 = reinterpret_cast<T*>(smem_raw);           // [NP][TJ]
  T* ws1 = ws0 + size_t(NZ - 1) * NP * TJ;           // [NP][TJ] (NZ = 2)
  T* ms = ws0 + size_t(NZ) * NP * TJ;                // [WARPS] x 2 x [TK][MS_LD]
  T* red = ms + L::MS_ELEMS;                         // 2 x [NZ][WARPS][TJ]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int tx = lane % TX;
  const int wty = lane / TX;
  T* wms = ms + warp * 2 * TK * MS_LD;
  // the block's matrices b0 .. b0 + nb - 1 and its TJ columns
  const int bsplit = (BL + bchunk - 1) / bchunk;
  const int b0 = int(blockIdx.x % bsplit) * bchunk;
  const int nb = min(bchunk, BL - b0);
  const long long j0 = (long long)(blockIdx.x / bsplit) * TJ;
  const long long ncol = (long long)W * S;

  // The work on one L_b: row block r (rows r * RB ..) against the depths
  // 0 .. depth(r) - 1 left of and on its diagonal, in tiles of TK.  The
  // tiles of all row blocks, in order, are dealt to the warps in equal runs,
  // the same run for every b; a warp walks its run tile by tile.
  auto depth = [&](int r) { return min(NP, RB * (r + 1)); };
  const int nrb = (N + RB - 1) / RB;
  int ntiles = 0;
  for (int r = 0; r < nrb; ++r) ntiles += depth(r) / TK;
  const int run0 = warp * ntiles / WARPS;
  const int run = (warp + 1) * ntiles / WARPS - run0;
  int r_first = 0, m_first = run0;
  while (r_first < nrb && m_first >= depth(r_first) / TK) m_first -= depth(r_first++) / TK;
  m_first *= TK;
  const int total = nb * run;

  // The tile being fetched: each lane fetches PFV 16-byte vectors (rows past
  // NP as zeros), then stores them transposed.
  T pf[PFV][VEC];
  const T* mb = m + (size_t)b0 * NP * NP;
  int pr = r_first, pm0 = m_first, pleft = run;
  auto prefetch = [&]() {
#pragma unroll
    for (int i = 0; i < PFV; ++i) {
      const int v = lane + i * 32;
      const int n = pr * RB + v / KV;
      if (n < NP) {
        load_vec<VEC>(mb + (size_t)n * NP + pm0 + (v % KV) * VEC, pf[i]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) pf[i][e] = T(0);
      }
    }
    pm0 += TK;
    if (--pleft == 0) {
      pleft = run;
      pr = r_first;
      pm0 = m_first;
      mb += (size_t)NP * NP;
    } else if (pm0 == depth(pr)) {
      pm0 = 0;
      ++pr;
    }
  };
  auto stage = [&](T* buf) {
#pragma unroll
    for (int i = 0; i < PFV; ++i) {
      const int v = lane + i * 32;
#pragma unroll
      for (int e = 0; e < VEC; ++e) buf[((v % KV) * VEC + e) * MS_LD + v / KV] = pf[i][e];
    }
  };
  if (total > 0) prefetch();

  // The resident tile: all N rows of this thread's column (the same column
  // in every pass, as THREADS is a multiple of TJ), copied asynchronously so
  // that every element is in flight at once; rows past N and ragged columns
  // are zero-filled.
  {
    const long long j = j0 + tid % TJ;
    const bool col_ok = j < ncol;
    const long long base = col_ok ? (j / S) * (long long)N * S + (j % S) : 0;
    for (int n = tid / TJ; n < NP; n += THREADS / TJ) {
      const bool ok = col_ok && n < N;
      const long long off = ok ? base + (long long)n * S : 0;
      copy_async(ws0 + n * TJ + tid % TJ, z0 + off, ok);
      if constexpr (NZ == 2) copy_async(ws1 + n * TJ + tid % TJ, z1 + off, ok);
    }
  }
  if (total > 0) stage(wms);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  T sum0[CW], sum1[CW];
  T acc0[RW][CW], acc1[NZ == 2 ? RW : 1][CW];
#pragma unroll
  for (int c = 0; c < CW; ++c) {
    sum0[c] = T(0);
    sum1[c] = T(0);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      acc0[i][c] = T(0);
      if constexpr (NZ == 2) acc1[i][c] = T(0);
    }
  }

  int t = 0;
  for (int bi = 0; bi < nb; ++bi) {
    int r = r_first, m0 = m_first;
    for (int it = 0; it < run; ++it, ++t) {
      const T* cur = wms + (t & 1) * TK * MS_LD;
      const bool more = t + 1 < total;
      if (more) prefetch();  // in flight during the FMAs below
#pragma unroll
      for (int k = 0; k < TK; ++k) {
        T a[RW], v0[CW];
        load_vec<RW>(cur + k * MS_LD + wty * RW, a);
        load_cols<T, TJ, VEC, TX>(ws0, m0 + k, tx, v0);
#pragma unroll
        for (int i = 0; i < RW; ++i)
#pragma unroll
          for (int c = 0; c < CW; ++c) acc0[i][c] += a[i] * v0[c];
        if constexpr (NZ == 2) {
          T v1[CW];
          load_cols<T, TJ, VEC, TX>(ws1, m0 + k, tx, v1);
#pragma unroll
          for (int i = 0; i < RW; ++i)
#pragma unroll
            for (int c = 0; c < CW; ++c) acc1[i][c] += a[i] * v1[c];
        }
      }
      m0 += TK;
      const bool row_end = m0 == depth(r);
      if (row_end || it + 1 == run) {
        // fused epilogue: what this warp has of V in row block r, times z,
        // summed over the thread's rows (the sum over n and m is linear, so
        // a row block may be split between warps)
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const int n = r * RB + wty * RW + i;
          if (n < N) {
            T r0[CW];
            load_cols<T, TJ, VEC, TX>(ws0, n, tx, r0);
            if constexpr (NZ == 1) {
#pragma unroll
              for (int c = 0; c < CW; ++c) sum0[c] += r0[c] * acc0[i][c];
            } else {
              T r1[CW];
              load_cols<T, TJ, VEC, TX>(ws1, n, tx, r1);
#pragma unroll
              for (int c = 0; c < CW; ++c) {
                sum0[c] += r0[c] * acc0[i][c] - r1[c] * acc1[i][c];
                sum1[c] += r0[c] * acc1[i][c] + r1[c] * acc0[i][c];
              }
            }
          }
#pragma unroll
          for (int c = 0; c < CW; ++c) {
            acc0[i][c] = T(0);
            if constexpr (NZ == 2) acc1[i][c] = T(0);
          }
        }
      }
      if (row_end) {
        m0 = 0;
        ++r;
      }
      // the other buffer was last read before the previous __syncwarp
      if (more) stage(wms + ((t + 1) & 1) * TK * MS_LD);
      __syncwarp();
    }

    // L_b is done: add up each column's partial sums, over the warp's rows of
    // threads by shuffles, over the warps through `red`, and store.  The two
    // halves of `red` serve even and odd b, so one barrier a b is enough.
    T* rb = red + (bi & 1) * (L::RED_ELEMS / 2);
#pragma unroll
    for (int c = 0; c < CW; ++c) {
#pragma unroll
      for (int off = TX; off < 32; off *= 2) {
        sum0[c] += __shfl_xor_sync(0xffffffffu, sum0[c], off);
        if constexpr (NZ == 2) sum1[c] += __shfl_xor_sync(0xffffffffu, sum1[c], off);
      }
      const int col = (c / VEC) * TX * VEC + tx * VEC + c % VEC;
      if (wty == 0) {
        rb[warp * TJ + col] = sum0[c];
        if constexpr (NZ == 2) rb[(WARPS + warp) * TJ + col] = sum1[c];
      }
      sum0[c] = T(0);
      sum1[c] = T(0);
    }
    __syncthreads();
    if (tid < TJ) {
      const long long j = j0 + tid;
      if (j < ncol) {
        T t0 = T(0), t1 = T(0);
        for (int y = 0; y < WARPS; ++y) {
          t0 += rb[y * TJ + tid];
          if constexpr (NZ == 2) t1 += rb[(WARPS + y) * TJ + tid];
        }
        const size_t o = ((size_t)(j / S) * BL + (b0 + bi)) * S + (size_t)(j % S);
        out0[o] = t0;
        if constexpr (NZ == 2) out1[o] = t1;
      }
    }
  }
}

template <typename T, int TJ, int NZ, int RW>
cudaError_t launch_tile(const T* z0, const T* z1, const T* m, T* out0, T* out1,
                        int W, int N, int NP, int S, int BL, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, TJ, NZ, RW>(NP);
  auto kernel = quadform_kernel<T, TJ, NZ, RW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const long long tiles = ((long long)W * S + TJ - 1) / TJ;
  // Each block keeps its column tile for `bchunk` matrices in turn, so that
  // loading the tile is paid once for many products; BL is split only as far
  // as it takes to give every SM several blocks.
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const long long want = (BLOCKS_PER_SM * sms + tiles - 1) / tiles;
  const int bsplit = int(want < BL ? want : BL);
  const int bchunk = (BL + bsplit - 1) / bsplit;
  const long long blocks = tiles * ((BL + bchunk - 1) / bchunk);
  if (blocks <= 0 || blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  kernel<<<unsigned(blocks), THREADS, smem, stream>>>(z0, z1, m, out0, out1, W, N, NP, S, BL, bchunk);
  return cudaGetLastError();
}

constexpr size_t SMEM_LIMIT = 232448;  // bytes of shared memory a block may use

template <typename T, int NZ>
int launch(const void* z0, const void* z1, const void* m, void* out0, void* out1,
           int W, int N, int NP, int S, int BL, void* stream) {
  constexpr int RW = 4;  // rows of M a thread
  if (W <= 0 || N <= 0 || S <= 0 || BL <= 0 || NP < N || NP % TK != 0 ||
      reinterpret_cast<size_t>(m) % 16 != 0)
    return int(cudaErrorInvalidValue);
  const T* a = static_cast<const T*>(z0);
  const T* c = static_cast<const T*>(z1);
  const T* mm = static_cast<const T*>(m);
  T* o0 = static_cast<T*>(out0);
  T* o1 = static_cast<T*>(out1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem_bytes<T, 64, NZ, RW>(NP) <= SMEM_LIMIT)
    return int(launch_tile<T, 64, NZ, RW>(a, c, mm, o0, o1, W, N, NP, S, BL, st));
  if (smem_bytes<T, 32, NZ, RW>(NP) <= SMEM_LIMIT)
    return int(launch_tile<T, 32, NZ, RW>(a, c, mm, o0, o1, W, N, NP, S, BL, st));
  return int(cudaErrorInvalidValue);  // N too large for a resident column tile
}

}  // namespace

extern "C" {

// Each function enqueues one kernel on `stream`, does not synchronise and
// returns cudaGetLastError() as an int (0 = launched).  `m` holds the (N, N)
// matrices zero-padded to (NP, NP), NP a multiple of eft_quadform_pad().

int eft_quadform_pad() { return TK; }

int eft_qf_real_f64(const void* w, const void* m, void* out,
                    int W, int N, int NP, int S, int BL, void* stream) {
  return launch<double, 1>(w, nullptr, m, out, nullptr, W, N, NP, S, BL, stream);
}

int eft_cf_half_f64(const void* m, const void* zr, const void* zi, void* out1, void* out2,
                    int W, int N, int NP, int S, int BL, void* stream) {
  return launch<double, 2>(zr, zi, m, out1, out2, W, N, NP, S, BL, stream);
}

const char* eft_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
