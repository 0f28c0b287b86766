// The recombination recurrence (recomb_scan, recomb_scan_jvp,
// recomb_scan_jvp2 of csrc/boltzmann.cu) <- the Peebles/T_M step of
// _thermo_on_grid (eftpipe_tpu/boltzmann/thermo.py:317-367; the port's plain
// version thermo.recomb_scan_plain): Peebles hydrogen by Crank-Nicolson
// (implicit half a scalar quadratic, the Lyman-alpha C factor iterated once)
// and the matter temperature by exact exponential steps, each step carrying
// (x_H, T_M, x_e, Saha or not) to the next.
//
// A launch is two kernels on one stream, with a workspace the caller
// allocates (eft_recomb_work_bytes):
//  * recomb_prep_kernel, one thread a (row, step): the terms of a step that
//    depend on the inputs only, each the same expression as in the plain
//    version (T_g and H at the step's midpoint, 8 sigma_T a_R T_g^4 / (3 m_e
//    c) there, the Lyman-alpha Boltzmann factor, K_Ly, n_H, H, f_He's term,
//    x_Saha) into one record a step (Rec); where x_Saha > 0.999 the step's
//    x_H = clip(x_Saha) and x_e = x_H + f_He's term (its outputs), and, for
//    a Saha step after a Saha step, T_M's exponential step (t_eq and the
//    decay: the step is then T_M' = t_eq + (T_M - t_eq) decay).
//  * recomb_scan_kernel, one thread a row, walks the chain.  The Saha block
//    (the steps from the first while x_Saha > 0.999: z > ~1,680, 65 % of the
//    fine grid) is that one dependent update a step, eight steps' records
//    read at once: the rates and the two implicit solves the plain version
//    computes there are only ever selected away, so the outputs are what the
//    whole step gives, to the bit.  After it
//    each Peebles step runs straight through: T_M at t* (its coefficients
//    taken in the step before, beside that step's own T_M step), the
//    rates at t* once for both solves (alpha_B's two powers from one log,
//    (.)^1.5 as y sqrt(y)), the rate at the previous point (f_old, from the
//    previous record), the quotients by dv() and exp and log by the
//    branch-free cores below, while the next step's record is read.
// Branches are decided on values (val()), which are the inputs' for the
// Saha test: rows of one cosmology (its tangent or pair rows) never diverge,
// rows of two only over the steps where their Saha blocks' ends differ.
//
// The record: 9 scalars a (row, step) and 2 more for the Saha steps, 88
// bytes a step for double, 176 for Dual and 352 for HD: 11.5 MB at W=4 and
// 184.5 MB at W=64 on the 32,768-step grid; 173 MB for HD at W Q = 15.
#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "scalar.cuh"

namespace {

constexpr double PI = 3.141592653589793;
constexpr double C_SI = 2.99792458e8;
constexpr double KB = 1.380649e-23;
constexpr double HP = 6.62607015e-34;
constexpr double ME = 9.1093837015e-31;
constexpr double SIGMA_T = 6.6524587321e-29;
constexpr double EV = 1.602176634e-19;
constexpr double A_RAD = 7.565723e-16;
constexpr double B1_EV = 13.598434;
constexpr double B2_EV = B1_EV / 4.0;
constexpr double E21_EV = B1_EV * 0.75;
constexpr double LAM_2S1S = 8.2245809;
constexpr double LAM_ALPHA = HP * C_SI / (E21_EV * EV);
constexpr double RECFAST_F = 1.14;

// ---------------------------------------------------------------------------
// exp and log for the chain, without branches
// ---------------------------------------------------------------------------
__device__ __forceinline__ double bits_to_double(uint64_t b) {
#ifdef __CUDA_ARCH__
  return __longlong_as_double(static_cast<long long>(b));
#else
  double d;
  memcpy(&d, &b, sizeof d);
  return d;
#endif
}
__device__ __forceinline__ uint64_t double_to_bits(double d) {
#ifdef __CUDA_ARCH__
  return static_cast<uint64_t>(__double_as_longlong(d));
#else
  uint64_t b;
  memcpy(&b, &d, sizeof b);
  return b;
#endif
}

// e^x for |x| < 708 (a normal result), and NaN for NaN: x = j ln 2 + r,
// |r| <= ln 2 / 2 (ln 2 in two parts, by FMA), e^r by its Taylor polynomial
// of degree 13 (truncation < 5e-18), times 2^j made from its bits.  Within
// 0.9 ulp of e^x (4e6 seeded points against a long-double exp).  The
// library's exp adds the tests and paths of |x| >= 708 and a call: the
// chain's arguments are clipped to [-300, 0], or p log(T / 10^4) with |p|
// < 0.62 and T positive and normal (|p log| < 440).
__device__ __forceinline__ double ex_core(double x) {
  const double j = rint(x * 1.4426950408889634);
  double r = fma(j, -6.9314718055994529e-01, x);
  r = fma(j, -2.3190468138462996e-17, r);
  double p = 1.6059043836821613e-10;
  p = fma(p, r, 2.08767569878681e-09);
  p = fma(p, r, 2.505210838544172e-08);
  p = fma(p, r, 2.755731922398589e-07);
  p = fma(p, r, 2.7557319223985893e-06);
  p = fma(p, r, 2.48015873015873e-05);
  p = fma(p, r, 1.984126984126984e-04);
  p = fma(p, r, 1.388888888888889e-03);
  p = fma(p, r, 8.333333333333333e-03);
  p = fma(p, r, 4.1666666666666664e-02);
  p = fma(p, r, 1.6666666666666666e-01);
  p = fma(p, r, 0.5);
  p = fma(p, r, 1.0);
  p = fma(p, r, 1.0);
  const int k = static_cast<int>(j == j ? j : 0.0);
  return p * bits_to_double(static_cast<uint64_t>(k + 1023) << 52);
}

// ln x for x positive and normal, and NaN for NaN: x = 2^k m, m in
// [sqrt(1/2), sqrt(2)), ln m = 2 atanh(s), s = (m - 1) / (m + 1), by fdlibm's
// polynomial in s^2 and its recombination.  Within 0.8 ulp of ln x (4e6
// seeded points against a long-double log).  The chain takes the log of T_M /
// 10^4 only, T_M positive and normal (an exponential step's convex
// combination of T_M and t_eq >= 0, from T_g > 0).
__device__ __forceinline__ double lg_core(double x) {
  const uint64_t b = double_to_bits(x);
  const int e = static_cast<int>(b >> 52) - 1023;
  double m = bits_to_double((b & 0x000fffffffffffffULL) | 0x3ff0000000000000ULL);
  const bool hi = m > 1.4142135623730951;
  m = hi ? 0.5 * m : m;
  const double k = static_cast<double>(hi ? e + 1 : e);
  const double f = m - 1.0;
  const double s = dv(f, 2.0 + f);
  const double z = s * s, w = z * z;
  const double t1 = w * (3.999999999940941908e-01 +
                         w * (2.222219843214978396e-01 + w * 1.531383769920937332e-01));
  const double t2 = z * (6.666666666666735130e-01 +
                         w * (2.857142874366239149e-01 +
                              w * (1.818357216161805012e-01 + w * 1.479819860511658591e-01)));
  const double hfsq = 0.5 * f * f;
  const double r = k * 6.93147180369123816490e-01 -
                   ((hfsq - (s * (hfsq + (t2 + t1)) + k * 1.90821492927058770002e-10)) - f);
  return x == x ? r : x;
}

// the cores on each scalar type (the rules of exp and log on a dual and a
// hyper-dual number, as exp() above and its HD form)
__device__ __forceinline__ double ex(double x) { return ex_core(x); }
__device__ __forceinline__ Dual ex(const Dual& x) {
  const double e = ex_core(x.v);
  return Dual(e, e * x.d);
}
__device__ __forceinline__ HD ex(const HD& x) {
  const double e = ex_core(x.v);
  return HD(e, e * x.a, e * x.b, e * (x.ab + x.a * x.b));
}
__device__ __forceinline__ double lg(double x) { return lg_core(x); }
__device__ __forceinline__ Dual lg(const Dual& x) { return Dual(lg_core(x.v), dv(x.d, x.v)); }
// l_p = x_p / x, l_pq = x_pq / x - l_p l_q
__device__ __forceinline__ HD lg(const HD& x) {
  const double qa = dv(x.a, x.v), qb = dv(x.b, x.v);
  return HD(lg_core(x.v), qa, qb, dv(x.ab, x.v) - qa * qb);
}

// a / b in the pre-pass (the plain quotient, as the plain version) and on
// the chain (dv: the same bits for normal operands and quotient, no branch)
template <bool CHAIN, class A, class B>
__device__ __forceinline__ auto quot(const A& a, const B& b) {
  if constexpr (CHAIN) {
    return dv(a, b);
  } else {
    return a / b;
  }
}

// ---------------------------------------------------------------------------
// the step's physics
// ---------------------------------------------------------------------------
// what the rates take from T_M: the case-B recombination coefficient and the
// photo-ionisation rate from n=2 without its Boltzmann factor (beta2)
template <class S> struct TRates { S alpha, beta2; };

template <class S> __device__ __forceinline__ TRates<S> t_rates(S tm) {
  TRates<S> r;
  const S lt = lg(dv(tm, 1.0e4));
  r.alpha = dv(RECFAST_F * 4.309e-19 * ex(-0.6166 * lt), 1.0 + 0.6703 * ex(0.5300 * lt));
  const S y = dv(2.0 * PI * ME * KB * tm, HP * HP);
  r.beta2 = r.alpha * (y * root(y)) * ex(clip(dv(-B2_EV * EV, KB * tm), -300.0, 0.0));
  return r;
}

// _peebles_rate's g = C / H at x
template <class S>
__device__ __forceinline__ S g_rate(S x, const TRates<S>& r, S k_ly, S nh_i, S h_i) {
  const S n1s = mx(1.0 - x, 1e-12) * nh_i;
  const S c_peeb = dv(1.0 + k_ly * LAM_2S1S * n1s, 1.0 + k_ly * (LAM_2S1S + r.beta2) * n1s);
  return dv(c_peeb, h_i);
}

// the implicit half of the Crank-Nicolson step: the root of
// a2 x^2 + a1 x + a0 = 0, both quotients computed and one selected
template <class S>
__device__ __forceinline__ S solve_implicit(S g, const TRates<S>& r, S boltz, double theta,
                                            double dlna, S nh_i, S x_prev, S f_old) {
  const double hd = theta * dlna;
  const S a2 = hd * g * r.alpha * nh_i;
  const S a1 = 1.0 + hd * g * r.beta2 * boltz;
  const S a0 = -(x_prev + hd * f_old + hd * g * r.beta2 * boltz);
  const S disc = root(mx(a1 * a1 - 4.0 * a2 * a0, 0.0));
  const S big = dv(-a1 + disc, 2.0 * a2), small = dv(-a0, a1);
  return val(a2) > 1e-30 ? big : small;
}

// T_M's exact exponential step at x_e = xe_mid: T_M' = t_eq + (T_M - t_eq) decay
template <class S> struct TStep { S t_eq, decay; };

template <bool CHAIN, class S>
__device__ __forceinline__ TStep<S> t_step(S xe_mid, S g4, S tg_m, S h_m, S opf, double dlna) {
  const S gamma_c = quot<CHAIN>(g4 * xe_mid, 3.0 * ME * C_SI * (opf + xe_mid));
  const S gh = quot<CHAIN>(gamma_c, h_m);
  const S lam = 2.0 + gh;
  const S arg = -clip(lam * dlna, 0.0, 300.0);
  TStep<S> s;
  s.t_eq = quot<CHAIN>(gh * tg_m, lam);
  if constexpr (CHAIN) {
    s.decay = ex(arg);
  } else {
    s.decay = exp(arg);
  }
  return s;
}

template <class S> __device__ __forceinline__ S apply(const TStep<S>& s, S t_prev) {
  return s.t_eq + (t_prev - s.t_eq) * s.decay;
}

// ---------------------------------------------------------------------------
// the two kernels
// ---------------------------------------------------------------------------
// the recurrence's inputs: five (W, n) rows and f_He (W,); for S = Dual the
// same again for their tangents (for S = HD their three parts, (W, n, 3) and
// (W, 3))
struct RecombIn { const double *tg, *nh, *hs, *xs, *he, *f_he; };

// A step's record: what the chain reads at the step's top (one step ahead)
// and with the step (its rates' terms, and the previous point's for f_old).
template <class S> struct RecHead { S xs, g4, tg_m, h_m; };
template <class S> struct RecBody { S boltz, k_ly, nh, h, he; };
template <class S> struct Rec {
  RecHead<S> head;
  RecBody<S> body;
};
// the workspace of a launch (the caller's scratch): the records, then the
// Saha steps' exponential steps
template <class S> struct RecombWork {
  Rec<S>* rec;
  TStep<S>* saha;
};
template <class S> inline size_t recomb_work_bytes(int nw, int n) {
  return static_cast<size_t>(nw) * n * (sizeof(Rec<S>) + sizeof(TStep<S>));
}
template <class S> inline RecombWork<S> recomb_work(void* base, int nw, int n) {
  Rec<S>* rec = static_cast<Rec<S>*>(base);
  return RecombWork<S>{rec, reinterpret_cast<TStep<S>*>(rec + static_cast<size_t>(nw) * n)};
}

template <class S>
__global__ void recomb_prep_kernel(RecombIn in, RecombIn din, RecombWork<S> work,
                                   double* __restrict__ out, double* __restrict__ dout, int nw,
                                   int n, double dlna) {
  const long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= static_cast<long long>(nw) * n) return;
  const int w = static_cast<int>(k / n), i = static_cast<int>(k % n);
  const size_t row = static_cast<size_t>(w) * n;
  auto at = [&](const double* v, const double* d, int j) { return load<S>(v, d, row + j); };
  const int o = i > 0 ? i - 1 : 0;
  const S tg_o = at(in.tg, din.tg, o), tg_i = at(in.tg, din.tg, i);
  const S h_o = at(in.hs, din.hs, o), h_i = at(in.hs, din.hs, i);
  const S tg_m = 0.5 * (tg_o + tg_i), h_m = 0.5 * (h_o + h_i);
  const S xs_i = at(in.xs, din.xs, i), he_i = at(in.he, din.he, i);
  const S g4 = 8.0 * SIGMA_T * A_RAD * pow(tg_m, 4.0);
  Rec<S> r;
  r.head = RecHead<S>{xs_i, g4, tg_m, h_m};
  r.body = RecBody<S>{exp(clip(-E21_EV * EV / (KB * tg_i), -300.0, 0.0)),
                      LAM_ALPHA * LAM_ALPHA * LAM_ALPHA / (8.0 * PI * h_i),
                      at(in.nh, din.nh, i), h_i, he_i};
  work.rec[row + i] = r;
  if (val(xs_i) > 0.999) {
    const size_t xh_o = row + i, xe_o = static_cast<size_t>(nw) * n + row + i;
    const S x_h = clip(xs_i, 0.0, 1.0);
    const S xe = x_h + he_i;
    store(out, dout, xh_o, x_h);
    store(out, dout, xe_o, xe);
    // x_e of step i - 1 if that was a Saha step too (the first step's: the
    // initial 1 + 2 f_He)
    const S f_he = load<S>(in.f_he, din.f_he, w);
    const S xe_prev =
        i == 0 ? 1.0 + 2.0 * f_he : clip(at(in.xs, din.xs, o), 0.0, 1.0) + at(in.he, din.he, o);
    work.saha[row + i] = t_step<false>(0.5 * (xe_prev + xe), g4, tg_m, h_m, 1.0 + f_he, dlna);
  }
}

template <class S>
__global__ void recomb_scan_kernel(RecombIn in, RecombIn din, RecombWork<S> work,
                                   double* __restrict__ out, double* __restrict__ dout, int nw,
                                   int n, double dlna) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= nw || n <= 0) return;
  const size_t row = static_cast<size_t>(w) * n;
  const size_t xh_o = row, xe_o = static_cast<size_t>(nw) * n + row,
               tm_o = 2 * static_cast<size_t>(nw) * n + row;
  const Rec<S>* rec = work.rec + row;
  const TStep<S>* saha = work.saha + row;
  const double* xs = in.xs + row;
  const S f_he = load<S>(in.f_he, din.f_he, w);
  const S opf = 1.0 + f_he;
  S t_prev = load<S>(in.tg, din.tg, row);

  // the Saha block: T_M's steps alone, eight steps' records read at once
  constexpr int U = 8;
  int i = 0;
  for (; i + U <= n; i += U) {
    double x[U];
    TStep<S> c[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      x[j] = xs[i + j];
      c[j] = saha[i + j];
    }
    bool all = true;
#pragma unroll
    for (int j = 0; j < U; ++j) all = all && x[j] > 0.999;
    if (!all) break;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      t_prev = apply(c[j], t_prev);
      store(out, dout, tm_o + i + j, t_prev);
    }
  }
  for (; i < n && xs[i] > 0.999; ++i) {
    t_prev = apply(saha[i], t_prev);
    store(out, dout, tm_o + i, t_prev);
  }
  if (i >= n) return;

  // the steps after it: x_H and x_e of the block's last step (the pre-pass
  // wrote them) or the initial state
  S x_prev = 1.0, xe_prev = 1.0 + 2.0 * f_he;
  if (i > 0) {
    x_prev = clip(load<S>(in.xs, din.xs, row + i - 1), 0.0, 1.0);
    xe_prev = x_prev + load<S>(in.he, din.he, row + i - 1);
  }
  bool was_saha = true;
  RecBody<S> po = rec[i > 0 ? i - 1 : 0].body;  // the previous point's
  RecHead<S> cur = rec[i].head;
  // T_M's step to t* depends on x_e of the step before and the record only:
  // each step takes it for the next one beside its own T_M step
  TStep<S> ts = t_step<true>(xe_prev, cur.g4, cur.tg_m, cur.h_m, opf, dlna);
  for (; i < n; ++i) {
    const RecHead<S> nxt = rec[i + 1 < n ? i + 1 : i].head;
    const RecBody<S> cb = rec[i].body;
    const bool use_saha = val(cur.xs) > 0.999;
    S x_h;
    if (use_saha) {
      // a Saha step after a Peebles one (x_Saha rose again): T_M's step alone
      x_h = clip(cur.xs, 0.0, 1.0);
    } else {
      const S t_star = apply(ts, t_prev);
      // f_old, the rate at (x_prev, T_prev) on the previous point; on the
      // first Peebles step (theta = 1) its weight (1 - theta) / theta is 0,
      // and it is computed there too, so that a rate that is not finite
      // gives NaN there as in the plain version
      const TRates<S> ro = t_rates(t_prev);
      const S go = g_rate(x_prev, ro, po.k_ly, po.nh, po.h);
      S f_old = go * (ro.beta2 * po.boltz * (1.0 - x_prev) - ro.alpha * po.nh * (x_prev * x_prev));
      const double theta = was_saha ? 1.0 : 0.5;
      f_old = (1.0 - theta) / theta * f_old;
      // the rates at t*, once for both solves
      const TRates<S> rs = t_rates(t_star);
      const S x_star = solve_implicit(g_rate(x_prev, rs, cb.k_ly, cb.nh, cb.h), rs, cb.boltz,
                                      theta, dlna, cb.nh, x_prev, f_old);
      const S x_pb = solve_implicit(g_rate(clip(x_star, 0.0, 1.0), rs, cb.k_ly, cb.nh, cb.h), rs,
                                    cb.boltz, theta, dlna, cb.nh, x_prev, f_old);
      x_h = clip(x_pb, 0.0, 1.0);
    }
    const S xe = x_h + cb.he;
    const S t_new =
        apply(t_step<true>(0.5 * (xe_prev + xe), cur.g4, cur.tg_m, cur.h_m, opf, dlna), t_prev);
    if (!use_saha) {  // the pre-pass wrote a Saha step's
      store(out, dout, xh_o + i, x_h);
      store(out, dout, xe_o + i, xe);
    }
    store(out, dout, tm_o + i, t_new);
    ts = t_step<true>(xe, nxt.g4, nxt.tg_m, nxt.h_m, opf, dlna);
    x_prev = x_h; t_prev = t_new; xe_prev = xe; was_saha = use_saha;
    po = cb;
    cur = nxt;
  }
}

}  // namespace
