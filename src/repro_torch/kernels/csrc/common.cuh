// Shared helpers of the port's CUDA kernels. Every entry point is a plain
// C function that launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#define K2_EXPORT extern "C" __attribute__((visibility("default")))

// Opt a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename K>
static inline cudaError_t k2_set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

__device__ __forceinline__ float k2_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// --- One correctly rounded value per (point, center) pair ---------------
//
// Every kernel that forms |x|^2 or x.c from f32 rows returns RN_f32 of the
// exact sum of the exact f32 x f32 products: the f32 nearest that real
// number, ties to even, with a zero returned as +0. That value has no
// order, so the kernels, their plain versions (ref.exact_sqnorm,
// ref.exact_cross) and the torch paths agree bit for bit, whatever order
// each sums in.
//
// It is reached by a screen and an exact fallback. The caller has s, the
// f64 sum of the products in its own order (register tile, DMMA, warp
// butterfly), and a bound bnd >= sum |a_i b_i|: for x.c the square root of
// the product of the two f64 (or rounded-up f32) squared norms
// (Cauchy-Schwarz), for |x|^2 the sum itself. In any order, an f64 sum of
// d exact products lies within gamma_d * sum |p_i| of the exact sum, with
// gamma_d = d u / (1 - d u) and u = 2^-53 (Higham, Accuracy and Stability
// of Numerical Algorithms, 2nd ed., §3.1). k2_gamma multiplies gamma_d by
// a safety factor 1 + 2^-20, which covers the rounding of the bound's own
// arithmetic (a few units of 2^-53) and a bnd built from norms that are
// themselves f64 sums of d terms (relative error gamma_d <= 2^-22 for
// d < 2^31). If s - e and s + e, rounded outward, round to the same f32,
// that f32 is the answer, since f64 -> f32 rounding is monotone. Otherwise
// (a few pairs in a hundred thousand at the fit's shapes) one warp
// recomputes the sum exactly from the two f32 rows in global memory and
// rounds once (k2_exact_dot_warp).

__device__ __forceinline__ double k2_gamma(int d) {
  const double u = (double)d * 0x1p-53;
  return u / (1.0 - u) * (1.0 + 0x1p-20);
}

// The screen alone: true, with the correctly rounded value in out, when
// every real number within e of s rounds to one f32 (non-finite s passes
// through); false when the sum must be recomputed exactly. Kernels screen
// in their epilogues and recompute the rare flagged sums after, a warp at
// a time (k2_exact_dot_lanes), outside their unrolled loops.
__device__ __forceinline__ bool k2_screen(double s, double e, float& out) {
  const float lo = __double2float_rn(__dsub_rd(s, e));
  const float hi = __double2float_rn(__dadd_ru(s, e));
  out = __fadd_rn(hi, 0.f);
  return lo == hi || !(fabs(s) <= 1.79e308);
}

// RN_f32 of sum_i a[i sa] * b[i sb] over i < d, exactly, computed by one
// whole warp (every lane calls it, converged, with the same arguments, and
// every lane gets the value). Each product is an integer m < 2^48 times
// 2^(E - 298) with 0 <= E <= 506; lane l adds products l, l + 32, ... into
// a fixed-point accumulator of 19 signed 64-bit limbs of 32 bits each
// (bits 0..607 of value * 2^298), the lanes' limbs are summed by
// butterflies (room for 2^29 products in all), and the sum is rounded once
// to nearest, ties to even, with f32's subnormal quantum 2^-149 and
// overflow to infinity. Off the fast path: only sums the screen flags.
__device__ __noinline__ float k2_exact_dot_warp(const float* a, long long sa,
                                                const float* b, long long sb,
                                                int d) {
  constexpr int L = 19;
  long long acc[L];
#pragma unroll
  for (int i = 0; i < L; ++i) acc[i] = 0;
  for (int i = threadIdx.x % 32; i < d; i += 32) {
    const unsigned ua = __float_as_uint(a[i * sa]);
    const unsigned ub = __float_as_uint(b[i * sb]);
    const unsigned ea = (ua >> 23) & 0xffu, eb = (ub >> 23) & 0xffu;
    unsigned long long ma = ua & 0x7fffffu, mb = ub & 0x7fffffu;
    if (ea) ma |= 0x800000u;
    if (eb) mb |= 0x800000u;
    if (ma == 0 || mb == 0) continue;
    const unsigned long long m = ma * mb;
    const int p = (int)(ea ? ea : 1u) + (int)(eb ? eb : 1u) - 2;
    const int li = p >> 5, off = p & 31;
    const unsigned long long lo = (m & 0xffffffffull) << off;
    const unsigned long long hi = (m >> 32) << off;
    long long t0 = (long long)(lo & 0xffffffffull);
    long long t1 = (long long)(lo >> 32) + (long long)(hi & 0xffffffffull);
    long long t2 = (long long)(hi >> 32);
    if ((ua ^ ub) >> 31) {
      t0 = -t0;
      t1 = -t1;
      t2 = -t2;
    }
    acc[li] += t0;
    acc[li + 1] += t1;
    acc[li + 2] += t2;
  }
#pragma unroll
  for (int i = 0; i < L; ++i)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  // carries: every limb but the top into [0, 2^32)
  for (int i = 0; i < L - 1; ++i) {
    const long long c = acc[i] >> 32;
    acc[i] &= 0xffffffffll;
    acc[i + 1] += c;
  }
  const bool neg = acc[L - 1] < 0;
  if (neg) {
    for (int i = 0; i < L; ++i) acc[i] = -acc[i];
    for (int i = 0; i < L - 1; ++i) {
      const long long c = acc[i] >> 32;
      acc[i] &= 0xffffffffll;
      acc[i + 1] += c;
    }
  }
  int h = L - 1;
  while (h >= 0 && acc[h] == 0) --h;
  if (h < 0) return 0.f;
  // the leading bit (every limb is now in [0, 2^32))
  const int top = 63 - __clzll((unsigned long long)acc[h]) + 32 * h;
  auto bits = [&](int lo_bit, int n) -> unsigned long long {
    const int j = lo_bit >> 5, o = lo_bit & 31;
    unsigned long long w = (unsigned long long)acc[j] & 0xffffffffull;
    if (j + 1 < L) w |= ((unsigned long long)acc[j + 1] & 0xffffffffull) << 32;
    return (w >> o) & ((1ull << n) - 1);
  };
  const int cut = max(top - 23, 149);          // the f32 quantum's bit
  unsigned long long q = top >= cut ? bits(cut, top - cut + 1) : 0ull;
  const int gp = cut - 1;                      // the guard bit
  const bool guard = gp <= top && bits(gp, 1) != 0;
  bool sticky = (acc[gp >> 5] & ((1ll << (gp & 31)) - 1)) != 0;
  for (int i = 0; i < (gp >> 5); ++i) sticky |= acc[i] != 0;
  if (guard && (sticky || (q & 1))) ++q;
  if (q == 0) return 0.f;
  const float r = scalbnf((float)q, cut - 298);
  return neg ? -r : r;
}

// The screen's second stage, one whole warp (converged, the same arguments
// in every lane): the dot product again as a double-double. Lane l sums
// its products l, l + 32, ... with TwoSum (Knuth: s + q = hi + p exactly),
// the lanes' (hi, lo) meet by butterflies of TwoSum, and |a_i b_i| is
// summed beside. Every TwoSum error is exact and at most u times its
// partial sum (<= sum |p|); at most ceil(d/32) + 31 of them enter a
// result, and lo sums them with at most d + 64 roundings, so
// |(hi + lo) - exact| <= gamma_{d+64} u (ceil(d/32) + 31) sum |p|
// (Ogita, Rump and Oishi, SIAM J. Sci. Comput. 26(6), 2005, Prop. 4.5's
// argument, for a tree of TwoSums). With t = hi + lo rounded, the screen
// runs again with e = 2 (u |t| + that bound); the factor 2 covers f64
// rounding in sum |p| and in e. True, with the value in out, when it
// decides; false leaves the sum to k2_exact_dot_warp. It decides all but
// sums within about 2^-52 of an f32 rounding midpoint, relatively.
__device__ __noinline__ bool k2_refine_dot_warp(const float* a, long long sa,
                                                const float* b, long long sb,
                                                int d, float& out) {
  double hi = 0.0, lo = 0.0, ab = 0.0;
  for (int i = threadIdx.x % 32; i < d; i += 32) {
    const double p = __dmul_rn((double)a[i * sa], (double)b[i * sb]);
    const double s = __dadd_rn(hi, p);
    const double bb = __dsub_rn(s, hi);
    lo = __dadd_rn(lo, __dadd_rn(__dsub_rn(hi, __dsub_rn(s, bb)),
                                 __dsub_rn(p, bb)));
    hi = s;
    ab = __dadd_rn(ab, fabs(p));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double h2 = __shfl_xor_sync(0xffffffffu, hi, o);
    const double l2 = __shfl_xor_sync(0xffffffffu, lo, o);
    const double s = __dadd_rn(hi, h2);
    const double bb = __dsub_rn(s, hi);
    const double q = __dadd_rn(__dsub_rn(hi, __dsub_rn(s, bb)),
                               __dsub_rn(h2, bb));
    lo = __dadd_rn(__dadd_rn(lo, l2), q);
    hi = s;
    ab = __dadd_rn(ab, __shfl_xor_sync(0xffffffffu, ab, o));
  }
  const double u = 0x1p-53, n = (double)d + 64.0;
  const double t = __dadd_rn(hi, lo);
  const double e = 2.0 * (u * fabs(t) +
                          n * u / (1.0 - n * u) * u * ((d + 31) / 32 + 31) *
                              ab);
  return k2_screen(t, e, out);
}

// Every lane of a warp calls this, converged; the lanes with need set get
// the exact rounded dot product of their own pair (a, b), one pair after
// another: the double-double screen first, the fixed-point sum where that
// cannot decide. The others get 0. Out of line, so that a kernel's own
// loops keep their registers.
__device__ __noinline__ float k2_exact_dot_lanes(bool need, const float* a,
                                                    long long sa,
                                                    const float* b,
                                                    long long sb, int d) {
  float mine = 0.f;
  unsigned pending = __ballot_sync(0xffffffffu, need);
  while (pending) {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    const float* pa = reinterpret_cast<const float*>(
        __shfl_sync(0xffffffffu, reinterpret_cast<unsigned long long>(a), src));
    const float* pb = reinterpret_cast<const float*>(
        __shfl_sync(0xffffffffu, reinterpret_cast<unsigned long long>(b), src));
    const long long qa = __shfl_sync(0xffffffffu, sa, src);
    const long long qb = __shfl_sync(0xffffffffu, sb, src);
    float v;
    if (!k2_refine_dot_warp(pa, qa, pb, qb, d, v))
      v = k2_exact_dot_warp(pa, qa, pb, qb, d);
    if ((int)(threadIdx.x % 32) == src) mine = v;
  }
  return mine;
}

// The correctly rounded value of a sum whose f64 value in some order is s
// and whose exact value lies within e of s; a[i sa] * b[i sb], i < d, are
// its products, read again only if the screen cannot decide. Called by
// every lane of a warp, converged, each with its own sum.
__device__ __forceinline__ float k2_round_sum(double s, double e,
                                             const float* a, long long sa,
                                             const float* b, long long sb,
                                             int d) {
  float v;
  const bool ok = k2_screen(s, e, v);
  if (__any_sync(0xffffffffu, !ok)) {
    const float x = k2_exact_dot_lanes(!ok, a, sa, b, sb, d);
    if (!ok) v = x;
  }
  return v;
}

// k2_round_sum for a sum the whole warp holds (the same s and e in every
// lane, as after a butterfly): the warp recomputes it together if flagged.
__device__ __forceinline__ float k2_round_sum_uniform(double s, double e,
                                                     const float* a,
                                                     long long sa,
                                                     const float* b,
                                                     long long sb, int d) {
  float v;
  if (k2_screen(s, e, v) || k2_refine_dot_warp(a, sa, b, sb, d, v)) return v;
  return k2_exact_dot_warp(a, sa, b, sb, d);
}

// |x|^2 of a row from its f64 sum of squares in any order (every lane of
// a warp calls it, converged).
__device__ __forceinline__ float k2_round_sqnorm(double s, const float* x,
                                                 int d) {
  return k2_round_sum(s, k2_gamma(d) * s, x, 1, x, 1, d);
}

// A bound >= sum c_i^2 from its correctly rounded f32 value: at most
// 2^-24 below it relatively while normal, and at most 2^-150 below it in
// f32's subnormal range (a zero may stand for a nonzero row).
__device__ __forceinline__ double k2_sqnorm_up(float csq) {
  return (double)csq * (1.0 + 0x1p-22) + 0x1p-149;
}
