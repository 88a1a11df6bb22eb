// Shared helpers of the port's CUDA kernels. Every entry point is a plain
// C function that launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <mutex>

#define K2_EXPORT extern "C" __attribute__((visibility("default")))

// Opt a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename K>
static inline cudaError_t k2_set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// True when p may be read in 16-byte pieces.
static inline bool k2_aligned16(const void* p) {
  return (uintptr_t)p % 16 == 0;
}

// Blocks of a kernel (nt threads, smem bytes of dynamic shared memory)
// that can be resident at once on the current device, after opting the
// kernel into its shared memory there; asked of the CUDA runtime once per
// kernel and device (the queries cost more host time than a launch).
template <typename K>
static long long k2_resident_blocks(K kernel, int nt, size_t smem,
                                    cudaError_t& err) {
  struct Entry {
    const void* fn;
    int dev;
    long long slots;
  };
  static Entry cache[64];
  static int used = 0;
  static std::mutex lock;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return 0;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i)
    if (cache[i].fn == (const void*)kernel && cache[i].dev == dev)
      return cache[i].slots;
  int sms = 0, per_sm = 0;
  err = k2_set_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, nt,
                                                        smem);
  if (err != cudaSuccess) return 0;
  const long long slots = (long long)sms * max(per_sm, 1);
  if (used < 64) cache[used++] = Entry{(const void*)kernel, dev, slots};
  return slots;
}

// ---------------------------------------------------------------------------
// Launch plans. Each launcher takes its grid, block, dynamic shared memory
// and template variant from a host-only plan function of its library, which
// is also exported as k2_plan_<kernel>(<shape args>, long long* out): the
// analyzer (repro_torch.analysis.kernel_contracts) reads the configuration
// the launcher launches, from the one place that decides it. A plan is
// K2P_WORDS long longs, in the order K2_PLAN_FIELDS names them:
//   grid_x, grid_y, grid_z: the grid of one launch; launches: how many such
//     launches the call makes (exact_cross splits a batch beyond 65,535);
//   threads, smem: threads a block and bytes of dynamic shared memory;
//   variant: the instantiation launched, an index into k2_variants_<kernel>;
//   vec: 1 when the copies run in 16-byte pieces, 0 when the launcher fell
//     back to its scalar path (shape or alignment), -1 when it has none;
//   rows, row_extent, cols, col_extent, batch: the output a launch must
//     cover (rows x cols, batch entries) and the rows and columns one unit
//     of work covers; units = ceil(rows / row_extent) ceil(cols /
//     col_extent) batch;
//   inner, inner_tile: the extent each unit walks (candidates, d) and the
//     tile it walks it in;
//   per_block: units one block covers in one pass;
//   stride: units a pass of the grid covers, for a persistent kernel whose
//     blocks stride over the units (0: each block covers its own);
//   resident: the resident blocks (all SMs) a persistent or residency-
//     sized plan assumed, 0 when the plan does not depend on them.
enum {
  K2P_GRID_X, K2P_GRID_Y, K2P_GRID_Z, K2P_LAUNCHES, K2P_THREADS, K2P_SMEM,
  K2P_VARIANT, K2P_VEC, K2P_ROWS, K2P_ROW_EXTENT, K2P_COLS, K2P_COL_EXTENT,
  K2P_BATCH, K2P_INNER, K2P_INNER_TILE, K2P_PER_BLOCK, K2P_STRIDE,
  K2P_RESIDENT, K2P_WORDS
};

K2_EXPORT const char* k2_plan_fields() {
  return "grid_x,grid_y,grid_z,launches,threads,smem,variant,vec,rows,"
         "row_extent,cols,col_extent,batch,inner,inner_tile,per_block,"
         "stride,resident";
}

// A plan of one launch of (gx, gy, gz) blocks of `threads` with `smem`
// bytes, everything else one unit a block over rows x 1 x 1.
static inline void k2_plan_init(long long* p, long long gx, long long gy,
                                long long gz, int threads, size_t smem,
                                int variant, int vec) {
  for (int i = 0; i < K2P_WORDS; ++i) p[i] = 0;
  p[K2P_GRID_X] = gx;
  p[K2P_GRID_Y] = gy;
  p[K2P_GRID_Z] = gz;
  p[K2P_LAUNCHES] = 1;
  p[K2P_THREADS] = threads;
  p[K2P_SMEM] = (long long)smem;
  p[K2P_VARIANT] = variant;
  p[K2P_VEC] = vec;
  p[K2P_ROW_EXTENT] = p[K2P_COLS] = p[K2P_COL_EXTENT] = p[K2P_BATCH] = 1;
  p[K2P_INNER_TILE] = p[K2P_PER_BLOCK] = 1;
}

static inline dim3 k2_grid(const long long* p) {
  return dim3((unsigned)p[K2P_GRID_X], (unsigned)p[K2P_GRID_Y],
              (unsigned)p[K2P_GRID_Z]);
}

// What the card can hold: out[0] the opt-in dynamic shared memory a block
// may have, out[1] the SMs, out[2] the shared memory an SM has, out[3] the
// shared memory the runtime reserves a block.
K2_EXPORT int k2_device_limits(long long* out) {
  int dev = 0, v[4] = {0, 0, 0, 0};
  cudaError_t err = cudaGetDevice(&dev);
  const cudaDeviceAttr at[4] = {cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                cudaDevAttrMultiProcessorCount,
                                cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                cudaDevAttrReservedSharedMemoryPerBlock};
  for (int i = 0; i < 4 && err == cudaSuccess; ++i)
    err = cudaDeviceGetAttribute(&v[i], at[i], dev);
  for (int i = 0; i < 4; ++i) out[i] = v[i];
  return (int)err;
}

// A kernel's attributes at a plan's block and shared memory: out[0]
// registers a thread, out[1] local (spill and stack) bytes a thread,
// out[2] static shared memory, out[3] the dynamic shared memory it is
// opted into (raised to smem first when below it, never lowered), out[4]
// blocks resident an SM at (threads, smem), out[5] its largest block.
static inline int k2_func_attrs(const void* fn, int threads, size_t smem,
                                long long* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err == cudaSuccess && (size_t)a.maxDynamicSharedSizeBytes < smem) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, fn);
  }
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (long long)a.localSizeBytes;
  out[2] = (long long)a.sharedSizeBytes;
  out[3] = a.maxDynamicSharedSizeBytes;
  out[4] = per_sm;
  out[5] = a.maxThreadsPerBlock;
  return 0;
}

// k2_variants_<kernel>(): the instantiations, comma-separated, in variant
// order; k2_attrs_<kernel>(variant, threads, smem, out): k2_func_attrs of
// one of them. fns is the launcher's array of kernel pointers.
#define K2_DESCRIBE(kernel, fns, names)                                      \
  K2_EXPORT const char* k2_variants_##kernel() { return names; }            \
  K2_EXPORT int k2_attrs_##kernel(int variant, int threads, long long smem, \
                                  long long* out) {                         \
    if (variant < 0 || variant >= (int)(sizeof(fns) / sizeof(fns[0])))     \
      return (int)cudaErrorInvalidValue;                                    \
    return k2_func_attrs((const void*)fns[variant], threads, (size_t)smem,  \
                         out);                                              \
  }

// cp.async of one 16- or 4-byte piece into shared memory; with valid
// false it reads nothing and fills the piece with zeros. Then commit a
// group, and wait until at most N groups are in flight. (K2, exact_cross
// and segment_sum_blocks use these and k2_dmma; K1 and K5 keep their own
// copies.)
__device__ __forceinline__ void k2_cp_async(float* dst, const float* src,
                                            bool valid, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
}

__device__ __forceinline__ void k2_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void k2_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D += A (16x8, row) * B (8x8, col) on the f64 tensor cores, f64 in, f64
// sums. Fragments (g = lane / 4, t = lane % 4): a = A[g][t], A[g+8][t],
// A[g][t+4], A[g+8][t+4]; b = B[t][g], B[t+4][g]; d = D[g][2t],
// D[g][2t+1], D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void k2_dmma(double (&d)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
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

// The exact tiers below read the two factors of product i through an
// element loader: pair(i) returns (a_i, b_i) as a float2. K2Strided reads
// two strided f32 rows, as most kernels store them; a kernel whose factors
// are formed on the fly (the split suffix tot - csum of GDI's scores,
// exact_round.cu) passes its own loader, so that the rare recompute reads
// the same values the fast path summed.
struct K2Strided {
  const float* a;
  long long sa;
  const float* b;
  long long sb;
  __device__ __forceinline__ float2 operator()(int i) const {
    return make_float2(a[i * sa], b[i * sb]);
  }
};

// RN_f32 of sum_i a_i * b_i over i < d, (a_i, b_i) = pair(i), exactly,
// computed by one whole warp (every lane calls it, converged, with the
// same arguments, and every lane gets the value). Each product is an integer m < 2^48 times
// 2^(E - 298) with 0 <= E <= 506; lane l adds products l, l + 32, ... into
// a fixed-point accumulator of 19 signed 64-bit limbs of 32 bits each
// (bits 0..607 of value * 2^298), the lanes' limbs are summed by
// butterflies (room for 2^29 products in all), and the sum is rounded once
// to nearest, ties to even, with f32's subnormal quantum 2^-149 and
// overflow to infinity. Off the fast path: only sums the screen flags.
template <class Pair>
__device__ __noinline__ float k2_exact_dot_warp(Pair pair, int d) {
  constexpr int L = 19;
  long long acc[L];
#pragma unroll
  for (int i = 0; i < L; ++i) acc[i] = 0;
  for (int i = threadIdx.x % 32; i < d; i += 32) {
    const float2 f = pair(i);
    const unsigned ua = __float_as_uint(f.x);
    const unsigned ub = __float_as_uint(f.y);
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
template <class Pair>
__device__ __noinline__ bool k2_refine_dot_warp(Pair pair, int d,
                                                float& out) {
  double hi = 0.0, lo = 0.0, ab = 0.0;
  for (int i = threadIdx.x % 32; i < d; i += 32) {
    const float2 f = pair(i);
    const double p = __dmul_rn((double)f.x, (double)f.y);
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

// The two tiers in turn for one sum the whole warp holds: the
// double-double screen, then the fixed-point sum where it cannot decide.
template <class Pair>
__device__ __forceinline__ float k2_exact_dot_tiers(Pair pair, int d) {
  float v;
  if (!k2_refine_dot_warp(pair, d, v)) v = k2_exact_dot_warp(pair, d);
  return v;
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
    const float v = k2_exact_dot_tiers(K2Strided{pa, qa, pb, qb}, d);
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
  if (k2_screen(s, e, v)) return v;
  return k2_exact_dot_tiers(K2Strided{a, sa, b, sb}, d);
}

// |x|^2 of a row from its f64 sum of squares in any order (every lane of
// a warp calls it, converged).
__device__ __forceinline__ float k2_round_sqnorm(double s, const float* x,
                                                 int d) {
  return k2_round_sum(s, k2_gamma(d) * s, x, 1, x, 1, d);
}

// Each row's squared norm, correctly rounded: one warp a row (NT / 32 rows
// a block), lanes striding over d, an f64 sum joined by a butterfly,
// screened and, where the screen cannot decide, recomputed exactly by the
// warp. Bound by bytes: one read of x, one f32 written per row.
template <int NT>
__global__ void __launch_bounds__(NT)
k2_exact_sqnorm_kernel(const float* __restrict__ x, float* __restrict__ out,
                       long long rows, int d) {
  const long long r = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;               // a whole warp
  const float* xr = x + r * d;
  double s = 0.0;
  for (int j = lane; j < d; j += 32) s = fma((double)xr[j], (double)xr[j], s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float v = k2_round_sum_uniform(s, k2_gamma(d) * s, xr, 1, xr, 1, d);
  if (lane == 0) out[r] = v;
}

// A bound >= sum c_i^2 from its correctly rounded f32 value: at most
// 2^-24 below it relatively while normal, and at most 2^-150 below it in
// f32's subnormal range (a zero may stand for a nonzero row).
__device__ __forceinline__ double k2_sqnorm_up(float csq) {
  return (double)csq * (1.0 + 0x1p-22) + 0x1p-149;
}
