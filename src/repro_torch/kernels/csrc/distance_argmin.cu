// K5: the nearest of all k centers for every point, fused with its squared
// distance: Lloyd's assignment step and the port's assign_nearest.
//
// Replaces the Pallas TPU kernel src/repro/kernels/distance_argmin.py
// (distance_argmin / _kernel): for each point, the argmin over every center
// of max(|x|^2 - 2 x.c + |c|^2, 0) and that minimum, carried across center
// tiles with strict < so ties go to the first center in flat order; the
// (n, k) distance matrix is never written.
//
// Bound on an H100: operations. The work is 2 n k d FLOPs against n d + k d
// floats read once (n=60000, d=784, k=1000: 94 GFLOP, 1.4 ms at the FP32
// peak, against 0.06 ms for the bytes). Design: one CUDA block per tile of
// BM = 64 points, which walks every center in tiles of BK = 64 (the TPU
// kernel's k-minor grid axis, as a loop inside the block). For each center
// tile it loops over d in chunks of DC, staging the point rows and the
// center rows through shared memory, widened to f64 once there (row stride
// DC+1 against bank conflicts; zero past n, k and d, so ragged shapes need
// no padded copies). The threads form 16 x 16 lanes; each holds a 4 x 4
// register tile of (point, center) accumulators, points ty + 16 i and
// centers tx + 16 j, so every staged value it loads feeds four FMAs. At the
// end of a center tile each thread takes its first minimum over its four
// centers, the 16 lanes of a row merge theirs by shuffles (the lower
// center wins a tie), and the row's running (min, argmin) takes the tile's
// only when strictly smaller. |x|^2 accumulates during the first center
// tile. Shared memory is 35 KB.
//
// Rounding: x.c and |x|^2 accumulate in f64 (each f32 x f32 product is
// exact there) and are rounded once to f32, as K1 does; |c|^2 comes in
// rounded the same way (ref.exact_sqnorm, taken outside the kernel as the
// TPU kernel's wrapper takes it). The distance is then evaluated in f32
// with explicit __f*_rn steps in the plain version's order, so the kernel
// and ref.distance_argmin_ref agree bit for bit, and a (point, center) pair
// has the value that K1, the Elkan path and the int8 re-rank give it.
#include <math.h>
#include <limits.h>
#include "common.cuh"

namespace {
constexpr int NT = 256;
constexpr int TX = 16, TY = NT / TX;   // center lanes x point lanes
constexpr int RM = 4, CN = 4;          // register tile of each thread
constexpr int BM = TY * RM;            // points per block
constexpr int BK = TX * CN;            // centers per tile
constexpr int DC = 32;
constexpr int LD = DC + 1;

__global__ void __launch_bounds__(NT)
distance_argmin_kernel(const float* __restrict__ x,
                       const float* __restrict__ c,
                       const float* __restrict__ csq, int* __restrict__ a,
                       float* __restrict__ dmin, int n, int k, int d) {
  __shared__ double xs[BM * LD];
  __shared__ double cs[BK * LD];
  __shared__ double xsq[BM];
  const size_t row0 = (size_t)blockIdx.x * BM;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float best[RM];
  int arg[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    best[i] = INFINITY;
    arg[i] = 0;
  }
  for (int c0 = 0; c0 < k; c0 += BK) {
    double acc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = 0.0;
    for (int t0 = 0; t0 < d; t0 += DC) {
      const int w = min(DC, d - t0);
      __syncthreads();
      for (int e = threadIdx.x; e < BM * DC; e += NT) {
        const int r = e / DC, j = e % DC;
        xs[r * LD + j] = row0 + r < (size_t)n && j < w
                             ? (double)x[(row0 + r) * d + t0 + j]
                             : 0.0;
      }
      for (int e = threadIdx.x; e < BK * DC; e += NT) {
        const int q = e / DC, j = e % DC;
        cs[q * LD + j] = c0 + q < k && j < w
                             ? (double)c[(size_t)(c0 + q) * d + t0 + j]
                             : 0.0;
      }
      __syncthreads();
      if (c0 == 0 && threadIdx.x < BM) {
        const double* xr = xs + threadIdx.x * LD;
        double s = t0 == 0 ? 0.0 : xsq[threadIdx.x];
#pragma unroll 8
        for (int j = 0; j < DC; ++j) s = fma(xr[j], xr[j], s);
        xsq[threadIdx.x] = s;
      }
#pragma unroll 4
      for (int j = 0; j < DC; ++j) {
        double xv[RM], cv[CN];
#pragma unroll
        for (int i = 0; i < RM; ++i) xv[i] = xs[(ty + TY * i) * LD + j];
#pragma unroll
        for (int q = 0; q < CN; ++q) cv[q] = cs[(tx + TX * q) * LD + j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int q = 0; q < CN; ++q) acc[i][q] = fma(xv[i], cv[q], acc[i][q]);
      }
    }
    __syncthreads();                   // xsq of every row is final
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float xs2 = __double2float_rn(xsq[ty + TY * i]);
      float v = INFINITY;
      int col = INT_MAX;
#pragma unroll
      for (int q = 0; q < CN; ++q) {
        const int cc = c0 + tx + TX * q;
        if (cc >= k) continue;
        const float cross = __double2float_rn(acc[i][q]);
        const float dq = fmaxf(
            __fadd_rn(__fsub_rn(xs2, __fmul_rn(2.f, cross)), csq[cc]), 0.f);
        if (dq < v) {
          v = dq;
          col = cc;
        }
      }
      // the 16 center lanes of this row are one half of a warp
#pragma unroll
      for (int o = TX / 2; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, o);
        const int oc = __shfl_xor_sync(0xffffffffu, col, o);
        if (ov < v || (ov == v && oc < col)) {
          v = ov;
          col = oc;
        }
      }
      if (v < best[i]) {
        best[i] = v;
        arg[i] = col;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const size_t r = row0 + ty + TY * i;
      if (r < (size_t)n) {
        a[r] = arg[i];
        dmin[r] = best[i];
      }
    }
  }
}
}  // namespace

// x: (n, d) f32; c: (k, d) f32; csq: (k,) f32 exactly rounded |c|^2;
// outputs a (n,) i32 and dmin (n,) f32. k >= 1.
K2_EXPORT int k2_distance_argmin(const float* x, const float* c,
                                 const float* csq, int* a, float* dmin, int n,
                                 int k, int d, cudaStream_t stream) {
  if (n < 0 || k < 1 || d < 0) return (int)cudaErrorInvalidValue;
  const int nb = (n + BM - 1) / BM;
  if (nb > 0)
    distance_argmin_kernel<<<nb, NT, 0, stream>>>(x, c, csq, a, dmin, n, k, d);
  return (int)cudaGetLastError();
}
