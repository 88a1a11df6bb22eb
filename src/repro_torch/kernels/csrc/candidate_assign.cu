// K1: k_n-restricted assignment over the cluster-grouped arena, the
// k2-means hotspot.
//
// Replaces the Pallas TPU kernel src/repro/kernels/candidate_assign.py
// (candidate_assign_tiled / _tiled_kernel): per block of bn points, the
// squared distance to every candidate of the block's table row
// cidx[rowsel[b]] (a (kn_pad, d) slab of the per-cluster table ctab);
// best and second-best squared distance and the argbest candidate id;
// flat first-min ties; skip[b] != 0 passes prev_* through untouched;
// padding columns carry csqtab = 1e30 and never win.
//
// Bound on an H100: bytes. A fully recomputed pass reads every arena row
// once (n d 4 bytes) plus the candidate slabs (kn_pad d 4 bytes per
// block, partly from L2) against 2 n kn_pad d FLOPs (f64 FMAs here).
// Design: one CUDA block per point block, which reads its own
// rowsel/skip (the TPU's scalar prefetch); a skipped block copies prev_*
// and returns without touching x or the table. The block walks its
// candidate list in chunks of KC columns. For each chunk it loops over d
// in chunks of DC, staging the x rows and the chunk's slab rows through
// shared memory, widened to f64 once there (row stride DC+1 against bank
// conflicts). The threads form TY row lanes x TX column lanes, 8 x 32 at
// bn <= 8 (the predict layout; 0.77-0.81x the time of 16 x 16 there,
// PERF.md) and 16 x 16 above; each holds an RM x CN register tile of
// (row, column) accumulators, rows ty + TY i and columns tx + TX j, so
// every staged value it loads feeds several FMAs. The chunk's distances
// go to shared memory, and thread r then scans row r's columns in order
// with strict <, carrying best, second-best and argbest in registers
// from chunk to chunk: the flat first-min of the TPU kernel's
// tile-by-tile merge, with the second-best of the multiset. Shared
// memory does not grow with kn_pad (at most 60 KB, at bn = 128), so any
// kn_pad and d fit; bn is at most 128 (ops.choose_group_bn's cap).
//
// Rounding: x.c and |x|^2 accumulate in f64 (each f32 x f32 product is
// exact there) and are rounded once to f32, which gives the correctly
// rounded value whatever the order of the sum, except for a double
// rounding when the f64 sum lands within its own error (~1e-13 relative)
// of an f32 rounding midpoint. The plain version and the int8 path's f32
// re-rank compute them the same way, so one (point, center) pair has one
// squared distance everywhere, and the f32 and int8 predict paths do not
// split on near-ties as two f32 summation orders would.
#include <math.h>
#include "common.cuh"

namespace {
constexpr int NT = 256;
constexpr int KC = 32;            // columns per chunk
constexpr int DC = 32;
constexpr int LD = DC + 1;
constexpr int BN_MAX = 128;

// TX column lanes x TY = NT / TX row lanes; each thread holds RM rows
// and CN = KC / TX columns, bn <= TY * RM
template <int TX, int RM>
__global__ void __launch_bounds__(NT)
candidate_assign_tiled_kernel(const float* __restrict__ x,
                              const float* __restrict__ ctab,
                              const float* __restrict__ csqtab,
                              const int* __restrict__ cidx,
                              const int* __restrict__ rowsel,
                              const int* __restrict__ skip,
                              const int* __restrict__ prev_a,
                              const float* __restrict__ prev_d1,
                              const float* __restrict__ prev_d2,
                              int* __restrict__ a, float* __restrict__ d1,
                              float* __restrict__ d2, int bn, int knp, int d) {
  constexpr int TY = NT / TX, CN = KC / TX;
  constexpr int BR = TY * RM;     // staged rows, zero past bn
  extern __shared__ double smem[];
  const int b = blockIdx.x;
  const size_t row0 = (size_t)b * bn;
  if (skip[b] != 0) {
    for (int r = threadIdx.x; r < bn; r += NT) {
      a[row0 + r] = prev_a[row0 + r];
      d1[row0 + r] = prev_d1[row0 + r];
      d2[row0 + r] = prev_d2[row0 + r];
    }
    return;
  }
  const int t = rowsel[b];
  const float* slab = ctab + (size_t)t * knp * d;
  const float* csq = csqtab + (size_t)t * knp;
  double* xs = smem;                          // (BR, LD) x chunk
  double* cs = xs + BR * LD;                  // (KC, LD) slab chunk
  double* xsq = cs + KC * LD;                 // (bn,) running |x|^2
  float* vt = reinterpret_cast<float*>(xsq + bn);   // (bn, KC) distances
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int me = threadIdx.x;                 // the row this thread scans
  float b1 = INFINITY, b2 = INFINITY;
  int arg = 0;
  for (int c0 = 0; c0 < knp; c0 += KC) {
    double acc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = 0.0;
    for (int t0 = 0; t0 < d; t0 += DC) {
      const int w = min(DC, d - t0);
      __syncthreads();
      for (int e = threadIdx.x; e < BR * DC; e += NT) {
        const int r = e / DC, j = e % DC;
        xs[r * LD + j] =
            r < bn && j < w ? (double)x[(row0 + r) * d + t0 + j] : 0.0;
      }
      for (int e = threadIdx.x; e < KC * DC; e += NT) {
        const int q = e / DC, j = e % DC;
        cs[q * LD + j] = c0 + q < knp && j < w
                             ? (double)slab[(size_t)(c0 + q) * d + t0 + j]
                             : 0.0;
      }
      __syncthreads();
      if (c0 == 0 && me < bn) {
        const double* xr = xs + me * LD;
        double s = t0 == 0 ? 0.0 : xsq[me];
#pragma unroll 8
        for (int j = 0; j < DC; ++j) s = fma(xr[j], xr[j], s);
        xsq[me] = s;
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
    __syncthreads();                          // xsq of every row is final
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + TY * i;
      if (r >= bn) continue;
      const float xs2 = __double2float_rn(xsq[r]);
#pragma unroll
      for (int q = 0; q < CN; ++q) {
        const int col = tx + TX * q;
        if (c0 + col >= knp) continue;
        const float cross = __double2float_rn(acc[i][q]);
        vt[r * KC + col] = fmaxf(
            __fadd_rn(__fsub_rn(xs2, __fmul_rn(2.f, cross)), csq[c0 + col]),
            0.f);
      }
    }
    __syncthreads();
    if (me < bn) {
      const int w = min(KC, knp - c0);
      for (int q = 0; q < w; ++q) {
        const float v = vt[me * KC + q];
        if (v < b1) {
          b2 = b1;
          b1 = v;
          arg = c0 + q;
        } else if (v < b2) {
          b2 = v;
        }
      }
    }
  }
  if (me < bn) {
    a[row0 + me] = cidx[(size_t)t * knp + arg];
    d1[row0 + me] = b1;
    d2[row0 + me] = b2;
  }
}

template <int TX, int RM>
cudaError_t launch(const float* x, const float* ctab, const float* csqtab,
                   const int* cidx, const int* rowsel, const int* skip,
                   const int* prev_a, const float* prev_d1,
                   const float* prev_d2, int* a, float* d1, float* d2, int nb,
                   int bn, int knp, int d, cudaStream_t stream) {
  const size_t smem = sizeof(double) * ((size_t)(NT / TX * RM + KC) * LD + bn)
                      + sizeof(float) * (size_t)bn * KC;
  cudaError_t err = k2_set_smem(candidate_assign_tiled_kernel<TX, RM>, smem);
  if (err != cudaSuccess) return err;
  if (nb > 0)
    candidate_assign_tiled_kernel<TX, RM><<<nb, NT, smem, stream>>>(
        x, ctab, csqtab, cidx, rowsel, skip, prev_a, prev_d1, prev_d2, a, d1,
        d2, bn, knp, d);
  return cudaGetLastError();
}
}  // namespace

// x: (nb*bn, d) f32; ctab: (T, knp, d) f32; csqtab: (T, knp) f32;
// cidx: (T, knp) i32; rowsel, skip: (nb,) i32; prev_a i32, prev_d1/d2 f32
// and the outputs a i32, d1/d2 f32: (nb*bn,). 1 <= bn <= 128.
K2_EXPORT int k2_candidate_assign_tiled(
    const float* x, const float* ctab, const float* csqtab, const int* cidx,
    const int* rowsel, const int* skip, const int* prev_a, const float* prev_d1,
    const float* prev_d2, int* a, float* d1, float* d2, int nb, int bn, int knp,
    int d, cudaStream_t stream) {
  if (bn < 1 || bn > BN_MAX || knp < 1) return (int)cudaErrorInvalidValue;
  auto go = bn <= 8    ? launch<32, 1>
            : bn <= 16 ? launch<16, 1>
            : bn <= 32 ? launch<16, 2>
            : bn <= 64 ? launch<16, 4>
                       : launch<16, 8>;
  return (int)go(x, ctab, csqtab, cidx, rowsel, skip, prev_a, prev_d1,
                 prev_d2, a, d1, d2, nb, bn, knp, d, stream);
}
