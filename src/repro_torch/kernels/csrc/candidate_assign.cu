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
// block, partly from L2) against 2 n kn_pad d FP32 FLOPs. Design: one
// CUDA block per point block, which reads its own rowsel/skip (the TPU's
// scalar prefetch); a skipped block copies prev_* and returns without
// touching x or the table. Threads cover (row, candidate) pairs and loop
// over d in chunks of DC columns staged through shared memory (row stride
// DC+1 against bank conflicts), so any bn, kn_pad and d fit. One thread
// per row then scans the pairs in column order with strict <, which is
// the flat first-min of the TPU kernel's tile-by-tile merge, and keeps
// the second-best of the multiset.
#include <math.h>
#include "common.cuh"

namespace {
constexpr int NT = 256;
constexpr int DC = 32;

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
  extern __shared__ float smem[];
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
  float* xs = smem;                       // (bn, DC+1)
  float* cs = xs + bn * (DC + 1);         // (knp, DC+1)
  float* acc = cs + knp * (DC + 1);       // (bn, knp) running x.c
  float* xsq = acc + bn * knp;            // (bn,) running |x|^2
  const int pairs = bn * knp;
  for (int p = threadIdx.x; p < pairs; p += NT) acc[p] = 0.f;
  for (int r = threadIdx.x; r < bn; r += NT) xsq[r] = 0.f;
  for (int t0 = 0; t0 < d; t0 += DC) {
    const int w = min(DC, d - t0);
    __syncthreads();
    for (int e = threadIdx.x; e < bn * DC; e += NT) {
      const int r = e / DC, j = e % DC;
      xs[r * (DC + 1) + j] = j < w ? x[(row0 + r) * d + t0 + j] : 0.f;
    }
    for (int e = threadIdx.x; e < knp * DC; e += NT) {
      const int r = e / DC, j = e % DC;
      cs[r * (DC + 1) + j] = j < w ? slab[(size_t)r * d + t0 + j] : 0.f;
    }
    __syncthreads();
    for (int r = threadIdx.x; r < bn; r += NT) {
      const float* xr = xs + r * (DC + 1);
      float s = xsq[r];
#pragma unroll 8
      for (int j = 0; j < DC; ++j) s += xr[j] * xr[j];
      xsq[r] = s;
    }
    for (int p = threadIdx.x; p < pairs; p += NT) {
      const float* xr = xs + (p / knp) * (DC + 1);
      const float* cr = cs + (p % knp) * (DC + 1);
      float s = acc[p];
#pragma unroll 8
      for (int j = 0; j < DC; ++j) s += xr[j] * cr[j];
      acc[p] = s;
    }
  }
  __syncthreads();
  const float* csq = csqtab + (size_t)t * knp;
  const int* ids = cidx + (size_t)t * knp;
  for (int r = threadIdx.x; r < bn; r += NT) {
    float b1 = INFINITY, b2 = INFINITY;
    int arg = 0;
    for (int q = 0; q < knp; ++q) {
      const float v = fmaxf((xsq[r] - 2.f * acc[r * knp + q]) + csq[q], 0.f);
      if (v < b1) {
        b2 = b1;
        b1 = v;
        arg = q;
      } else if (v < b2) {
        b2 = v;
      }
    }
    a[row0 + r] = ids[arg];
    d1[row0 + r] = b1;
    d2[row0 + r] = b2;
  }
}
}  // namespace

// x: (nb*bn, d) f32; ctab: (T, knp, d) f32; csqtab: (T, knp) f32;
// cidx: (T, knp) i32; rowsel, skip: (nb,) i32; prev_a i32, prev_d1/d2 f32
// and the outputs a i32, d1/d2 f32: (nb*bn,).
K2_EXPORT int k2_candidate_assign_tiled(
    const float* x, const float* ctab, const float* csqtab, const int* cidx,
    const int* rowsel, const int* skip, const int* prev_a, const float* prev_d1,
    const float* prev_d2, int* a, float* d1, float* d2, int nb, int bn, int knp,
    int d, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(bn + knp) * (DC + 1) + (size_t)bn * knp + bn);
  cudaError_t err = k2_set_smem(candidate_assign_tiled_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (nb > 0)
    candidate_assign_tiled_kernel<<<nb, NT, smem, stream>>>(
        x, ctab, csqtab, cidx, rowsel, skip, prev_a, prev_d1, prev_d2, a, d1,
        d2, bn, knp, d);
  return (int)cudaGetLastError();
}
