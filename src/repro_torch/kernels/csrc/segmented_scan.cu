// K3: segmented inclusive scans of w*x (d lanes), w*|x|^2 and w over a
// leaf-grouped layout, the Lemma-1 sweep of the divisive init.
//
// Replaces the Pallas TPU kernel src/repro/kernels/segmented_scan.py
// (segmented_scan / _kernel), which carries the running sum in scratch
// from one grid step to the next and so relies on the TPU running its
// grid in order. CUDA blocks run in no order, so the scan takes three
// passes: (1) per-bn-block totals of (w x, w |x|^2, w); (2) an exclusive
// scan of those totals within each segment (segments are block aligned,
// block2seg non-decreasing), one thread per lane; (3) a local inclusive
// scan inside every bn-block plus its offset.
//
// Bound on an H100: bytes, R d 4 in and R d 4 out (passes 1 and 3 each
// read x once, so this design moves 1.5x the bound). Lanes are columns
// of the row-major layout, so consecutive threads touch consecutive
// addresses in every pass; |x|^2 per row is one warp reduction.
#include "common.cuh"

namespace {
constexpr int NT = 256;

// Per-row w*|x|^2 of block b into qrow (shared), one warp per row.
__device__ void row_q(const float* __restrict__ x, const float* __restrict__ w,
                      size_t row0, int bn, int d, float* qrow) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < bn; r += NT / 32) {
    const float* xr = x + (row0 + r) * d;
    const float wr = w[row0 + r];
    float s = 0.f;
    for (int t = lane; t < d; t += 32) {
      const float v = xr[t] * wr;
      s += v * xr[t];
    }
    s = k2_warp_sum(s);
    if (lane == 0) qrow[r] = s;
  }
}

__global__ void __launch_bounds__(NT)
block_totals(const float* __restrict__ x, const float* __restrict__ w,
             float* __restrict__ tot, int bn, int d) {
  extern __shared__ float qrow[];
  const int b = blockIdx.x, lanes = d + 2;
  const size_t row0 = (size_t)b * bn;
  for (int col = threadIdx.x; col < d; col += NT) {
    float s = 0.f;
    for (int r = 0; r < bn; ++r) s += x[(row0 + r) * d + col] * w[row0 + r];
    tot[(size_t)b * lanes + col] = s;
  }
  row_q(x, w, row0, bn, d, qrow);
  __syncthreads();
  if (threadIdx.x == 0) {
    float sq = 0.f, sc = 0.f;
    for (int r = 0; r < bn; ++r) {
      sq += qrow[r];
      sc += w[row0 + r];
    }
    tot[(size_t)b * lanes + d] = sq;
    tot[(size_t)b * lanes + d + 1] = sc;
  }
}

__global__ void segment_offsets(const float* __restrict__ tot,
                                const int* __restrict__ b2s,
                                float* __restrict__ off, int nb, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  float run = 0.f;
#pragma unroll 4
  for (int b = 0; b < nb; ++b) {
    if (b > 0 && b2s[b] != b2s[b - 1]) run = 0.f;
    off[(size_t)b * lanes + lane] = run;
    run += tot[(size_t)b * lanes + lane];
  }
}

__global__ void __launch_bounds__(NT)
block_scan(const float* __restrict__ x, const float* __restrict__ w,
           const float* __restrict__ off, float* __restrict__ csum,
           float* __restrict__ qsum, float* __restrict__ cnt, int bn, int d) {
  extern __shared__ float qrow[];
  const int b = blockIdx.x, lanes = d + 2;
  const size_t row0 = (size_t)b * bn;
  for (int col = threadIdx.x; col < d; col += NT) {
    float run = off[(size_t)b * lanes + col];
    for (int r = 0; r < bn; ++r) {
      run += x[(row0 + r) * d + col] * w[row0 + r];
      csum[(row0 + r) * d + col] = run;
    }
  }
  row_q(x, w, row0, bn, d, qrow);
  __syncthreads();
  if (threadIdx.x == 0) {
    float rq = off[(size_t)b * lanes + d], rc = off[(size_t)b * lanes + d + 1];
    for (int r = 0; r < bn; ++r) {
      rq += qrow[r];
      rc += w[row0 + r];
      qsum[row0 + r] = rq;
      cnt[row0 + r] = rc;
    }
  }
}
}  // namespace

// x: (nb*bn, d) f32; w: (nb*bn,) f32; b2s: (nb,) i32; tot, off: (nb, d+2)
// f32 scratch; csum: (nb*bn, d), qsum and cnt: (nb*bn,) f32.
K2_EXPORT int k2_segmented_scan(const float* x, const float* w, const int* b2s,
                                float* tot, float* off, float* csum, float* qsum,
                                float* cnt, int nb, int bn, int d,
                                cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)bn;
  const int lanes = d + 2;
  if (nb > 0) {
    block_totals<<<nb, NT, smem, stream>>>(x, w, tot, bn, d);
    segment_offsets<<<(lanes + 127) / 128, 128, 0, stream>>>(tot, b2s, off, nb,
                                                             lanes);
    block_scan<<<nb, NT, smem, stream>>>(x, w, off, csum, qsum, cnt, bn, d);
  }
  return (int)cudaGetLastError();
}
