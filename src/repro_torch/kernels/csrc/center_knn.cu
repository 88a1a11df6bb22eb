// K2: k x k squared center distances, the O(k^2 d) term of the k2-means
// iteration (the input of the center k_n-NN graph).
//
// Replaces the Pallas TPU kernel src/repro/kernels/center_knn.py
// (_kernel / _center_sqdist_padded): (128,128) MXU tiles of
// max(|a|^2 - 2 a.b + |b|^2, 0).
//
// Bound on an H100: operations. 2 k^2 d FP32 FLOPs (1.6 GFLOP at k=1000,
// d=784) against k d + k^2 floats of traffic; FP32 outside the tensor
// cores (TF32 would break argmin parity). Design: a 64x64 output tile per
// block, both center panels staged through shared memory 16 columns at a
// time, a 4x4 register micro-tile per thread. Ragged edges are masked
// instead of padding k with far sentinel rows as the TPU kernel does.
#include "common.cuh"

namespace {
constexpr int TILE = 64;
constexpr int BK = 16;
constexpr int NT = 256;

__global__ void row_sqnorm(const float* __restrict__ c, float* __restrict__ csq,
                           int k, int d) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= k) return;
  float s = 0.f;
  for (int t = lane; t < d; t += 32) {
    const float v = c[(size_t)row * d + t];
    s += v * v;
  }
  s = k2_warp_sum(s);
  if (lane == 0) csq[row] = s;
}

__global__ void __launch_bounds__(NT)
center_sqdist_kernel(const float* __restrict__ c, const float* __restrict__ csq,
                     float* __restrict__ out, int k, int d) {
  __shared__ float as[BK][TILE + 4];
  __shared__ float bs[BK][TILE + 4];
  const int bi = blockIdx.y * TILE, bj = blockIdx.x * TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int t0 = 0; t0 < d; t0 += BK) {
    for (int e = threadIdx.x; e < TILE * BK; e += NT) {
      const int r = e / BK, t = e % BK, gt = t0 + t;
      const int gi = bi + r, gj = bj + r;
      as[t][r] = (gi < k && gt < d) ? c[(size_t)gi * d + gt] : 0.f;
      bs[t][r] = (gj < k && gt < d) ? c[(size_t)gj * d + gt] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < BK; ++t) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[t][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[t][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = bi + ty + 16 * i;
    if (gi >= k) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = bj + tx + 16 * j;
      if (gj < k)
        out[(size_t)gi * k + gj] = fmaxf((csq[gi] - 2.f * acc[i][j]) + csq[gj], 0.f);
    }
  }
}
}  // namespace

// c: (k, d) f32; csq: (k,) f32 scratch (row norms); out: (k, k) f32.
K2_EXPORT int k2_center_sqdist(const float* c, float* csq, float* out, int k,
                               int d, cudaStream_t stream) {
  row_sqnorm<<<(k * 32 + NT - 1) / NT, NT, 0, stream>>>(c, csq, k, d);
  dim3 grid((k + TILE - 1) / TILE, (k + TILE - 1) / TILE);
  center_sqdist_kernel<<<grid, NT, 0, stream>>>(c, csq, out, k, d);
  return (int)cudaGetLastError();
}
