// K7: the legacy rowwise k_n-restricted assignment, one candidate center at
// a time: the baseline the tiled kernel K1 is measured against.
//
// Replaces the Pallas TPU kernel src/repro/kernels/candidate_assign.py
// (candidate_assign_rowwise / _rowwise_kernel): per block of bn points, the
// squared distance max(|x|^2 - 2 x.c + |c|^2, 0) to each center of the
// block's own list cand[b, :] in list order, gathered straight from c (the
// TPU kernel's one DMA per grid step), keeping the best distance and its
// center with strict <, so ties go to the first in list order. A block with
// skip[b] != 0 copies prev_a / prev_d and reads neither x nor c.
//
// Bound on an H100: bytes. The work is 2 n kn d FLOPs against the point
// rows read once (n d 4 bytes) plus the distinct center rows the lists name
// (0.09 ms for the fit arena at n=92000, d=784, k_n=30; the FLOPs take
// 0.06 ms at the FP32 peak). Design: one CUDA block of eight warps per
// point block; each warp takes rows b*bn + w, + 8, ..., and for its row
// walks the list, the 32 lanes striding over d and summing in f64, joined
// by xor shuffles so every lane holds the sum and updates the row's (best,
// argbest) alike. The row stays in L1 across its k_n candidates; the
// center rows of the list are shared by the block's warps through L1/L2.
// No shared memory.
//
// Rounding: x.c and |x|^2 accumulate in f64 and are correctly rounded to
// f32 (common.cuh), and |c|^2 comes in rounded the same way
// (exact_round.exact_sqnorm, taken outside the kernel as the TPU kernel's
// wrapper takes it); the distance is evaluated with explicit __f*_rn steps
// in the plain version's order. The kernel and ref.candidate_assign_ref
// then agree bit for bit, and K1 gives the same pair the same value, so
// both pick the same center from the same list.
#include <math.h>
#include "common.cuh"

namespace {
constexpr int NT = 256;
constexpr int NW = NT / 32;

__device__ __forceinline__ double warp_sum_all(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(NT)
candidate_assign_rowwise_kernel(const float* __restrict__ x,
                                const float* __restrict__ c,
                                const float* __restrict__ csq,
                                const int* __restrict__ cand,
                                const int* __restrict__ skip,
                                const int* __restrict__ prev_a,
                                const float* __restrict__ prev_d,
                                int* __restrict__ a, float* __restrict__ dout,
                                int bn, int kn, int d) {
  const int b = blockIdx.x;
  const size_t row0 = (size_t)b * bn;
  if (skip[b] != 0) {
    for (int r = threadIdx.x; r < bn; r += NT) {
      a[row0 + r] = prev_a[row0 + r];
      dout[row0 + r] = prev_d[row0 + r];
    }
    return;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* list = cand + (size_t)b * kn;
  for (int r = warp; r < bn; r += NW) {
    const float* xr = x + (row0 + r) * d;
    double s = 0.0;
    for (int j = lane; j < d; j += 32) s = fma((double)xr[j], (double)xr[j], s);
    const double s2 = warp_sum_all(s);      // the same in every lane
    const float xs2 = k2_round_sum_uniform(s2, k2_gamma(d) * s2, xr, 1, xr,
                                           1, d);
    float best = INFINITY;
    int arg = 0;
    for (int q = 0; q < kn; ++q) {
      const int ci = list[q];
      const float* cr = c + (size_t)ci * d;
      double t = 0.0;
      for (int j = lane; j < d; j += 32)
        t = fma((double)xr[j], (double)cr[j], t);
      const float cross = k2_round_sum_uniform(
          warp_sum_all(t), k2_gamma(d) * sqrt(s2 * k2_sqnorm_up(csq[ci])), xr,
          1, cr, 1, d);
      const float v = fmaxf(
          __fadd_rn(__fsub_rn(xs2, __fmul_rn(2.f, cross)), csq[ci]), 0.f);
      if (v < best) {
        best = v;
        arg = ci;
      }
    }
    if (lane == 0) {
      a[row0 + r] = arg;
      dout[row0 + r] = best;
    }
  }
}
}  // namespace

// x: (nb*bn, d) f32; c: (k, d) f32; csq: (k,) f32 exactly rounded |c|^2;
// cand: (nb, kn) i32 center ids in [0, k); skip: (nb,) i32; prev_a i32,
// prev_d f32 and the outputs a i32, dout f32: (nb*bn,).
K2_EXPORT int k2_candidate_assign_rowwise(const float* x, const float* c,
                                          const float* csq, const int* cand,
                                          const int* skip, const int* prev_a,
                                          const float* prev_d, int* a,
                                          float* dout, int nb, int bn, int kn,
                                          int d, cudaStream_t stream) {
  if (bn < 1 || kn < 1 || d < 0) return (int)cudaErrorInvalidValue;
  if (nb > 0)
    candidate_assign_rowwise_kernel<<<nb, NT, 0, stream>>>(
        x, c, csq, cand, skip, prev_a, prev_d, a, dout, bn, kn, d);
  return (int)cudaGetLastError();
}
