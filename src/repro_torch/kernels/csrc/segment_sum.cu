// Per-segment sums over a block-grouped layout, each a sequential f32
// chain in slot order: the bits of the CPU's row-order scatter-add, on the
// card, the same in every run.
//
// Not a port of a TPU kernel. The reference takes these sums with
// jax.ops.segment_sum (XLA's scatter-add) in the k2-means engine's center
// update (src/repro/core/engine.py). On the card an index_add_ adds with
// atomics in no fixed order, so the fit differed from run to run; a
// sort-based ordered scatter (index_put_ with accumulate) keeps the order
// but took 0.8 ms for the engine's moved rows at d = 784. Here the layout's grouping gives the
// order: a segment owns whole blocks of bn slots, and its rows, taken in
// block order and then slot order, are exactly the rows the CPU's
// scatter-add visits in row order. One thread owns one (segment, lane)
// chain, lanes 0..d-1 the columns of x and lane d the weight (the count),
// and walks the segment's slots adding RN(x * w) to an f32 sum with
// __fadd_rn: the same operations in the same order as the CPU.
//
// Bound on an H100: bytes, each slot's row read once (92,000 x 784 f32 at
// the fit's arena: 0.09 ms at 3.35 TB/s). Loads are issued U slots ahead
// of the adds, so a chain waits on memory once per U slots: a segment of
// tens of thousands of slots would run at memory latency, not bandwidth
// (GDI's first rounds were such chains, and take their totals from K3).
#include <stdint.h>
#include "common.cuh"

namespace {
constexpr int NT = 128;
constexpr int U = 32;

// blist: the layout's blocks ordered by segment, then by block; boff:
// (k + 1,) offsets of each segment's run in blist. perm (slot -> row, -1
// for an empty slot) and w (slot weight) may be null: slot s reads row s,
// weight 1.
__global__ void __launch_bounds__(NT)
segment_sum_blocks_kernel(const float* __restrict__ x,
                          const float* __restrict__ w,
                          const int* __restrict__ perm,
                          const int* __restrict__ blist,
                          const int* __restrict__ boff,
                          float* __restrict__ sums, float* __restrict__ cnt,
                          int nlb, int bn, int d) {
  const int seg = blockIdx.x / nlb;
  const int lane = (blockIdx.x % nlb) * NT + threadIdx.x;
  if (lane > d) return;
  const long long n0 = (long long)boff[seg] * bn;
  const long long n1 = (long long)boff[seg + 1] * bn;
  float acc = 0.f;
  for (long long i0 = n0; i0 < n1; i0 += U) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      v[u] = 0.f;
      const long long i = i0 + u;
      if (i < n1) {
        const long long slot = (long long)blist[i / bn] * bn + i % bn;
        const long long row = perm ? (long long)perm[slot] : slot;
        if (row >= 0) {
          const float val = lane < d ? x[row * d + lane] : 1.f;
          v[u] = w ? __fmul_rn(val, w[slot]) : val;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) acc = __fadd_rn(acc, v[u]);
  }
  if (lane < d)
    sums[(long long)seg * d + lane] = acc;
  else
    cnt[seg] = acc;
}
}  // namespace

// x: (rows, d) f32; w: (nb * bn,) f32 or null; perm: (nb * bn,) i32 or
// null; blist: (nb,) i32; boff: (k + 1,) i32; outputs sums (k, d) and cnt
// (k,) f32.
K2_EXPORT int k2_segment_sum_blocks(const float* x, const float* w,
                                    const int* perm, const int* blist,
                                    const int* boff, float* sums, float* cnt,
                                    int k, int bn, int d,
                                    cudaStream_t stream) {
  if (k < 0 || bn < 1 || d < 0) return (int)cudaErrorInvalidValue;
  const int nlb = (d + 1 + NT - 1) / NT;
  if (k > 0)
    segment_sum_blocks_kernel<<<(unsigned)k * nlb, NT, 0, stream>>>(
        x, w, perm, blist, boff, sums, cnt, nlb, bn, d);
  return (int)cudaGetLastError();
}
