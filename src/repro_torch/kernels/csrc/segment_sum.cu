// Per-segment sums over a block-grouped layout, each a sequential f32
// chain in slot order: the bits of the CPU's row-order scatter-add, on the
// card, the same in every run.
//
// Not a port of a TPU kernel. The reference takes these sums with
// jax.ops.segment_sum (XLA's scatter-add) in the k2-means engine's center
// update (src/repro/core/engine.py). On the card an index_add_ adds with
// atomics in no fixed order, so the fit differed from run to run; a
// sort-based ordered scatter (index_put_ with accumulate) keeps the order
// but took 0.8 ms for the engine's moved rows at d = 784. Here the
// layout's grouping gives the order: a segment owns whole blocks of bn
// slots, and its rows, taken in block order and then slot order, are
// exactly the rows the CPU's scatter-add visits in row order. Each
// (segment, column) chain adds RN(x * w) to an f32 sum with __fadd_rn,
// slot after slot: the same operations in the same order as the CPU; the
// count chain adds the weights.
//
// Bound on an H100: bytes, each slot's row read once (92,000 x 784 f32 at
// the fit's arena: 0.087 ms at 3.35 TB/s). Design:
// - segment_ranges: one thread a block records each segment's first and
//   last block (atomicMax, whose result has no order) and lists the
//   segments that own a block (the list's order does not matter: each
//   segment's sums are one block's work, and at the fit's arena taking
//   the longest segments first was no faster, PERF.md §6); no sort, no
//   offsets table;
// - segment_sum_kernel: a persistent grid of blocks walks the (listed
//   segment, column slice) items; a block scans the segment's range of
//   b2s, 512 entries a round, and compacts its blocks into shared memory
//   in block order; it reads each window of up to 512 slots' (row,
//   weight) once, coalesced, into shared memory; then each thread streams
//   its own VEC columns of those rows through a three-stage cp.async ring
//   of its own in shared memory (no barrier in the stream: a thread reads
//   only what it copied) and adds them to its chains in slot order, with
//   no branch on the data (branches there held each slot's add behind its
//   loads: the adds cost more than the stream, PERF.md §6).
// The outputs are zeroed first, so segments with no block cost nothing.
#include <stdint.h>
#include "common.cuh"

namespace {
constexpr int NT = 128;
constexpr int R = 8;            // slots a ring stage holds
constexpr int STAGES = 3;
constexpr int SCAN = 4 * NT;    // b2s entries a scan round reads
constexpr int SW = 512;         // slots a metadata window holds

// scratch (ints): [0] the number of listed segments, then first[k] (as nb
// - 1 - block, so that atomicMax finds the least block), last[k] and the
// list[k].
__global__ void segment_ranges(const int* __restrict__ b2s,
                               int* __restrict__ scr, int k, int nb) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const int s = b2s[b];
  if (s < 0 || s >= k) return;
  int* first = scr + 1;
  int* last = first + k;
  int* list = last + k;
  atomicMax(&first[s], nb - 1 - b);
  if (atomicMax(&last[s], b) < 0) list[atomicAdd(scr, 1)] = s;
}

// A block-wide exclusive scan of one int per thread; returns the total.
__device__ __forceinline__ int block_exclusive(int v, int& excl,
                                               int* warp_tot) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) {
    base += i < warp ? warp_tot[i] : 0;
    total += warp_tot[i];
  }
  excl = base + inc - v;
  __syncthreads();                     // warp_tot may be written again
  return total;
}

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
};
template <>
struct Vec<1> {
  using T = float;
};

__device__ __forceinline__ void add_chain(float4& acc, const float4& v,
                                          float w) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, w));
  acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, w));
  acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, w));
  acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, w));
}

__device__ __forceinline__ void add_chain(float& acc, float v, float w) {
  acc = __fadd_rn(acc, __fmul_rn(v, w));
}

__device__ __forceinline__ void keep_if(float4& acc, const float4& a,
                                        bool live) {
  acc.x = live ? a.x : acc.x;
  acc.y = live ? a.y : acc.y;
  acc.z = live ? a.z : acc.z;
  acc.w = live ? a.w : acc.w;
}

__device__ __forceinline__ void keep_if(float& acc, float a, bool live) {
  acc = live ? a : acc;
}

// x: rows of d floats; thread t owns column units cu0 + t (VEC floats
// each) of the slice [cu0, cu1) and, in slice 0, thread cu1 - cu0 the
// count chain. cpt: column units a slice holds.
template <int VEC>
__global__ void __launch_bounds__(NT)
segment_sum_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const int* __restrict__ perm,
                   const int* __restrict__ b2s, const int* __restrict__ scr,
                   float* __restrict__ sums, float* __restrict__ cnt, int k,
                   int nb, int bn, int d, int nslice, int cpt) {
  using V = typename Vec<VEC>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  V* ring = reinterpret_cast<V*>(smem);            // [STAGES][R][NT]
  int* mrow = reinterpret_cast<int*>(ring + STAGES * R * NT);  // [SW]
  float* mw = reinterpret_cast<float*>(mrow + SW);             // [SW]
  int* blk = reinterpret_cast<int*>(mw + SW);                  // [SCAN]
  int* warp_tot = blk + SCAN;                                  // [NT / 32]

  const int t = threadIdx.x;
  const int dv = (d + VEC - 1) / VEC;
  const int* first = scr + 1;
  const int* last = first + k;
  const int* list = last + k;
  const long long items = (long long)scr[0] * nslice;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int s = list[it / nslice], q = (int)(it % nslice);
    const int cu0 = q * cpt, cu1 = min(cu0 + cpt, dv);
    const int cu = cu0 + t;
    const bool mine = cu < cu1;
    const bool counts = q == 0 && t == cu1 - cu0;
    const V* xs = reinterpret_cast<const V*>(x) + cu;  // row r: xs[r dv]
    const int b0 = nb - 1 - first[s], b1 = last[s];
    V acc;
    float* af = reinterpret_cast<float*>(&acc);
#pragma unroll
    for (int e = 0; e < VEC; ++e) af[e] = 0.f;
    float accc = 0.f;

    for (int r0 = b0; r0 <= b1; r0 += SCAN) {
      // --- this round's blocks of segment s, in block order ------------
      unsigned hit = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = r0 + 4 * t + e;
        if (b <= b1 && b2s[b] == s) hit |= 1u << e;
      }
      int excl;
      const int nblk = block_exclusive(__popc(hit), excl, warp_tot);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (hit >> e & 1u) blk[excl++] = r0 + 4 * t + e;
      __syncthreads();
      const int nsl = nblk * bn;
      for (int w0 = 0; w0 < nsl; w0 += SW) {
        // --- the window's (row, weight), read once, coalesced ----------
        const int n = min(SW, nsl - w0);
        const int nst = (n + R - 1) / R;
        for (int i = t; i < nst * R; i += NT) {  // past n: no row
          const int si = w0 + i;
          const long long slot =
              i < n ? (long long)blk[si / bn] * bn + si % bn : 0;
          mrow[i] = i >= n ? -1 : perm ? perm[slot] : (int)slot;
          mw[i] = i < n && w ? w[slot] : 1.f;
        }
        __syncthreads();
        // --- the rows through this thread's ring, in slot order, with no
        // branch on the data: an empty slot's piece is zero-filled, and
        // its sum is formed and dropped by a select --------------------
        auto copy_stage = [&](int j) {
          if (j < nst && mine) {
            V* st = ring + (j % STAGES) * R * NT + t;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const int row = mrow[j * R + r];
              k2_cp_async(reinterpret_cast<float*>(st + r * NT),
                          reinterpret_cast<const float*>(
                              xs + (long long)max(row, 0) * dv),
                          row >= 0, VEC * 4);
            }
          }
          k2_cp_commit();
        };
#pragma unroll
        for (int j = 0; j < STAGES - 1; ++j) copy_stage(j);
        for (int j = 0; j < nst; ++j) {
          copy_stage(j + STAGES - 1);
          k2_cp_wait<STAGES - 1>();    // stage j landed (this thread's)
          const V* st = ring + (j % STAGES) * R * NT + t;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const bool live = mrow[j * R + r] >= 0;
            const float wv = mw[j * R + r];
            V a = acc;
            add_chain(a, st[r * NT], wv);
            keep_if(acc, a, live);
            const float ac = __fadd_rn(accc, wv);
            accc = live ? ac : accc;
          }
        }
        k2_cp_wait<0>();
        __syncthreads();               // the window's metadata is free
      }
    }
    if (mine) {
      float* out = sums + (long long)s * d + cu * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (cu * VEC + e < d) out[e] = af[e];
    }
    if (counts) cnt[s] = accc;
  }
}

constexpr size_t smem_bytes(int vec) {
  return sizeof(float) * vec * STAGES * R * NT + sizeof(int) * SW +
         sizeof(float) * SW + sizeof(int) * SCAN + sizeof(int) * NT / 32;
}

// The instantiations the launcher picks from, in variant order: 4-byte
// (VEC 1) and 16-byte (VEC 4) rows.
const decltype(&segment_sum_kernel<1>) FNS[] = {segment_sum_kernel<1>,
                                               segment_sum_kernel<4>};
const size_t SMEMS[] = {smem_bytes(1), smem_bytes(4)};

// The summing launch (after segment_ranges) over k segments of rows of d
// floats; aligned: x is 16-byte aligned. Persistent: as many blocks as are
// resident, at most one an item, striding over the k x nslice items (a
// segment's chain over a slice of cpt pieces of its columns).
cudaError_t plan(int k, int nb, int bn, int d, bool aligned, long long* p) {
  if (k < 0 || nb < 0 || bn < 1 || d < 0) return cudaErrorInvalidValue;
  const int vec = d % 4 == 0 && aligned ? 4 : 1;
  const int v = vec == 4 ? 1 : 0;
  cudaError_t err;
  const long long slots = k2_resident_blocks(FNS[v], NT, SMEMS[v], err);
  if (err != cudaSuccess) return err;
  const int dv = (d + vec - 1) / vec;
  const int nslice = max(1, (dv + NT - 2) / (NT - 1));  // a spare thread
  const int cpt = (dv + nslice - 1) / nslice;           // for the count
  const long long items = (long long)k * nslice;
  const long long grid = max(1LL, min(items, slots));
  k2_plan_init(p, grid, 1, 1, NT, SMEMS[v], v, v);
  p[K2P_ROWS] = k;
  p[K2P_COLS] = max(dv, 1);
  p[K2P_COL_EXTENT] = max(cpt, 1);
  p[K2P_INNER] = (long long)nb * bn;
  p[K2P_INNER_TILE] = R;
  p[K2P_STRIDE] = grid;
  p[K2P_RESIDENT] = slots;
  return cudaSuccess;
}
}  // namespace

K2_DESCRIBE(segment_sum_blocks, FNS, "VEC1,VEC4")

K2_EXPORT int k2_plan_segment_sum_blocks(int k, int nb, int bn, int d,
                                         int aligned, long long* out) {
  return (int)plan(k, nb, bn, d, aligned != 0, out);
}

// x: (rows, d) f32; w: (nb * bn,) f32 or null (weight 1); perm: (nb * bn,)
// i32 or null (slot s reads row s; -1: an empty slot); b2s: (nb,) i32,
// block -> segment, -1 (or >= k) for none; scratch: (1 + 3 k) i32;
// outputs sums (k, d) and cnt (k,) f32.
K2_EXPORT int k2_segment_sum_blocks(const float* x, const float* w,
                                    const int* perm, const int* b2s,
                                    int* scratch, float* sums, float* cnt,
                                    int k, int nb, int bn, int d,
                                    cudaStream_t stream) {
  if (k < 0 || nb < 0 || bn < 1 || d < 0) return (int)cudaErrorInvalidValue;
  if (k == 0) return (int)cudaGetLastError();
  cudaError_t err = cudaMemsetAsync(sums, 0, sizeof(float) * k * (size_t)d,
                                    stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(cnt, 0, sizeof(float) * k, stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch, 0, sizeof(int), stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch + 1, 0xff, sizeof(int) * 2 * (size_t)k,
                          stream);
  if (err != cudaSuccess) return (int)err;
  if (nb > 0)
    segment_ranges<<<(nb + 255) / 256, 256, 0, stream>>>(b2s, scratch, k, nb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  long long p[K2P_WORDS];
  err = plan(k, nb, bn, d, k2_aligned16(x), p);
  if (err != cudaSuccess) return (int)err;
  const int nslice = (int)((p[K2P_COLS] + p[K2P_COL_EXTENT] - 1) /
                           p[K2P_COL_EXTENT]);
  auto kern = FNS[p[K2P_VARIANT]];
  kern<<<k2_grid(p), (unsigned)p[K2P_THREADS], (size_t)p[K2P_SMEM],
         stream>>>(x, w, perm, b2s, scratch, sums, cnt, k, nb, bn, d, nslice,
                   (int)p[K2P_COL_EXTENT]);
  return (int)cudaGetLastError();
}
