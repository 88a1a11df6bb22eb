// K6: decode attention of one query row over its p selected blocks of a
// cluster-major KV cache (k²-attention), returning the online-softmax state.
//
// Replaces the Pallas TPU kernel src/repro/kernels/cluster_attend.py
// (cluster_attend / _kernel): for each (batch, q-head) row, logits
// q.k * dh^-0.5 in f32 over the valid rows of its p selected (cap, dh)
// blocks, a running max, sum and weighted accumulator carried across
// blocks, and a fully masked block keeps the previous statistics. The TPU
// kernel divides acc by max(l, 1e-30) in its flush; this kernel writes
// (m, l, acc) instead, so that the decode path can merge the recent-token
// ring and the token being decoded into the same softmax (the reference's
// _cm_partial, attention.py, which this kernel replaces on the decode path).
//
// Bound on an H100: bytes. Each valid K and V row is read once per row
// that selects its block, one dot product and one axpy of dh values per row
// read: 4 dh FLOPs against 2 dh * sizeof(T) bytes. The least time is the
// bytes of the distinct selected live rows of K and V, plus q and the
// outputs, over 3.35 TB/s. Validity comes either as the TPU kernel's
// (rows, cap) mask or as per-block sizes (slot < size); with sizes the row
// loop stops at the block's size, so a block filled to 32 of its 512 slots
// costs 32 rows of traffic, not the whole capacity the TPU kernel streams.
//
// Design: one block of 128 threads per query row, looping over its p
// blocks, and within a block over tiles of TR = 64 rows. A tile of K and V
// (TR x dh, contiguous in the table) is staged into shared memory with
// 16-byte loads where the layout allows; each warp computes the logits of
// every fourth row (lanes stride dh, shuffle sum); warp 0 takes the tile's
// max, the weights exp(logit - m) and the running sum; then every thread
// updates the accumulator of its own dh columns (registers, at most two
// per thread for dh <= 256) from the staged V tile. Tiles with no valid
// row are skipped, which is the TPU kernel's masked-block guard. Shared
// memory: dh + TR floats plus 2 TR dh elements (33 KB at bf16, dh = 128).
//
// A fast version would split each row's p blocks over several CUDA blocks
// with a combine pass (flash-decoding), since 64 rows leave most of the 132
// SMs idle at the decode shape, and would double-buffer the tiles with TMA
// loads and an mbarrier so that the next tile streams while this one is
// reduced.
#include <math.h>
#include <stdint.h>
#include <cuda_bf16.h>
#include "common.cuh"

namespace {
constexpr int NT = 128;
constexpr int NW = NT / 32;
constexpr int TR = 64;
constexpr int MAX_DH = 256;
constexpr int EPT = MAX_DH / NT;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_allmax(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Copy n contiguous elements from global to shared memory, by 16 bytes
// when both ends allow it.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int n) {
  const bool vec = (reinterpret_cast<uintptr_t>(src) % 16 == 0) &&
                   ((n * sizeof(T)) % 16 == 0);
  if (vec) {
    const int nv = (int)(n * sizeof(T) / 16);
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < nv; i += NT) d[i] = __ldg(s + i);
  } else {
    for (int i = threadIdx.x; i < n; i += NT) dst[i] = src[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
cluster_attend_kernel(const float* __restrict__ q, const T* __restrict__ kt,
                      const T* __restrict__ vt, const int* __restrict__ vs,
                      int by_sizes, const int* __restrict__ sel,
                      float* __restrict__ m_out, float* __restrict__ l_out,
                      float* __restrict__ acc_out, int rows, int cap, int dh,
                      int p, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dh4 = (dh + 3) & ~3;
  float* qs = reinterpret_cast<float*>(smem);
  float* wl = qs + dh4;                                   // TR logits/weights
  T* ks = reinterpret_cast<T*>(wl + TR);
  T* vsm = ks + (size_t)TR * dh;
  __shared__ float s_corr;
  __shared__ int s_live;

  const size_t row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < dh; e += NT) qs[e] = q[row * dh + e];
  float acc[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;        // meaningful in warp 0

  for (int j = 0; j < p; ++j) {
    const int id = sel[row * p + j];
    if (id < 0 || id >= rows) continue;                  // uniform
    const int n = by_sizes ? min(max(vs[id], 0), cap) : cap;
    const int* vrow = by_sizes ? nullptr : vs + (size_t)id * cap;
    const T* kb = kt + (size_t)id * cap * dh;
    const T* vb = vt + (size_t)id * cap * dh;
    for (int r0 = 0; r0 < n; r0 += TR) {
      const int nr = min(TR, n - r0);
      __syncthreads();                 // the last tile's readers are done
      stage(ks, kb + (size_t)r0 * dh, nr * dh);
      stage(vsm, vb + (size_t)r0 * dh, nr * dh);
      __syncthreads();
      for (int r = warp; r < nr; r += NW) {
        const T* kr = ks + (size_t)r * dh;
        float s = 0.f;
        for (int e = lane; e < dh; e += 32) s = fmaf(qs[e], to_f(kr[e]), s);
        s = warp_allsum(s);
        if (lane == 0) {
          const bool ok = vrow == nullptr || vrow[r0 + r] > 0;
          wl[r] = ok ? s * scale : -INFINITY;
        }
      }
      __syncthreads();
      if (warp == 0) {
        const float x0 = lane < nr ? wl[lane] : -INFINITY;
        const float x1 = lane + 32 < nr ? wl[lane + 32] : -INFINITY;
        const float mt = warp_allmax(fmaxf(x0, x1));
        if (mt == -INFINITY) {
          if (lane == 0) s_live = 0;   // a fully masked tile: keep the stats
        } else {
          const float m_new = fmaxf(m, mt);
          const float corr = m == -INFINITY ? 0.f : expf(m - m_new);
          const float w0 = x0 == -INFINITY ? 0.f : expf(x0 - m_new);
          const float w1 = x1 == -INFINITY ? 0.f : expf(x1 - m_new);
          if (lane < nr) wl[lane] = w0;
          if (lane + 32 < nr) wl[lane + 32] = w1;
          l = l * corr + warp_allsum(w0 + w1);
          m = m_new;
          if (lane == 0) {
            s_corr = corr;
            s_live = 1;
          }
        }
      }
      __syncthreads();
      if (s_live) {
        const float corr = s_corr;
#pragma unroll
        for (int i = 0; i < EPT; ++i) {
          const int e = tid + i * NT;
          if (e < dh) {
            float a = acc[i] * corr;
            for (int r = 0; r < nr; ++r)
              a = fmaf(wl[r], to_f(vsm[(size_t)r * dh + e]), a);
            acc[i] = a;
          }
        }
      }
    }
  }
  if (tid == 0) {
    m_out[row] = m;
    l_out[row] = l;
  }
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = tid + i * NT;
    if (e < dh) acc_out[row * dh + e] = acc[i];
  }
}

template <typename T>
cudaError_t launch(const float* q, const void* kt, const void* vt,
                   const int* vs, int by_sizes, const int* sel, float* m,
                   float* l, float* acc, int bh, int rows, int cap, int dh,
                   int p, float scale, cudaStream_t stream) {
  const size_t smem = ((dh + 3) & ~3) * sizeof(float) + TR * sizeof(float) +
                      2 * (size_t)TR * dh * sizeof(T);
  cudaError_t err = k2_set_smem(cluster_attend_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  cluster_attend_kernel<T><<<bh, NT, smem, stream>>>(
      q, static_cast<const T*>(kt), static_cast<const T*>(vt), vs, by_sizes,
      sel, m, l, acc, rows, cap, dh, p, scale);
  return cudaGetLastError();
}
}  // namespace

// q: (bh, dh) f32; kt, vt: (rows, cap, dh) bf16 (table_bf16 = 1) or f32;
// vs: (rows,) int32 sizes when by_sizes, else (rows, cap) int32 validity;
// sel: (bh, p) int32 table rows (rows outside [0, rows) are skipped);
// outputs m, l (bh,) f32 and acc (bh, dh) f32. dh <= 256.
K2_EXPORT int k2_cluster_attend(const float* q, const void* kt,
                                const void* vt, const int* vs, int by_sizes,
                                const int* sel, float* m, float* l,
                                float* acc, int bh, int rows, int cap, int dh,
                                int p, int table_bf16, float scale,
                                cudaStream_t stream) {
  if (bh < 0 || rows < 0 || cap < 0 || dh < 1 || dh > MAX_DH || p < 0)
    return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaGetLastError();
  return table_bf16
             ? (int)launch<__nv_bfloat16>(q, kt, vt, vs, by_sizes, sel, m, l,
                                          acc, bh, rows, cap, dh, p, scale,
                                          stream)
             : (int)launch<float>(q, kt, vt, vs, by_sizes, sel, m, l, acc, bh,
                                  rows, cap, dh, p, scale, stream);
}
