// The time loops of the two attention-free mixers, each in one launch over
// a whole sequence: RWKV6's WKV recurrence (wkv6_scan) and Mamba2's SSD
// recurrence (ssd_scan), with the final state written in place.
//
// Not a port of a TPU kernel. The reference runs both recurrences as
// jax.lax.scan over time (src/repro/models/ssm.py, rwkv6_apply and
// mamba2_apply; rwkv6_decode and mamba2_decode are one step of the same
// body). As a loop of PyTorch ops a step costs about six launches, so a
// 32,768-token prefill of a 32-layer model would make millions of
// launches; here one launch a layer runs every step.
//
// Bound on an H100: at the served shapes (RWKV6-3B, 2 x 32,768 steps;
// Zamba2-7B, 2 x 16,384) the operations (5 FLOPs a state element a step in
// both, plus the rank-1 bonus term's 5 an element of a head's row in the
// WKV and 3 a state row in the SSD) take 0.8 and 1.1 ms a layer at 67
// TFLOP/s FP32 and the bytes (the f32 inputs and outputs once) 1.0 and 0.6
// ms at 3.35 TB/s; but step t + 1 needs step t's state, so a block walks its
// steps one after the other and the time is S times a step's latency (2.5
// and 1.5 us a step on an H100: 82 and 25 ms a layer). Design (simple
// first; a chunked, parallel-in-time form is later work):
// - wkv6_scan: one block a (batch, head); thread j owns column j of the
//   (dh x dh) state in registers, since out_j = sum_i r_i (S_ij + u_i k_i
//   v_j) and S_ij <- w_i S_ij + k_i v_j involve column j alone. A chunk of
//   T steps of r, k, v and w is staged in shared memory, coalesced, then
//   the T steps run with no barrier; the sum over i runs in ascending i.
// - ssd_scan: one block a (batch, head); thread p owns row p of the (P x N)
//   state in registers, since upd_pn = (dt x_p) B_n, S_pn <- decay S_pn +
//   upd_pn and y_p = sum_n S_pn C_n + D x_p involve row p alone. A chunk
//   of T steps of x, B, C, decay and dt is staged in shared memory; the
//   sum over n runs in ascending n.
// The state updates are rounded as the reference rounds them (a product,
// then a sum: __fmul_rn and __fadd_rn, never a fused multiply-add), so the
// state is the plain version's to the bit when its inputs are; the output
// sums differ from the plain version's only in their order.
#include <stdint.h>
#include "common.cuh"

namespace {

constexpr int WKV_STAGE = 2048;   // floats of each staged array a chunk

template <int MAXDH>
__global__ void __launch_bounds__(MAXDH < 32 ? 32 : MAXDH)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, float* __restrict__ state,
            float* __restrict__ out, int S, int H, int dh) {
  constexpr int T = WKV_STAGE / MAXDH;             // steps a chunk
  __shared__ float sr[T * MAXDH], sk[T * MAXDH], sv[T * MAXDH],
      sw[T * MAXDH];
  __shared__ float su[MAXDH];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j = threadIdx.x, nt = blockDim.x;
  const bool mine = j < dh;
  const size_t row = (size_t)H * dh;               // one step's stride
  const size_t base = (size_t)b * S * row + (size_t)h * dh;
  float* st = state + (size_t)bh * dh * dh;
  float col[MAXDH];
#pragma unroll
  for (int i = 0; i < MAXDH; ++i)
    col[i] = (mine && i < dh) ? st[(size_t)i * dh + j] : 0.f;
  for (int i = j; i < dh; i += nt) su[i] = u[(size_t)h * dh + i];
  for (int t0 = 0; t0 < S; t0 += T) {
    const int n = min(T, S - t0);
    __syncthreads();                               // the last chunk is read
    for (int e = j; e < n * dh; e += nt) {
      const int s = e / dh, i = e - s * dh;
      const size_t g = base + (size_t)(t0 + s) * row + i;
      sr[s * MAXDH + i] = r[g];
      sk[s * MAXDH + i] = k[g];
      sv[s * MAXDH + i] = v[g];
      sw[s * MAXDH + i] = w[g];
    }
    __syncthreads();
    if (!mine) continue;
    for (int s = 0; s < n; ++s) {
      const float vj = sv[s * MAXDH + j];
      const float* rs = sr + s * MAXDH;
      const float* ks = sk + s * MAXDH;
      const float* ws = sw + s * MAXDH;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < MAXDH; ++i) {
        if (i < dh) {
          const float kv = __fmul_rn(ks[i], vj);
          acc = __fmaf_rn(rs[i], __fadd_rn(col[i], __fmul_rn(su[i], kv)),
                          acc);
          col[i] = __fadd_rn(__fmul_rn(ws[i], col[i]), kv);
        }
      }
      out[base + (size_t)(t0 + s) * row + j] = acc;
    }
  }
  if (mine) {
#pragma unroll
    for (int i = 0; i < MAXDH; ++i)
      if (i < dh) st[(size_t)i * dh + j] = col[i];
  }
}

constexpr int SSD_T = 32;         // steps a chunk

template <int MAXN>
__global__ void __launch_bounds__(256) ssd_kernel(const float* __restrict__ x,
                           const float* __restrict__ Bm,
                           const float* __restrict__ Cm,
                           const float* __restrict__ decay,
                           const float* __restrict__ dt,
                           const float* __restrict__ D,
                           float* __restrict__ state, float* __restrict__ y,
                           int S, int H, int P, int N) {
  extern __shared__ __align__(16) float smem[];
  float* sx = smem;                                // [SSD_T][P]
  float* sb = sx + SSD_T * P;                      // [SSD_T][N]
  float* sc = sb + SSD_T * N;                      // [SSD_T][N]
  float* sdec = sc + SSD_T * N;                    // [SSD_T]
  float* sdt = sdec + SSD_T;                       // [SSD_T]
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int p = threadIdx.x, nt = blockDim.x;
  const bool mine = p < P;
  const size_t xrow = (size_t)H * P;               // x's step stride
  const size_t xbase = (size_t)b * S * xrow + (size_t)h * P;
  const size_t bcbase = (size_t)b * S * N;
  const size_t hbase = (size_t)b * S * H + h;
  float* st = state + ((size_t)bh * P + (mine ? p : 0)) * N;
  const float dp = D[h];
  float srow[MAXN];
#pragma unroll
  for (int n = 0; n < MAXN; ++n) srow[n] = (mine && n < N) ? st[n] : 0.f;
  for (int t0 = 0; t0 < S; t0 += SSD_T) {
    const int cnt = min(SSD_T, S - t0);
    __syncthreads();
    for (int e = p; e < cnt * P; e += nt) {
      const int s = e / P, q = e - s * P;
      sx[e] = x[xbase + (size_t)(t0 + s) * xrow + q];
    }
    for (int e = p; e < cnt * N; e += nt) {
      sb[e] = Bm[bcbase + (size_t)t0 * N + e];
      sc[e] = Cm[bcbase + (size_t)t0 * N + e];
    }
    for (int e = p; e < cnt; e += nt) {
      sdec[e] = decay[hbase + (size_t)(t0 + e) * H];
      sdt[e] = dt[hbase + (size_t)(t0 + e) * H];
    }
    __syncthreads();
    if (!mine) continue;
    for (int s = 0; s < cnt; ++s) {
      const float xp = sx[s * P + p];
      const float dx = __fmul_rn(sdt[s], xp);
      const float dec = sdec[s];
      const float* bs = sb + s * N;
      const float* cs = sc + s * N;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < MAXN; ++n) {
        if (n < N) {
          srow[n] = __fadd_rn(__fmul_rn(dec, srow[n]), __fmul_rn(dx, bs[n]));
          acc = __fmaf_rn(srow[n], cs[n], acc);
        }
      }
      y[xbase + (size_t)(t0 + s) * xrow + p] = __fadd_rn(acc,
                                                         __fmul_rn(dp, xp));
    }
  }
  if (mine) {
#pragma unroll
    for (int n = 0; n < MAXN; ++n)
      if (n < N) st[n] = srow[n];
  }
}

template <int MAXDH>
int launch_wkv6(const float* r, const float* k, const float* v,
                const float* w, const float* u, float* state, float* out,
                int B, int S, int H, int dh, cudaStream_t stream) {
  const int nt = ((dh + 31) / 32) * 32;
  wkv6_kernel<MAXDH><<<B * H, nt, 0, stream>>>(r, k, v, w, u, state, out, S,
                                              H, dh);
  return (int)cudaGetLastError();
}

template <int MAXN>
int launch_ssd(const float* x, const float* Bm, const float* Cm,
               const float* decay, const float* dt, const float* D,
               float* state, float* y, int B, int S, int H, int P, int N,
               cudaStream_t stream) {
  const int nt = ((P + 31) / 32) * 32;
  const size_t smem = sizeof(float) * ((size_t)SSD_T * (P + 2 * N) + 2 * SSD_T);
  cudaError_t err = k2_set_smem(ssd_kernel<MAXN>, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<MAXN><<<B * H, nt, smem, stream>>>(x, Bm, Cm, decay, dt, D,
                                                 state, y, S, H, P, N);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w: (B, S, H, dh) f32; u: (H, dh) f32; state: (B, H, dh, dh) f32,
// read as the initial state and overwritten with the final one; out: (B, S,
// H, dh) f32. dh <= 64 (RWKV6 runs 16 and 64).
K2_EXPORT int k2_wkv6_scan(const float* r, const float* k, const float* v,
                           const float* w, const float* u, float* state,
                           float* out, int B, int S, int H, int dh,
                           cudaStream_t stream) {
  if (B < 0 || S < 0 || H < 1 || dh < 1 || dh > 64)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  if (dh <= 16)
    return launch_wkv6<16>(r, k, v, w, u, state, out, B, S, H, dh, stream);
  return launch_wkv6<64>(r, k, v, w, u, state, out, B, S, H, dh, stream);
}

// x: (B, S, H, P) f32; Bm, Cm: (B, S, N) f32; decay, dt: (B, S, H) f32; D:
// (H,) f32; state: (B, H, P, N) f32, read as the initial state and
// overwritten with the final one; y: (B, S, H, P) f32. P <= 256, N <= 64
// (Mamba2 runs P 32 with N 8, and P 224 with N 64).
K2_EXPORT int k2_ssd_scan(const float* x, const float* Bm, const float* Cm,
                          const float* decay, const float* dt, const float* D,
                          float* state, float* y, int B, int S, int H, int P,
                          int N, cudaStream_t stream) {
  if (B < 0 || S < 0 || H < 1 || P < 1 || P > 256 || N < 1 || N > 64)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  if (N <= 16)
    return launch_ssd<16>(x, Bm, Cm, decay, dt, D, state, y, B, S, H, P, N,
                          stream);
  return launch_ssd<64>(x, Bm, Cm, decay, dt, D, state, y, B, S, H, P, N,
                        stream);
}
