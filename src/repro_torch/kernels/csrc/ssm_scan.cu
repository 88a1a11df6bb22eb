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
// sums differ from the plain version's only in their order. When the
// forward is asked for checkpoints (training), it also writes the state
// before every C-th step.
//
// The gradients (wkv6_scan_bwd, ssd_scan_bwd) stand in for jax.grad of the
// same lax.scan. Bound: the reverse recurrence does 17 (WKV) and 11 (SSD)
// FLOPs a state element a step, 0.4 and 0.3 ms a layer at RWKV6-3B's and
// Zamba2-7B's training shape (2 x 4,096 steps), above their bytes (the
// inputs, checkpoints and gradients once); but again each step needs the
// next one's dState, so the time is S steps' latency. Design (simple
// first): one block a (batch, head) walks the chunks of C steps from the
// last; for each it recomputes the states before the chunk's steps from
// the forward's checkpoint (the forward's own rounded ops, so they are the
// forward's states to the bit) into a scratch slab in device memory, then
// runs the chunk's steps in reverse. A thread owns a ROW of the state and
// of dState, so the sums over the second index stay in the thread; the
// sums across rows (WKV's dv, SSD's dB, dC, ddecay, ddt) go through shared
// memory (WKV) or warp shuffles and then the warps in order (SSD), each in
// a fixed order, so a launch is bit-identical to itself.
#include <stdint.h>
#include "common.cuh"

namespace {

constexpr int WKV_STAGE = 2048;   // floats of each staged array a chunk

template <int MAXDH>
__global__ void __launch_bounds__(MAXDH < 32 ? 32 : MAXDH)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, float* __restrict__ state,
            float* __restrict__ out, float* __restrict__ ckpt, int S, int H,
            int dh, int C) {
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
      const int t = t0 + s;
      if (ckpt != nullptr && t % C == 0) {         // the state before step t
        float* cp = ckpt + ((size_t)bh * ((S + C - 1) / C) + t / C) * dh * dh;
#pragma unroll
        for (int i = 0; i < MAXDH; ++i)
          if (i < dh) cp[(size_t)i * dh + j] = col[i];
      }
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
                           float* __restrict__ ckpt, int S, int H, int P,
                           int N, int C) {
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
      const int t = t0 + s;
      if (ckpt != nullptr && t % C == 0) {         // the state before step t
        float* cp = ckpt + (((size_t)bh * ((S + C - 1) / C) + t / C) * P + p)
                    * N;
#pragma unroll
        for (int n = 0; n < MAXN; ++n)
          if (n < N) cp[n] = srow[n];
      }
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

// The forward instantiations, in variant order: MAXDH (wkv6) or MAXN (ssd)
// 16 or 64.
const decltype(&wkv6_kernel<16>) WKV_FNS[] = {wkv6_kernel<16>, wkv6_kernel<64>};
const decltype(&ssd_kernel<16>) SSD_FNS[] = {ssd_kernel<16>, ssd_kernel<64>};

// One CUDA block a (batch, head), a thread a state column (wkv6: dh, ssd:
// P), rounded up to whole warps; each block walks the S steps (ssd: in
// chunks of SSD_T staged in shared memory).
void plan_scan(int B, int H, int S, int cols, int step_tile, size_t smem,
               int variant, long long* p) {
  k2_plan_init(p, (long long)B * H, 1, 1, ((cols + 31) / 32) * 32, smem,
               variant, -1);
  p[K2P_ROWS] = (long long)B * H;
  p[K2P_INNER] = S;
  p[K2P_INNER_TILE] = step_tile;
}

void plan_wkv6(int B, int S, int H, int dh, long long* p) {
  plan_scan(B, H, S, dh, 1, 0, dh <= 16 ? 0 : 1, p);
}

void plan_ssd(int B, int S, int H, int P, int N, long long* p) {
  plan_scan(B, H, S, P, SSD_T,
            sizeof(float) * ((size_t)SSD_T * (P + 2 * N) + 2 * SSD_T),
            N <= 16 ? 0 : 1, p);
}

int launch_wkv6(const long long* p, const float* r, const float* k,
                const float* v, const float* w, const float* u, float* state,
                float* out, float* ckpt, int S, int H, int dh, int C,
                cudaStream_t stream) {
  auto kern = WKV_FNS[p[K2P_VARIANT]];
  kern<<<k2_grid(p), (unsigned)p[K2P_THREADS], (size_t)p[K2P_SMEM],
         stream>>>(r, k, v, w, u, state, out, ckpt, S, H, dh, C);
  return (int)cudaGetLastError();
}

int launch_ssd(const long long* p, const float* x, const float* Bm,
               const float* Cm, const float* decay, const float* dt,
               const float* D, float* state, float* y, float* ckpt, int S,
               int H, int P, int N, int C, cudaStream_t stream) {
  auto kern = SSD_FNS[p[K2P_VARIANT]];
  cudaError_t err = k2_set_smem(kern, (size_t)p[K2P_SMEM]);
  if (err != cudaSuccess) return (int)err;
  kern<<<k2_grid(p), (unsigned)p[K2P_THREADS], (size_t)p[K2P_SMEM],
         stream>>>(x, Bm, Cm, decay, dt, D, state, y, ckpt, S, H, P, N, C);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward. Both kernels run one block a (batch, head), walk the chunks of C
// steps from the last to the first, and in each chunk (1) recompute the
// states before each of its steps from the checkpoint the forward saved at
// its start (the forward's own products and sums, each rounded, so the
// states are the forward's to the bit) into a scratch slab in device memory,
// then (2) run the reverse-time recurrence of dState over the chunk's steps.
// A thread owns a ROW of the state here (the forward owns a column in
// wkv6), so every sum over the state's second index stays in the thread.
// ---------------------------------------------------------------------------

// wkv6_scan_bwd. Thread i owns row i of S (dh x dh) and of G = dL/dS. With
// G the gradient of the state after step t, step t in reverse is
//   dr_i  = sum_j do_j (S_ij + u_i k_i v_j)
//   dkv_ij = r_i u_i do_j + G_ij;  dk_i = sum_j dkv_ij v_j;
//   dv_j  = sum_i dkv_ij k_i      (across threads: through shared memory)
//   dw_i  = sum_j G_ij S_ij;  du_i += r_i k_i sum_j v_j do_j
//   G_ij <- r_i do_j + w_i G_ij
// du is summed over the steps in the thread and written per (batch, head);
// the wrapper sums it over the batch.
template <int MAXDH>
__global__ void __launch_bounds__(MAXDH < 32 ? 32 : MAXDH)
wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ ckpt,
                const float* __restrict__ dout,
                const float* __restrict__ dfinal, float* __restrict__ scratch,
                float* __restrict__ dr, float* __restrict__ dk,
                float* __restrict__ dv, float* __restrict__ dw,
                float* __restrict__ du_part, float* __restrict__ dstate0,
                int S, int H, int dh, int C) {
  extern __shared__ __align__(16) float smem[];
  float* sr = smem;                                // [C][MAXDH] each
  float* sk = sr + C * MAXDH;
  float* sv = sk + C * MAXDH;
  float* sw = sv + C * MAXDH;
  float* sdo = sw + C * MAXDH;
  float* red = sdo + C * MAXDH;                    // [MAXDH][MAXDH + 1]
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int i = threadIdx.x, nt = blockDim.x;
  const bool mine = i < dh;
  const size_t row = (size_t)H * dh;
  const size_t base = (size_t)b * S * row + (size_t)h * dh;
  const size_t sq = (size_t)dh * dh;
  const int nck = (S + C - 1) / C;
  const float ui = mine ? u[(size_t)h * dh + i] : 0.f;
  float* scr = scratch + (size_t)bh * C * sq;      // [s][j][i]
  float G[MAXDH];
#pragma unroll
  for (int j = 0; j < MAXDH; ++j)
    G[j] = (mine && j < dh && dfinal != nullptr)
               ? dfinal[bh * sq + (size_t)i * dh + j] : 0.f;
  float du = 0.f;
  for (int c = nck - 1; c >= 0; --c) {
    const int t0 = c * C, n = min(C, S - t0);
    __syncthreads();                               // the last chunk is read
    for (int e = i; e < n * dh; e += nt) {
      const int s = e / dh, q = e - s * dh;
      const size_t g = base + (size_t)(t0 + s) * row + q;
      sr[s * MAXDH + q] = r[g];
      sk[s * MAXDH + q] = k[g];
      sv[s * MAXDH + q] = v[g];
      sw[s * MAXDH + q] = w[g];
      sdo[s * MAXDH + q] = dout[g];
    }
    __syncthreads();
    if (mine) {                                    // the chunk's states
      float Srow[MAXDH];
      const float* cp = ckpt + ((size_t)bh * nck + c) * sq + (size_t)i * dh;
#pragma unroll
      for (int j = 0; j < MAXDH; ++j) Srow[j] = j < dh ? cp[j] : 0.f;
      for (int s = 0; s < n; ++s) {
        const float ki = sk[s * MAXDH + i], wi = sw[s * MAXDH + i];
#pragma unroll
        for (int j = 0; j < MAXDH; ++j) {
          if (j < dh) {
            scr[((size_t)s * dh + j) * dh + i] = Srow[j];
            Srow[j] = __fadd_rn(__fmul_rn(wi, Srow[j]),
                                __fmul_rn(ki, sv[s * MAXDH + j]));
          }
        }
      }
    }
    for (int s = n - 1; s >= 0; --s) {
      const size_t g = base + (size_t)(t0 + s) * row + i;
      if (mine) {
        const float ri = sr[s * MAXDH + i], ki = sk[s * MAXDH + i];
        const float wi = sw[s * MAXDH + i];
        const float rui = ri * ui;
        const float* vs = sv + s * MAXDH;
        const float* ds = sdo + s * MAXDH;
        float drr = 0.f, dww = 0.f, dkk = 0.f, vdo = 0.f;
#pragma unroll
        for (int j = 0; j < MAXDH; ++j) {
          if (j < dh) {
            const float sij = scr[((size_t)s * dh + j) * dh + i];
            const float vj = vs[j], doj = ds[j];
            drr = fmaf(doj, sij + ui * (ki * vj), drr);
            dww = fmaf(G[j], sij, dww);
            const float dkv = fmaf(rui, doj, G[j]);
            dkk = fmaf(dkv, vj, dkk);
            red[i * (MAXDH + 1) + j] = dkv * ki;
            vdo = fmaf(vj, doj, vdo);
            G[j] = fmaf(ri, doj, wi * G[j]);
          }
        }
        du = fmaf(ri * ki, vdo, du);
        dr[g] = drr;
        dk[g] = dkk;
        dw[g] = dww;
      }
      __syncthreads();
      if (mine) {                                  // thread i sums column i
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < MAXDH; ++q)
          if (q < dh) acc += red[q * (MAXDH + 1) + i];
        dv[g] = acc;
      }
      __syncthreads();
    }
  }
  if (mine) {
#pragma unroll
    for (int j = 0; j < MAXDH; ++j)
      if (j < dh) dstate0[bh * sq + (size_t)i * dh + j] = G[j];
    du_part[(size_t)bh * dh + i] = du;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ssd_scan_bwd. Thread p owns row p of S (P x N) and of G. With G the
// gradient of the state after step t (from the later steps), and S, S' the
// states before and after step t, step t in reverse is
//   Gt_pn = G_pn + dy_p C_n           (dL/dS' in all)
//   dC_n  = sum_p dy_p S'_pn          dB_n = sum_p (dt x_p) Gt_pn
//   e_p   = sum_n Gt_pn B_n;  dx_p = dt e_p + D dy_p
//   ddt   = sum_p x_p e_p             ddecay = sum_pn Gt_pn S_pn
//   G_pn <- decay Gt_pn;  dD += sum_p dy_p x_p
// The sums over p run across threads: a warp's lanes by shuffles, then the
// warps in order through shared memory. dB and dC are written per (batch,
// head) and dD per (batch, head); the wrapper sums them over the heads and
// the batch, which share them.
template <int MAXN>
__global__ void __launch_bounds__(256)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ decay,
               const float* __restrict__ dt, const float* __restrict__ D,
               const float* __restrict__ ckpt, const float* __restrict__ dy,
               const float* __restrict__ dfinal, float* __restrict__ scratch,
               float* __restrict__ dx, float* __restrict__ dB_part,
               float* __restrict__ dC_part, float* __restrict__ ddecay,
               float* __restrict__ ddt, float* __restrict__ dD_part,
               float* __restrict__ dstate0, int S, int H, int P, int N,
               int C) {
  extern __shared__ __align__(16) float smem[];
  float* sx = smem;                                // [C][P]
  float* sdy = sx + C * P;                         // [C][P]
  float* sb = sdy + C * P;                         // [C][N]
  float* sc = sb + C * N;                          // [C][N]
  float* sdec = sc + C * N;                        // [C]
  float* sdt = sdec + C;                           // [C]
  float* red = sdt + C;                            // [8][2 MAXN + 2]
  constexpr int RW = 2 * MAXN + 2;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int p = threadIdx.x, nt = blockDim.x;
  const int lane = p & 31, warp = p >> 5, nw = nt >> 5;
  const bool mine = p < P;
  const size_t xrow = (size_t)H * P;
  const size_t xbase = (size_t)b * S * xrow + (size_t)h * P;
  const size_t bcbase = (size_t)b * S * N;
  const size_t hbase = (size_t)b * S * H + h;
  const size_t sq = (size_t)P * N;
  const int nck = (S + C - 1) / C;
  const float dp = D[h];
  float* scr = scratch + (size_t)bh * (C + 1) * sq;    // [s][n][p]
  float G[MAXN];
#pragma unroll
  for (int n = 0; n < MAXN; ++n)
    G[n] = (mine && n < N && dfinal != nullptr)
               ? dfinal[bh * sq + (size_t)p * N + n] : 0.f;
  float dD = 0.f;
  for (int c = nck - 1; c >= 0; --c) {
    const int t0 = c * C, cnt = min(C, S - t0);
    __syncthreads();
    for (int e = p; e < cnt * P; e += nt) {
      const int s = e / P, q = e - s * P;
      const size_t g = xbase + (size_t)(t0 + s) * xrow + q;
      sx[e] = x[g];
      sdy[e] = dy[g];
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
    if (mine) {                                    // the chunk's states
      float Srow[MAXN];
      const float* cp = ckpt + (((size_t)bh * nck + c) * P + p) * N;
#pragma unroll
      for (int n = 0; n < MAXN; ++n) Srow[n] = n < N ? cp[n] : 0.f;
      for (int s = 0; s <= cnt; ++s) {
#pragma unroll
        for (int n = 0; n < MAXN; ++n)
          if (n < N) scr[((size_t)s * N + n) * P + p] = Srow[n];
        if (s == cnt) break;
        const float dxs = __fmul_rn(sdt[s], sx[s * P + p]);
        const float dec = sdec[s];
#pragma unroll
        for (int n = 0; n < MAXN; ++n)
          if (n < N)
            Srow[n] = __fadd_rn(__fmul_rn(dec, Srow[n]),
                                __fmul_rn(dxs, sb[s * N + n]));
      }
    }
    for (int s = cnt - 1; s >= 0; --s) {
      const int t = t0 + s;
      const float xp = mine ? sx[s * P + p] : 0.f;
      const float dyp = mine ? sdy[s * P + p] : 0.f;
      const float dts = sdt[s], dec = sdec[s];
      const float dxs = dts * xp;
      float e = 0.f, cdec = 0.f;
#pragma unroll
      for (int n = 0; n < MAXN; ++n) {
        if (n < N) {
          float snew = 0.f, sold = 0.f;
          if (mine) {
            snew = scr[((size_t)(s + 1) * N + n) * P + p];
            sold = scr[((size_t)s * N + n) * P + p];
          }
          const float gt = fmaf(dyp, sc[s * N + n], G[n]);
          const float a = warp_sum(dyp * snew);
          const float bb = warp_sum(dxs * gt);
          if (lane == 0) {
            red[warp * RW + n] = a;
            red[warp * RW + MAXN + n] = bb;
          }
          e = fmaf(gt, sb[s * N + n], e);
          cdec = fmaf(gt, sold, cdec);
          G[n] = dec * gt;
        }
      }
      if (mine) dx[xbase + (size_t)t * xrow + p] = fmaf(dts, e, dp * dyp);
      dD = fmaf(dyp, xp, dD);
      const float sdd = warp_sum(cdec), sdtt = warp_sum(xp * e);
      if (lane == 0) {
        red[warp * RW + 2 * MAXN] = sdd;
        red[warp * RW + 2 * MAXN + 1] = sdtt;
      }
      __syncthreads();
      for (int q = p; q < 2 * N + 2; q += nt) {    // the warps, in order
        const int col = q < N ? q : q < 2 * N ? MAXN + q - N
                                              : 2 * MAXN + q - 2 * N;
        float acc = 0.f;
        for (int wi = 0; wi < nw; ++wi) acc += red[wi * RW + col];
        const size_t o = ((size_t)bh * S + t) * N;
        if (q < N) dC_part[o + q] = acc;
        else if (q < 2 * N) dB_part[o + q - N] = acc;
        else if (q == 2 * N) ddecay[hbase + (size_t)t * H] = acc;
        else ddt[hbase + (size_t)t * H] = acc;
      }
      __syncthreads();
    }
  }
  if (mine) {
#pragma unroll
    for (int n = 0; n < MAXN; ++n)
      if (n < N) dstate0[bh * sq + (size_t)p * N + n] = G[n];
  }
  const float sD = warp_sum(dD);
  __syncthreads();
  if (lane == 0) red[warp] = sD;
  __syncthreads();
  if (p == 0) {
    float acc = 0.f;
    for (int wi = 0; wi < nw; ++wi) acc += red[wi];
    dD_part[bh] = acc;
  }
}

// The backward instantiations, in variant order: MAXDH (wkv6) or MAXN
// (ssd) 16 or 64. One CUDA block a (batch, head), a thread a state row,
// walking the chunks of C steps from the last.
const decltype(&wkv6_bwd_kernel<16>) WKV_BWD_FNS[] = {wkv6_bwd_kernel<16>,
                                                      wkv6_bwd_kernel<64>};
const decltype(&ssd_bwd_kernel<16>) SSD_BWD_FNS[] = {ssd_bwd_kernel<16>,
                                                     ssd_bwd_kernel<64>};

void plan_wkv6_bwd(int B, int S, int H, int dh, int C, long long* p) {
  const int maxdh = dh <= 16 ? 16 : 64;
  plan_scan(B, H, S, dh, C,
            sizeof(float) * (5 * (size_t)C * maxdh + maxdh * (maxdh + 1)),
            maxdh == 16 ? 0 : 1, p);
}

void plan_ssd_bwd(int B, int S, int H, int P, int N, int C, long long* p) {
  const int maxn = N <= 16 ? 16 : 64;
  plan_scan(B, H, S, P, C,
            sizeof(float) * ((size_t)C * (2 * P + 2 * N + 2) +
                             8 * (2 * maxn + 2)),
            maxn == 16 ? 0 : 1, p);
}
}  // namespace

K2_DESCRIBE(wkv6_scan, WKV_FNS, "MAXDH16,MAXDH64")
K2_DESCRIBE(ssd_scan, SSD_FNS, "MAXN16,MAXN64")
K2_DESCRIBE(wkv6_scan_bwd, WKV_BWD_FNS, "MAXDH16,MAXDH64")
K2_DESCRIBE(ssd_scan_bwd, SSD_BWD_FNS, "MAXN16,MAXN64")

K2_EXPORT int k2_plan_wkv6_scan(int B, int S, int H, int dh, long long* out) {
  if (B < 0 || S < 0 || H < 1 || dh < 1 || dh > 64)
    return (int)cudaErrorInvalidValue;
  plan_wkv6(B, S, H, dh, out);
  return 0;
}

K2_EXPORT int k2_plan_ssd_scan(int B, int S, int H, int P, int N,
                               long long* out) {
  if (B < 0 || S < 0 || H < 1 || P < 1 || P > 256 || N < 1 || N > 64)
    return (int)cudaErrorInvalidValue;
  plan_ssd(B, S, H, P, N, out);
  return 0;
}

K2_EXPORT int k2_plan_wkv6_scan_bwd(int B, int S, int H, int dh, int C,
                                    long long* out) {
  if (B < 0 || S < 1 || H < 1 || dh < 1 || dh > 64 || C < 1)
    return (int)cudaErrorInvalidValue;
  plan_wkv6_bwd(B, S, H, dh, C, out);
  return 0;
}

K2_EXPORT int k2_plan_ssd_scan_bwd(int B, int S, int H, int P, int N, int C,
                                   long long* out) {
  if (B < 0 || S < 1 || H < 1 || P < 1 || P > 256 || N < 1 || N > 64 ||
      C < 1)
    return (int)cudaErrorInvalidValue;
  plan_ssd_bwd(B, S, H, P, N, C, out);
  return 0;
}

// r, k, v, w: (B, S, H, dh) f32; u: (H, dh) f32; state: (B, H, dh, dh) f32,
// read as the initial state and overwritten with the final one; out: (B, S,
// H, dh) f32. dh <= 64 (RWKV6 runs 16 and 64). ckpt: null, or (B, H,
// ceil(S / C), dh, dh) f32, which takes the state before every step t with
// t % C == 0 (the backward's checkpoints).
K2_EXPORT int k2_wkv6_scan(const float* r, const float* k, const float* v,
                           const float* w, const float* u, float* state,
                           float* out, float* ckpt, int B, int S, int H,
                           int dh, int C, cudaStream_t stream) {
  if (B < 0 || S < 0 || H < 1 || dh < 1 || dh > 64 ||
      (ckpt != nullptr && C < 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  long long p[K2P_WORDS];
  plan_wkv6(B, S, H, dh, p);
  return launch_wkv6(p, r, k, v, w, u, state, out, ckpt, S, H, dh, C,
                     stream);
}

// x: (B, S, H, P) f32; Bm, Cm: (B, S, N) f32; decay, dt: (B, S, H) f32; D:
// (H,) f32; state: (B, H, P, N) f32, read as the initial state and
// overwritten with the final one; y: (B, S, H, P) f32. P <= 256, N <= 64
// (Mamba2 runs P 32 with N 8, and P 224 with N 64). ckpt: null, or (B, H,
// ceil(S / C), P, N) f32, as k2_wkv6_scan's.
K2_EXPORT int k2_ssd_scan(const float* x, const float* Bm, const float* Cm,
                          const float* decay, const float* dt, const float* D,
                          float* state, float* y, float* ckpt, int B, int S,
                          int H, int P, int N, int C, cudaStream_t stream) {
  if (B < 0 || S < 0 || H < 1 || P < 1 || P > 256 || N < 1 || N > 64 ||
      (ckpt != nullptr && C < 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  long long p[K2P_WORDS];
  plan_ssd(B, S, H, P, N, p);
  return launch_ssd(p, x, Bm, Cm, decay, dt, D, state, y, ckpt, S, H, P, N,
                    C, stream);
}

// The gradients of k2_wkv6_scan over S >= 1 steps from the checkpoints
// ckpt (B, H, ceil(S / C), dh, dh) its forward saved at the same C. dout:
// (B, S, H, dh); dfinal: null (a zero gradient of the final state) or (B, H,
// dh, dh); scratch: (B H, C, dh, dh). Writes dr, dk, dv, dw (B, S, H, dh),
// du_part (B, H, dh) (du summed over the steps of each batch row) and
// dstate0 (B, H, dh, dh).
K2_EXPORT int k2_wkv6_scan_bwd(const float* r, const float* k, const float* v,
                               const float* w, const float* u,
                               const float* ckpt, const float* dout,
                               const float* dfinal, float* scratch, float* dr,
                               float* dk, float* dv, float* dw,
                               float* du_part, float* dstate0, int B, int S,
                               int H, int dh, int C, cudaStream_t stream) {
  if (B < 0 || S < 1 || H < 1 || dh < 1 || dh > 64 || C < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  long long p[K2P_WORDS];
  plan_wkv6_bwd(B, S, H, dh, C, p);
  auto kern = WKV_BWD_FNS[p[K2P_VARIANT]];
  cudaError_t err = k2_set_smem(kern, (size_t)p[K2P_SMEM]);
  if (err != cudaSuccess) return (int)err;
  kern<<<k2_grid(p), (unsigned)p[K2P_THREADS], (size_t)p[K2P_SMEM],
         stream>>>(r, k, v, w, u, ckpt, dout, dfinal, scratch, dr, dk, dv, dw,
                   du_part, dstate0, S, H, dh, C);
  return (int)cudaGetLastError();
}

// The gradients of k2_ssd_scan over S >= 1 steps from its checkpoints
// (B, H, ceil(S / C), P, N). dy: (B, S, H, P); dfinal: null or (B, H, P,
// N); scratch: (B H, C + 1, N, P). Writes dx (B, S, H, P), dB_part and
// dC_part (B, H, S, N) (each head's share), ddecay and ddt (B, S, H),
// dD_part (B, H) and dstate0 (B, H, P, N).
K2_EXPORT int k2_ssd_scan_bwd(const float* x, const float* Bm,
                              const float* Cm, const float* decay,
                              const float* dt, const float* D,
                              const float* ckpt, const float* dy,
                              const float* dfinal, float* scratch, float* dx,
                              float* dB_part, float* dC_part, float* ddecay,
                              float* ddt, float* dD_part, float* dstate0,
                              int B, int S, int H, int P, int N, int C,
                              cudaStream_t stream) {
  if (B < 0 || S < 1 || H < 1 || P < 1 || P > 256 || N < 1 || N > 64 ||
      C < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  long long p[K2P_WORDS];
  plan_ssd_bwd(B, S, H, P, N, C, p);
  auto kern = SSD_BWD_FNS[p[K2P_VARIANT]];
  cudaError_t err = k2_set_smem(kern, (size_t)p[K2P_SMEM]);
  if (err != cudaSuccess) return (int)err;
  kern<<<k2_grid(p), (unsigned)p[K2P_THREADS], (size_t)p[K2P_SMEM],
         stream>>>(x, Bm, Cm, decay, dt, D, ckpt, dy, dfinal, scratch, dx,
                   dB_part, dC_part, ddecay, ddt, dD_part, dstate0, S, H, P,
                   N, C);
  return (int)cudaGetLastError();
}
