// K4: the int8 margin-test scan over the cluster-grouped layout, the first
// stage of the quantized resolution (scan int8, re-rank survivors in f32).
//
// Replaces the Pallas TPU kernel src/repro/kernels/candidate_assign.py
// (candidate_assign_int8_tiled / _int8_tiled_kernel): per block of bn
// int8 rows, the int8 x int8 -> int32 products with every candidate of the
// block's quantized slab qtab[rowsel[b]], the approximate distance
//   s_hat = sqrt(max(xhsq - (2 (xsc qsc)) cross + csq, 0)),
//   xhsq = (xsc xsc) sum(xq^2),
// and the margin test s_hat - rc <= min(s_hat + rc) + 2 rx (rc = qerr of the
// candidate, rx = xerr of the row, the running min starting at 1e30). Each
// row emits its first r survivor columns in ascending order (-1 padded),
// its survivor count (which may exceed r) and the least lower bound among
// non-survivors (1e30 when all survive). skip[b] != 0 yields (-1, 0, 1e30)
// and reads neither xq nor the slab.
//
// Rounding: the TPU kernel and the plain PyTorch version round after every
// operation. nvcc would contract the distance expression into FMAs and move
// s_hat by ulps, which moves survivors at the margin, so every step is an
// explicit __fmul_rn / __fsub_rn / __fadd_rn (never contracted), sqrtf is
// the correctly rounded one (no fast math), and integer sums are exact. The
// outputs are then bit-equal to the plain version's.
//
// Bound on an H100: bytes. The kernel reads each grouped int8 row once
// (n d bytes) and the slabs its blocks name (kn_pad (d + 12) bytes per
// distinct table row) against 2 n kn_pad d int8 operations. Design: one
// CUDA block per point block, which reads its own rowsel/skip. The margin
// test needs the row's min(s_hat + rc) over every column before any column
// can be tested, so the block walks kn_pad in chunks of KC = 32 columns
// twice: pass 1 takes the running min of s_hat + rc per row, pass 2
// computes s_hat again chunk by chunk and emits the survivors in ascending
// column order (a per-row count carried across chunks). When kn_pad <= KC
// there is one chunk and pass 2 reuses pass 1's s_hat. Within a chunk,
// threads cover (row, column) pairs and loop over d in chunks of DW 32-bit
// words (4 int8 each), staged through shared memory as packed words (row
// stride DW+1 against bank conflicts, zero past d so a d % 4 tail adds
// nothing); each pair accumulates with __dp4a. min is exact in any order
// and the integer sums are exact, so the chunking changes no output bit.
// Shared memory is 4 ((bn + KC)(DW + 1) + bn KC + 4 bn) bytes, 39 KB at
// bn = 128, whatever kn_pad is.
#include <math.h>
#include <stdint.h>
#include "common.cuh"

namespace {
constexpr int NT = 256;
constexpr int DW = 32;
constexpr int KC = 32;            // columns per chunk
constexpr float PAD_SQDIST = 1e30f;

// bytes j..j+3 of an int8 row of length d as one packed word, 0 past d
__device__ __forceinline__ int pack4(const int8_t* row, int j, int d) {
  int v = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (j + e < d) v |= (int)(uint8_t)row[j + e] << (8 * e);
  return v;
}

__global__ void __launch_bounds__(NT)
candidate_assign_int8_kernel(const int8_t* __restrict__ xq,
                             const float* __restrict__ xsc,
                             const float* __restrict__ xerr,
                             const int8_t* __restrict__ qtab,
                             const float* __restrict__ qsc,
                             const float* __restrict__ qerr,
                             const float* __restrict__ csqtab,
                             const int* __restrict__ rowsel,
                             const int* __restrict__ skip,
                             int* __restrict__ surv, int* __restrict__ nsv,
                             float* __restrict__ lbm, int bn, int knp, int d,
                             int r) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  const size_t row0 = (size_t)b * bn;
  if (skip[b] != 0) {
    for (int e = threadIdx.x; e < bn * r; e += NT) surv[row0 * r + e] = -1;
    for (int i = threadIdx.x; i < bn; i += NT) {
      nsv[row0 + i] = 0;
      lbm[row0 + i] = PAD_SQDIST;
    }
    return;
  }
  const int t = rowsel[b];
  const int8_t* slab = qtab + (size_t)t * knp * d;
  const float* sc_t = qsc + (size_t)t * knp;
  const float* rc_t = qerr + (size_t)t * knp;
  const float* csq_t = csqtab + (size_t)t * knp;
  int* xs = smem;                      // (bn, DW+1) packed words
  int* cs = xs + bn * (DW + 1);        // (KC, DW+1) packed words
  int* acc = cs + KC * (DW + 1);       // (bn, KC) int32 xq.q, then s_hat
  int* xsq = acc + bn * KC;            // (bn,) int32 sum(xq^2)
  float* cut = reinterpret_cast<float*>(xsq + bn);  // (bn,) min, then cut
  int* cnt = xsq + 2 * bn;             // (bn,) survivors so far
  float* rest = cut + 2 * bn;          // (bn,) least non-survivor bound
  float* shat = reinterpret_cast<float*>(acc);
  const int pairs = bn * KC;
  const int dw = (d + 3) / 4;
  for (int i = threadIdx.x; i < bn; i += NT) {
    xsq[i] = 0;
    cut[i] = PAD_SQDIST;
    cnt[i] = 0;
    rest[i] = PAD_SQDIST;
  }
  for (int pass = 0; pass < 2; ++pass) {
    for (int c0 = 0; c0 < knp; c0 += KC) {
      const int w = min(KC, knp - c0);
      if (pass == 0 || knp > KC) {     // s_hat of this chunk
        __syncthreads();
        for (int p = threadIdx.x; p < pairs; p += NT) acc[p] = 0;
        for (int w0 = 0; w0 < dw; w0 += DW) {
          __syncthreads();
          for (int e = threadIdx.x; e < bn * DW; e += NT) {
            const int i = e / DW, j = e % DW;
            xs[i * (DW + 1) + j] =
                w0 + j < dw ? pack4(xq + (row0 + i) * d, 4 * (w0 + j), d) : 0;
          }
          for (int e = threadIdx.x; e < KC * DW; e += NT) {
            const int q = e / DW, j = e % DW;
            cs[q * (DW + 1) + j] =
                q < w && w0 + j < dw
                    ? pack4(slab + (size_t)(c0 + q) * d, 4 * (w0 + j), d)
                    : 0;
          }
          __syncthreads();
          if (pass == 0 && c0 == 0) {
            for (int i = threadIdx.x; i < bn; i += NT) {
              const int* xr = xs + i * (DW + 1);
              int s = xsq[i];
#pragma unroll 8
              for (int j = 0; j < DW; ++j) s = __dp4a(xr[j], xr[j], s);
              xsq[i] = s;
            }
          }
          for (int p = threadIdx.x; p < pairs; p += NT) {
            const int* xr = xs + (p / KC) * (DW + 1);
            const int* cr = cs + (p % KC) * (DW + 1);
            int s = acc[p];
#pragma unroll 8
            for (int j = 0; j < DW; ++j) s = __dp4a(xr[j], cr[j], s);
            acc[p] = s;
          }
        }
        __syncthreads();
        for (int p = threadIdx.x; p < pairs; p += NT) {
          const int i = p / KC, q = p % KC;
          if (q >= w) continue;
          const float s = xsc[row0 + i];
          const float xhsq = __fmul_rn(__fmul_rn(s, s), __int2float_rn(xsq[i]));
          const float two_sc = __fmul_rn(2.f, __fmul_rn(s, sc_t[c0 + q]));
          const float prod = __fmul_rn(two_sc, __int2float_rn(acc[p]));
          const float dist = __fadd_rn(__fsub_rn(xhsq, prod), csq_t[c0 + q]);
          shat[p] = sqrtf(fmaxf(dist, 0.f));
        }
        __syncthreads();
      }
      for (int i = threadIdx.x; i < bn; i += NT) {
        const float* sr = shat + i * KC;
        if (pass == 0) {
          float m = cut[i];
          for (int q = 0; q < w; ++q)
            m = fminf(m, __fadd_rn(sr[q], rc_t[c0 + q]));
          cut[i] = m;
          continue;
        }
        int* out = surv + (row0 + i) * r;
        int n_s = cnt[i];
        float lo = rest[i];
        for (int q = 0; q < w; ++q) {
          const float lb = __fsub_rn(sr[q], rc_t[c0 + q]);
          if (lb <= cut[i]) {
            if (n_s < r) out[n_s] = c0 + q;
            ++n_s;
          } else {
            lo = fminf(lo, lb);
          }
        }
        cnt[i] = n_s;
        rest[i] = lo;
      }
    }
    if (pass == 0) {   // each row's thread turns its own min into the cut
      for (int i = threadIdx.x; i < bn; i += NT)
        cut[i] = __fadd_rn(cut[i], __fmul_rn(2.f, xerr[row0 + i]));
    }
  }
  for (int i = threadIdx.x; i < bn; i += NT) {
    int* out = surv + (row0 + i) * r;
    for (int s = cnt[i]; s < r; ++s) out[s] = -1;
    nsv[row0 + i] = cnt[i];
    lbm[row0 + i] = rest[i];
  }
}
}  // namespace

// xq: (nb*bn, d) int8; xsc, xerr: (nb*bn,) f32; qtab: (T, knp, d) int8;
// qsc, qerr, csqtab: (T, knp) f32; rowsel, skip: (nb,) i32; outputs surv
// (nb*bn, r) i32, nsv (nb*bn,) i32, lbm (nb*bn,) f32.
K2_EXPORT int k2_candidate_assign_int8_tiled(
    const int8_t* xq, const float* xsc, const float* xerr, const int8_t* qtab,
    const float* qsc, const float* qerr, const float* csqtab,
    const int* rowsel, const int* skip, int* surv, int* nsv, float* lbm,
    int nb, int bn, int knp, int d, int r, cudaStream_t stream) {
  if (bn < 1 || knp < 1) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(int) * ((size_t)(bn + KC) * (DW + 1) + (size_t)bn * KC + 4 * bn);
  cudaError_t err = k2_set_smem(candidate_assign_int8_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (nb > 0)
    candidate_assign_int8_kernel<<<nb, NT, smem, stream>>>(
        xq, xsc, xerr, qtab, qsc, qerr, csqtab, rowsel, skip, surv, nsv, lbm,
        bn, knp, d, r);
  return (int)cudaGetLastError();
}
