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
// CUDA block per point block, which reads its own rowsel/skip. Threads
// cover (row, candidate) pairs and loop over d in chunks of DW 32-bit words
// (4 int8 each), staged through shared memory as packed words (row stride
// DW+1 against bank conflicts, zero past d so a d % 4 tail adds nothing);
// each pair accumulates with __dp4a. One thread per row then takes the
// running min and walks the columns in order, which lists survivors in
// ascending column order (a per-row prefix count). Shared memory is
// 4 ((bn + kn_pad)(DW + 1) + bn kn_pad + bn) bytes and must fit the 227 KB
// a block can have (kn_pad <= 333 at bn = 128); a launch past it is
// refused and raised.
#include <math.h>
#include <stdint.h>
#include "common.cuh"

namespace {
constexpr int NT = 256;
constexpr int DW = 32;
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
  int* xs = smem;                      // (bn, DW+1) packed words
  int* cs = xs + bn * (DW + 1);        // (knp, DW+1) packed words
  int* acc = cs + knp * (DW + 1);      // (bn, knp) int32 xq.q, then s_hat
  int* xsq = acc + bn * knp;           // (bn,) int32 sum(xq^2)
  const int pairs = bn * knp;
  const int dw = (d + 3) / 4;
  for (int p = threadIdx.x; p < pairs; p += NT) acc[p] = 0;
  for (int i = threadIdx.x; i < bn; i += NT) xsq[i] = 0;
  for (int w0 = 0; w0 < dw; w0 += DW) {
    __syncthreads();
    for (int e = threadIdx.x; e < bn * DW; e += NT) {
      const int i = e / DW, j = e % DW;
      xs[i * (DW + 1) + j] =
          w0 + j < dw ? pack4(xq + (row0 + i) * d, 4 * (w0 + j), d) : 0;
    }
    for (int e = threadIdx.x; e < knp * DW; e += NT) {
      const int q = e / DW, j = e % DW;
      cs[q * (DW + 1) + j] =
          w0 + j < dw ? pack4(slab + (size_t)q * d, 4 * (w0 + j), d) : 0;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < bn; i += NT) {
      const int* xr = xs + i * (DW + 1);
      int s = xsq[i];
#pragma unroll 8
      for (int j = 0; j < DW; ++j) s = __dp4a(xr[j], xr[j], s);
      xsq[i] = s;
    }
    for (int p = threadIdx.x; p < pairs; p += NT) {
      const int* xr = xs + (p / knp) * (DW + 1);
      const int* cr = cs + (p % knp) * (DW + 1);
      int s = acc[p];
#pragma unroll 8
      for (int j = 0; j < DW; ++j) s = __dp4a(xr[j], cr[j], s);
      acc[p] = s;
    }
  }
  __syncthreads();
  const float* sc_t = qsc + (size_t)t * knp;
  const float* rc_t = qerr + (size_t)t * knp;
  const float* csq_t = csqtab + (size_t)t * knp;
  float* shat = reinterpret_cast<float*>(acc);  // each thread its own pairs
  for (int p = threadIdx.x; p < pairs; p += NT) {
    const int i = p / knp, q = p % knp;
    const float s = xsc[row0 + i];
    const float xhsq = __fmul_rn(__fmul_rn(s, s), __int2float_rn(xsq[i]));
    const float two_sc = __fmul_rn(2.f, __fmul_rn(s, sc_t[q]));
    const float prod = __fmul_rn(two_sc, __int2float_rn(acc[p]));
    const float dist = __fadd_rn(__fsub_rn(xhsq, prod), csq_t[q]);
    shat[p] = sqrtf(fmaxf(dist, 0.f));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bn; i += NT) {
    const float* sr = shat + i * knp;
    float ub_min = PAD_SQDIST;
    for (int q = 0; q < knp; ++q)
      ub_min = fminf(ub_min, __fadd_rn(sr[q], rc_t[q]));
    const float cut = __fadd_rn(ub_min, __fmul_rn(2.f, xerr[row0 + i]));
    int* out = surv + (row0 + i) * r;
    int cnt = 0;
    float rest = PAD_SQDIST;
    for (int q = 0; q < knp; ++q) {
      const float lb = __fsub_rn(sr[q], rc_t[q]);
      if (lb <= cut) {
        if (cnt < r) out[cnt] = q;
        ++cnt;
      } else {
        rest = fminf(rest, lb);
      }
    }
    for (int s = cnt; s < r; ++s) out[s] = -1;
    nsv[row0 + i] = cnt;
    lbm[row0 + i] = rest;
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
  const size_t smem =
      sizeof(int) * ((size_t)(bn + knp) * (DW + 1) + (size_t)bn * knp + bn);
  cudaError_t err = k2_set_smem(candidate_assign_int8_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (nb > 0)
    candidate_assign_int8_kernel<<<nb, NT, smem, stream>>>(
        xq, xsc, xerr, qtab, qsc, qerr, csqtab, rowsel, skip, surv, nsv, lbm,
        bn, knp, d, r);
  return (int)cudaGetLastError();
}
