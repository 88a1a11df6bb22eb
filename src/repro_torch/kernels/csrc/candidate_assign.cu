// K1: k_n-restricted assignment over the cluster-grouped arena, the
// k2-means hotspot.
//
// Replaces the Pallas TPU kernel src/repro/kernels/candidate_assign.py
// (candidate_assign_tiled / _tiled_kernel): per block of bn points, the
// squared distance to every candidate of the block's table row
// cidx[rowsel[b]] (a (kn_pad, d) slab of the per-cluster table ctab);
// best and second-best squared distance and the argbest candidate id;
// flat first-min ties; skip[b] != 0 passes prev_* through untouched;
// padding columns carry csqtab = 1e30 and never win.
//
// Bound on an H100: bytes. A fully recomputed pass reads every arena row
// once (n d 4 bytes) plus the distinct candidate slabs the blocks name,
// against 2 n kn_pad d FLOPs that must stay exact f64 products (see
// Rounding). The first design ran them as f64 FMAs on the CUDA cores from
// 2 x 2 register tiles, with x and the slab staged through shared memory
// widened to f64 by synchronous loads: about 7 TFLOP/s, 5.5x its bound at
// the fit's arena.
//
// Design: the products run on the f64 tensor cores, mma.sync m16n8k8 with
// f64 inputs and f64 sums (K5's recipe, distance_argmin.cu). One CUDA block
// of 8 warps per point block, which reads its own rowsel/skip (the TPU's
// scalar prefetch); a skipped block copies prev_* and returns without
// touching x or the table. The block walks its candidates in chunks of
// KC = 32 columns, and each chunk's d in stages of DC = 64 floats: the
// chunk's 32 slab rows and the block's rows (zero past bn) are copied as
// f32 into shared memory by cp.async (16 bytes a thread where d % 4 == 0
// and x, ctab are 16-byte aligned, else 4) into a ring of 4 stages (3
// above 32 rows), so 2 or 3 copies are in flight while a stage is used;
// the ring runs straight on across chunks, and values are widened to f64
// as a fragment is loaded. The candidates sit on the MMA's M side (2 m16 tiles) and the
// points on its N side (bn / 8 n8 tiles), so the predict layout's bn = 8
// fills every MMA. Each warp holds 2 x NJ MMA tiles (NJ <= 2) of f64
// partial sums: the warps split the points into groups of NJ * 8 rows and,
// where there are fewer groups than warps, split each stage's 8 k-steps
// among a group's warps. At the end of a chunk the partial sums meet
// in shared memory, where one thread a (point, candidate) pair adds them,
// rounds the pair's x.c (Rounding) and evaluates its distance in f32 with
// explicit __f*_rn steps in the plain version's order; thread r then
// scans row r's columns in order with strict <, carrying best,
// second-best and argbest from chunk to chunk: the flat first-min of the
// TPU kernel's tile-by-tile merge, with the second-best of the multiset.
// |x|^2 of each row (during the first chunk) and |c|^2 of each candidate
// (the screen's bound) accumulate in f64 from the staged f32 rows. Any
// kn_pad and d; bn is at most 128 (ops.choose_group_bn's cap). nvcc
// -Xptxas -v for sm_90a (CUDA 12.8): 121-128 registers, no spills; 107 KB
// of dynamic shared memory at bn = 32 (two blocks an SM), 61 KB at bn = 8.
//
// Rounding: x.c and |x|^2 are correctly rounded to f32 (common.cuh: the
// f64 sum, exact products in some order, is screened against its error
// bound, and the few sums the screen cannot decide are recomputed exactly
// from the rows in global memory), a value no order changes. The plain
// version, the torch paths and the int8 path's f32 re-rank compute the
// same value, so one (point, center) pair has one squared distance
// everywhere, and the f32 and int8 predict paths do not split on
// near-ties as two summation orders would.
#include <math.h>
#include <stdint.h>
#include "common.cuh"

namespace {
constexpr int NT = 256, NW = NT / 32;
constexpr int KC = 32;            // candidate columns per chunk: 2 m16 tiles
constexpr int DC = 64;            // floats of d per stage
constexpr int LD = DC + 4;        // padded row stride: fragment loads hit
                                  // 32 banks
constexpr int BN_MAX = 128;
constexpr int CPC = NT / KC;      // threads that share a candidate's |c|^2

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? bytes : 0;     // n = 0: fill with zeros, read nothing
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
}

// D += A (16x8, row) * B (8x8, col), f64 in, f64 sums. Fragments (g = lane
// / 4, t = lane % 4): a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4];
// b = B[t][g], B[t+4][g]; d = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4],
                                     const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// NJ n8 tiles of points per warp, RG groups of NJ * 8 rows; the KS = NW /
// RG warps of a group split the k side. BR = RG * NJ * 8 rows are staged,
// in a ring of STAGES stages (STAGES - 1 copies in flight). The partial
// sums of a chunk meet in RED (NJ <= 2 keeps it at 32 KB).
template <int NJ, int RG>
struct Tile {
  static constexpr int KS = NW / RG, BR = RG * NJ * 8, PER = 8 * NJ;
  static constexpr int TPR = NT / BR;                 // threads a row's |x|^2
  static constexpr int STAGES = BR <= 32 ? 4 : 3;
  static constexpr int STAGE = (BR + KC) * LD;        // floats
  static constexpr size_t RED = sizeof(double) * NT * PER;
  static constexpr size_t SMEM = sizeof(float) * STAGES * STAGE + RED +
                                 sizeof(double) * (BR + KC) +
                                 sizeof(float) * BR +
                                 sizeof(float) * (size_t)BR * KC;
};

// Copy stage (c0, t0): the point rows row0.. (zero past bn) and the slab
// rows c0.. (zero past knp), DC floats each, zero past d.
template <int NJ, int RG, int VEC>
__device__ __forceinline__ void load_stage(float* st, const float* x,
                                           const float* slab, size_t row0,
                                           int c0, int t0, int bn, int knp,
                                           int d) {
  constexpr int BR = Tile<NJ, RG>::BR, PER_ROW = DC / VEC;
  for (int e = threadIdx.x; e < (BR + KC) * PER_ROW; e += NT) {
    const int r = e / PER_ROW, j = (e % PER_ROW) * VEC;
    const bool is_x = r < BR;
    const int q = is_x ? r : c0 + r - BR;
    const bool ok = (is_x ? r < bn : q < knp) && t0 + j < d;
    const float* src = is_x ? x + (row0 + r) * d : slab + (size_t)q * d;
    cp_async(st + r * LD + j, ok ? src + t0 + j : x, ok, VEC * 4);
  }
}

template <int NJ, int RG, int VEC>
__global__ void __launch_bounds__(NT, 2)
candidate_assign_tiled_kernel(const float* __restrict__ x,
                              const float* __restrict__ ctab,
                              const float* __restrict__ csqtab,
                              const int* __restrict__ cidx,
                              const int* __restrict__ rowsel,
                              const int* __restrict__ skip,
                              const int* __restrict__ prev_a,
                              const float* __restrict__ prev_d1,
                              const float* __restrict__ prev_d2,
                              int* __restrict__ a, float* __restrict__ d1,
                              float* __restrict__ d2, int bn, int knp, int d) {
  using T = Tile<NJ, RG>;
  constexpr int KS = T::KS, BR = T::BR, PER = T::PER, TPR = T::TPR;
  constexpr int STAGES = T::STAGES;
  const int b = blockIdx.x;
  const size_t row0 = (size_t)b * bn;
  if (skip[b] != 0) {
    for (int r = threadIdx.x; r < bn; r += NT) {
      a[row0 + r] = prev_a[row0 + r];
      d1[row0 + r] = prev_d1[row0 + r];
      d2[row0 + r] = prev_d2[row0 + r];
    }
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  double* red = reinterpret_cast<double*>(ring + STAGES * T::STAGE);
  double* xse = red + NT * PER;      // per row: gamma_d |x|, from f64 |x|^2
  double* cnr = xse + BR;            // per chunk column: |c| from f64 |c|^2
  float* xs2 = reinterpret_cast<float*>(cnr + KC);  // rounded |x|^2
  float* vt = xs2 + BR;              // (BR, KC) the chunk's distances

  const int tslab = rowsel[b];
  const float* slab = ctab + (size_t)tslab * knp * d;
  const float* csq = csqtab + (size_t)tslab * knp;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp / KS, ks = warp % KS;
  const int nkc = max(1, (d + DC - 1) / DC);
  const int nchunk = (knp + KC - 1) / KC;
  const int steps = nchunk * nkc;

  double acc[2][NJ][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;
  double sq = 0.0;   // |x|^2 part: row tid / TPR, columns tid % TPR + TPR j
  double cq = 0.0;   // |c|^2 part: column tid / CPC, floats tid % CPC + CPC j
  float b1 = INFINITY, b2 = INFINITY;   // row tid's running best, second
  int arg = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps)
      load_stage<NJ, RG, VEC>(ring + s * T::STAGE, x, slab, row0,
                              (s / nkc) * KC, (s % nkc) * DC, bn, knp, d);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int step = 0; step < steps; ++step) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();                 // stage `step` landed; step-1's is free
    {
      const int nx = step + STAGES - 1;
      if (nx < steps)
        load_stage<NJ, RG, VEC>(ring + (nx % STAGES) * T::STAGE, x, slab,
                                row0, (nx / nkc) * KC, (nx % nkc) * DC, bn,
                                knp, d);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    const int ci = step / nkc, kc = step % nkc, t0 = kc * DC;
    const float* xs = ring + (step % STAGES) * T::STAGE;
    const float* cs = xs + BR * LD;
    if (ci == 0) {
      const float* xr = xs + (threadIdx.x / TPR) * LD + threadIdx.x % TPR;
#pragma unroll
      for (int j = 0; j < DC / TPR; ++j) {
        const double v = xr[TPR * j];
        sq = fma(v, v, sq);
      }
    }
    {
      const float* cr = cs + (threadIdx.x / CPC) * LD + threadIdx.x % CPC;
#pragma unroll
      for (int j = 0; j < DC / CPC; ++j) {
        const double v = cr[CPC * j];
        cq = fma(v, v, cq);
      }
    }
#pragma unroll
    for (int kk = ks; kk < DC / 8; kk += KS) {
      if (t0 + kk * 8 >= d) break;   // the rest of the stage is zero
      double af[2][4], bf[NJ][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* p = cs + (i * 16 + g) * LD + kk * 8 + t;
        af[i][0] = p[0];
        af[i][1] = p[8 * LD];
        af[i][2] = p[4];
        af[i][3] = p[8 * LD + 4];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* p = xs + (rg * NJ * 8 + j * 8 + g) * LD + kk * 8 + t;
        bf[j][0] = p[0];
        bf[j][1] = p[4];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dmma(acc[i][j], af[i], bf[j]);
    }
    if (kc != nkc - 1) continue;

    // --- epilogue of chunk ci: columns c0 .. c0 + KC ---------------------
    const int c0 = ci * KC;
#pragma unroll
    for (int o = 1; o < CPC; o <<= 1)
      cq += __shfl_xor_sync(0xffffffffu, cq, o);
    if (threadIdx.x % CPC == 0) cnr[threadIdx.x / CPC] = sqrt(cq);
    cq = 0.0;
    if (ci == 0) {
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1)
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
      if (threadIdx.x % TPR == 0) xse[threadIdx.x / TPR] = sq;
    }
    {
      double* mine = red + (size_t)(warp * 32 + lane) * PER;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            mine[i * 4 * NJ + j * 4 + e] = acc[i][j][e];
            acc[i][j][e] = 0.0;
          }
    }
    __syncthreads();
    if (ci == 0) {                     // each row's rounded |x|^2, once
      if (threadIdx.x < (bn + 31) / 32 * 32) {       // whole warps
        const bool live = threadIdx.x < bn;
        const double s2 = live ? xse[threadIdx.x] : 0.0;
        const float v = k2_round_sqnorm(s2, x + (row0 + threadIdx.x) * d, d);
        if (live) {
          xs2[threadIdx.x] = v;
          xse[threadIdx.x] = k2_gamma(d) * sqrt(s2);
        }
      }
      __syncthreads();
    }
    // each thread its (point, candidate) pairs: the screen now, the rare
    // flagged sums after, a warp at a time
    unsigned flagged = 0;
    for (int e = threadIdx.x, m = 0; e < RG * 32 * PER; e += NT, ++m) {
      const int grp = e / (32 * PER), rem = e % (32 * PER);
      const int ln = rem / PER, i = rem % PER;
      const int mi = i / (4 * NJ), nj = (i / 4) % NJ, ee = i % 4;
      const int cand = mi * 16 + ln / 4 + (ee & 2 ? 8 : 0);
      const int r = grp * NJ * 8 + nj * 8 + 2 * (ln % 4) + (ee & 1);
      if (r >= bn || c0 + cand >= knp) continue;
      double s = 0.0;
#pragma unroll
      for (int k = 0; k < KS; ++k)
        s += red[(size_t)((grp * KS + k) * 32) * PER + rem];
      float cross;
      if (!k2_screen(s, xse[r] * cnr[cand], cross)) {
        flagged |= 1u << m;
        continue;
      }
      vt[r * KC + cand] = fmaxf(
          __fadd_rn(__fsub_rn(xs2[r], __fmul_rn(2.f, cross)), csq[c0 + cand]),
          0.f);
    }
    while (__any_sync(0xffffffffu, flagged)) {
      const bool need = flagged != 0;
      const int m = need ? __ffs(flagged) - 1 : 0;
      flagged &= flagged - 1;
      const int e = threadIdx.x + m * NT;
      const int rem = e % (32 * PER), ln = rem / PER, i = rem % PER;
      const int mi = i / (4 * NJ), nj = (i / 4) % NJ, ee = i % 4;
      const int cand = mi * 16 + ln / 4 + (ee & 2 ? 8 : 0);
      const int r = e / (32 * PER) * NJ * 8 + nj * 8 + 2 * (ln % 4) + (ee & 1);
      const float cross =
          k2_exact_dot_lanes(need, x + (row0 + r) * d, 1,
                             slab + (size_t)(c0 + cand) * d, 1, d);
      if (need)
        vt[r * KC + cand] = fmaxf(
            __fadd_rn(__fsub_rn(xs2[r], __fmul_rn(2.f, cross)),
                      csq[c0 + cand]),
            0.f);
    }
    __syncthreads();
    if (threadIdx.x < bn) {
      const int w = min(KC, knp - c0);
      for (int q = 0; q < w; ++q) {
        const float v = vt[threadIdx.x * KC + q];
        if (v < b1) {
          b2 = b1;
          b1 = v;
          arg = c0 + q;
        } else if (v < b2) {
          b2 = v;
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  if (threadIdx.x < bn) {
    a[row0 + threadIdx.x] = cidx[(size_t)tslab * knp + arg];
    d1[row0 + threadIdx.x] = b1;
    d2[row0 + threadIdx.x] = b2;
  }
}

template <int NJ, int RG>
cudaError_t launch(const float* x, const float* ctab, const float* csqtab,
                   const int* cidx, const int* rowsel, const int* skip,
                   const int* prev_a, const float* prev_d1,
                   const float* prev_d2, int* a, float* d1, float* d2, int nb,
                   int bn, int knp, int d, cudaStream_t stream) {
  const size_t smem = Tile<NJ, RG>::SMEM;
  const bool vec = d % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)ctab % 16 == 0;
  auto kern = vec ? candidate_assign_tiled_kernel<NJ, RG, 4>
                  : candidate_assign_tiled_kernel<NJ, RG, 1>;
  cudaError_t err = k2_set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  if (nb > 0)
    kern<<<nb, NT, smem, stream>>>(x, ctab, csqtab, cidx, rowsel, skip,
                                   prev_a, prev_d1, prev_d2, a, d1, d2, bn,
                                   knp, d);
  return cudaGetLastError();
}
}  // namespace

// x: (nb*bn, d) f32; ctab: (T, knp, d) f32; csqtab: (T, knp) f32;
// cidx: (T, knp) i32; rowsel, skip: (nb,) i32; prev_a i32, prev_d1/d2 f32
// and the outputs a i32, d1/d2 f32: (nb*bn,). 1 <= bn <= 128.
K2_EXPORT int k2_candidate_assign_tiled(
    const float* x, const float* ctab, const float* csqtab, const int* cidx,
    const int* rowsel, const int* skip, const int* prev_a, const float* prev_d1,
    const float* prev_d2, int* a, float* d1, float* d2, int nb, int bn, int knp,
    int d, cudaStream_t stream) {
  if (bn < 1 || bn > BN_MAX || knp < 1) return (int)cudaErrorInvalidValue;
  auto go = bn <= 8    ? launch<1, 1>
            : bn <= 16 ? launch<1, 2>
            : bn <= 32 ? launch<2, 2>
            : bn <= 64 ? launch<2, 4>
                       : launch<2, 8>;
  return (int)go(x, ctab, csqtab, cidx, rowsel, skip, prev_a, prev_d1,
                 prev_d2, a, d1, d2, nb, bn, knp, d, stream);
}
