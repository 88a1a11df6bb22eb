// K7: the legacy rowwise k_n-restricted assignment: the baseline the
// tiled kernel K1 is measured against.
//
// Replaces the Pallas TPU kernel src/repro/kernels/candidate_assign.py
// (candidate_assign_rowwise / _rowwise_kernel): per block of bn points, the
// squared distance max(|x|^2 - 2 x.c + |c|^2, 0) to each center of the
// block's own list cand[b, :] in list order, gathered straight from c (the
// TPU kernel's one DMA per grid step), keeping the best distance and its
// center with strict <, so ties (an id named twice, two ids with equal
// rows) go to the first in list order. A block with skip[b] != 0 copies
// prev_a / prev_d and reads neither x nor c.
//
// Bound on an H100: bytes. The work is 2 n kn d products against the point
// rows read once (n d 4 bytes) plus the distinct center rows the lists name
// (0.088 ms at the fit's arena, n=92000, d=784, k_n=30; the products take
// 0.065 ms on the f64 tensor cores). The first port ran one warp a row,
// each walking its whole list in f64 FMAs on the CUDA cores and joining
// the lanes by shuffles, and so read every list row again for each of the
// block's rows from L1/L2: 2.28-2.30 ms, 26x its bound.
//
// Design: K1's recipe (candidate_assign.cu) fed by index instead of a
// candidate table. One CUDA block of 8 warps per point block b and tile
// of up to 32 of its rows (gridDim.y tiles for a larger bn, each staging
// the list's rows again from L2), which reads its own skip[b] and copies
// its list into shared memory (lists longer than KN_SMEM are read where
// they lie). It walks the list in chunks of KC = 32 entries, and each
// chunk's d in stages of DC = 64 floats: the chunk's center rows
// c[cand[b, q]] and the tile's point rows are copied as f32 into shared
// memory by cp.async (16 bytes a thread where d % 4 == 0 and x, c are
// 16-byte aligned, else 4; entries past kn and rows past the tile fill
// zeros) into a ring of 4 stages, which runs straight on across chunks.
// The f64 products run on the tensor cores, mma.sync m16n8k8, values
// widened as a fragment loads: the list's entries on the M side (2 m16
// tiles), the points on the N side, each warp holding 2 x 2 tiles of
// partial sums; the 4 warps of each 16-row group split each stage's
// k-steps. At the end of a chunk the partial sums meet in shared memory,
// where one thread a (point, entry) pair adds them, rounds x.c by the
// screen (Rounding) and evaluates the distance in f32 with explicit
// __f*_rn steps in the plain version's order, max((|x|^2 - 2 x.c) +
// |c|^2, 0); thread r then scans row r's columns in list order with
// strict <, carrying (best, position) from chunk to chunk. Entries past
// kn and rows past the tile are masked by index. |x|^2 of each row
// accumulates in f64 from the staged rows during the first chunk; the
// accumulators live within a chunk only, so none is live across the
// recompute's calls. nvcc -Xptxas -v for sm_90a (CUDA 12.9): 128
// registers, no spills, a 160-byte stack frame (the exact tiers' calls);
// 114,960 bytes of dynamic shared memory, two blocks an SM.
//
// Rounding: x.c and |x|^2 are correctly rounded to f32 (common.cuh): the
// f64 sum is screened against its error bound, gamma_d |x| |c| with |c|
// from the correctly rounded |c|^2 (exact_round.exact_sqnorm, taken
// outside the kernel as the TPU kernel's wrapper takes it) rounded up.
// A sum the screen cannot decide leaves its pair out of the scan, in a
// list in shared memory; after the main loop (or when the list could not
// hold one more chunk's pairs) one warp a pair recomputes it exactly from
// the rows in global memory and the pair joins its row's result as the
// least (value, position) key, which is what an in-order scan with strict
// < keeps. A row whose |x|^2 the screen cannot decide sends all its pairs
// there, and the recompute takes its |x|^2 first. The kernel and
// ref.candidate_assign_ref then agree bit for bit, and K1 gives the same
// pair the same value, so both pick the same center from the same list.
#include <math.h>
#include <stdint.h>
#include "common.cuh"

namespace {
constexpr int NT = 256, NW = NT / 32;
constexpr int KC = 32;          // list entries per chunk: 2 m16 tiles
constexpr int DC = 64;          // floats of d per stage
constexpr int LD = DC + 4;      // padded row stride: fragment loads hit
                                // 32 banks
constexpr int VS = KC + 1;      // row stride of a chunk's distances
constexpr int KN_SMEM = 256;    // longest list copied to shared memory
constexpr int SLACK = 512;      // flagged pairs kept beyond a chunk's worth
// 2 n8 tiles of points per warp, 2 groups of 16 rows; the KS = 4 warps of
// a group split the k side
constexpr int NJ = 2, RG = 2, KS = NW / RG;
constexpr int BR = RG * NJ * 8, PER = 8 * NJ;  // rows a tile, sums a lane
constexpr int TPR = NT / BR;                    // threads a row's |x|^2
constexpr int STAGES = 4;
constexpr int STAGE = (BR + KC) * LD;           // floats
constexpr int CAP = BR * KC + SLACK;            // flagged pairs held
constexpr size_t SMEM =
    sizeof(float) * STAGES * STAGE +            // the ring
    sizeof(double) * (NT * PER + 2 * BR + KC) + // red, xse, key, cnr
    sizeof(float) * (BR + BR * VS + KC) +       // xs2, vt, ccsq
    sizeof(int) * (BR + CAP + KN_SMEM + 4);     // xun, flags, list, n
// two CUDA blocks an SM (228 KB a SM, 1 KB of it reserved per block)
static_assert(SMEM <= 115712, "K7: two blocks an SM");

// Copy stage (c0, t0): the tile's point rows row0.. (zero past nr) and the
// center rows of list entries c0.. (zero past kn), DC floats each, zero
// past d.
template <int VEC>
__device__ __forceinline__ void load_stage(float* st, const float* x,
                                           const float* c, const int* ids,
                                           size_t row0, int nr, int c0,
                                           int t0, int kn, int d) {
  constexpr int PER_ROW = DC / VEC;
  for (int e = threadIdx.x; e < (BR + KC) * PER_ROW; e += NT) {
    const int r = e / PER_ROW, j = (e % PER_ROW) * VEC;
    const bool is_x = r < BR;
    const int q = c0 + r - BR;
    const bool ok = (is_x ? r < nr : q < kn) && t0 + j < d;
    const float* src = !ok   ? x
                       : is_x ? x + (row0 + r) * d + t0 + j
                              : c + (size_t)ids[q] * d + t0 + j;
    k2_cp_async(st + r * LD + j, src, ok, VEC * 4);
  }
}

template <int VEC>
__global__ void __launch_bounds__(NT, 2)
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
  const size_t row0 = (size_t)b * bn + (size_t)blockIdx.y * BR;
  const int nr = min(BR, bn - (int)blockIdx.y * BR);
  if (skip[b] != 0) {
    for (int r = threadIdx.x; r < nr; r += NT) {
      a[row0 + r] = prev_a[row0 + r];
      dout[row0 + r] = prev_d[row0 + r];
    }
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  double* red = reinterpret_cast<double*>(ring + STAGES * STAGE);
  double* xse = red + NT * PER;      // per row: gamma_d |x|, from f64 |x|^2
  double* cnr = xse + BR;            // per chunk column: |c| rounded up
  unsigned long long* key =          // per row: least flagged (value, q)
      reinterpret_cast<unsigned long long*>(cnr + KC);
  float* xs2 = reinterpret_cast<float*>(key + BR);  // rounded |x|^2
  float* vt = xs2 + BR;              // (BR, VS) the chunk's distances
  float* ccsq = vt + BR * VS;        // per chunk column: rounded |c|^2
  int* xun = reinterpret_cast<int*>(ccsq + KC);  // |x|^2 left undecided
  unsigned* flags = reinterpret_cast<unsigned*>(xun + BR);  // q << 8 | r
  int* sids = reinterpret_cast<int*>(flags + CAP);
  int* nflag = sids + KN_SMEM;

  const int* list = cand + (size_t)b * kn;
  const int* ids = kn <= KN_SMEM ? sids : list;
  if (kn <= KN_SMEM)
    for (int q = threadIdx.x; q < kn; q += NT) sids[q] = list[q];
  for (int r = threadIdx.x; r < BR; r += NT) key[r] = ~0ull;
  if (threadIdx.x == 0) *nflag = 0;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp / KS, ks = warp % KS;
  const int nkc = max(1, (d + DC - 1) / DC);
  const int steps = (kn + KC - 1) / KC * nkc;

  double sq = 0.0;   // |x|^2 part: row tid / TPR, columns tid % TPR + TPR j
  float best = INFINITY;             // row tid's running best, its position
  int arg = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps)
      load_stage<VEC>(ring + s * STAGE, x, c, ids, row0, nr, (s / nkc) * KC,
                      (s % nkc) * DC, kn, d);
    k2_cp_commit();
  }
  int step = 0;
  for (;;) {
    while (step < steps) {           // a chunk of the list at a time
      const int ci = step / nkc, c0 = ci * KC, w = min(KC, kn - c0);
      double acc[2][NJ][4];          // live within the chunk only
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;
      for (int kc = 0; kc < nkc; ++kc, ++step) {
        k2_cp_wait<STAGES - 2>();
        __syncthreads();             // stage `step` landed; step-1's is free
        {
          const int nx = step + STAGES - 1;
          if (nx < steps)
            load_stage<VEC>(ring + (nx % STAGES) * STAGE, x, c, ids, row0,
                            nr, (nx / nkc) * KC, (nx % nkc) * DC, kn, d);
          k2_cp_commit();
        }
        const int t0 = kc * DC;
        const float* xs = ring + (step % STAGES) * STAGE;
        const float* cs = xs + BR * LD;
        if (ci == 0) {
          const float* xr = xs + (threadIdx.x / TPR) * LD + threadIdx.x % TPR;
#pragma unroll
          for (int j = 0; j < DC / TPR; ++j) {
            const double v = xr[TPR * j];
            sq = fma(v, v, sq);
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
            for (int j = 0; j < NJ; ++j) k2_dmma(acc[i][j], af[i], bf[j]);
        }
      }

      // --- epilogue of chunk ci: list entries c0 .. c0 + w -------------
      if (threadIdx.x < KC) {
        const float s = threadIdx.x < w ? csq[ids[c0 + threadIdx.x]] : 0.f;
        ccsq[threadIdx.x] = s;
        cnr[threadIdx.x] = sqrt(k2_sqnorm_up(s));
      }
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
            for (int e = 0; e < 4; ++e)
              mine[i * 4 * NJ + j * 4 + e] = acc[i][j][e];
      }
      __syncthreads();
      if (ci == 0) {                   // each row's |x|^2, screened once
        if (threadIdx.x < BR) {
          const double s2 = xse[threadIdx.x];
          float v;
          xun[threadIdx.x] = !k2_screen(s2, k2_gamma(d) * s2, v);
          xs2[threadIdx.x] = v;
          xse[threadIdx.x] = k2_gamma(d) * sqrt(s2);
        }
        __syncthreads();
      }
      // each thread its (point, entry) pairs; a pair the screen cannot
      // decide goes to the flag list and out of the scan
      for (int e = threadIdx.x; e < RG * 32 * PER; e += NT) {
        const int grp = e / (32 * PER), rem = e % (32 * PER);
        const int ln = rem / PER, i = rem % PER;
        const int mi = i / (4 * NJ), nj = (i / 4) % NJ, ee = i % 4;
        const int col = mi * 16 + ln / 4 + (ee & 2 ? 8 : 0);
        const int r = grp * NJ * 8 + nj * 8 + 2 * (ln % 4) + (ee & 1);
        if (r >= nr || col >= w) continue;
        double s = 0.0;
#pragma unroll
        for (int k = 0; k < KS; ++k)
          s += red[(size_t)((grp * KS + k) * 32) * PER + rem];
        float cross, v = INFINITY;
        if (!xun[r] && k2_screen(s, xse[r] * cnr[col], cross))
          v = fmaxf(__fadd_rn(__fsub_rn(xs2[r], __fmul_rn(2.f, cross)),
                              ccsq[col]),
                    0.f);
        else
          flags[atomicAdd(nflag, 1)] = (unsigned)(c0 + col) << 8 | r;
        vt[r * VS + col] = v;
      }
      __syncthreads();
      const bool full = *nflag > SLACK;  // no room for another chunk's pairs
      if (threadIdx.x < nr)
        for (int q = 0; q < w; ++q) {
          const float v = vt[threadIdx.x * VS + q];
          if (v < best) {
            best = v;
            arg = c0 + q;
          }
        }
      if (full) break;
    }

    // --- the flagged sums, exactly, out of the main loop ----------------
    // (every thread reads the count the last barrier left)
    if (*nflag > 0) {
      for (int r = warp; r < nr; r += NW) {  // undecided |x|^2: a warp a row
        if (!xun[r]) continue;
        const float* xr = x + (row0 + r) * d;
        const float v = k2_exact_dot_tiers(K2Strided{xr, 1, xr, 1}, d);
        if (lane == 0) xs2[r] = v;
      }
      __syncthreads();
      const int n = *nflag;
      for (int f = warp; f < n; f += NW) {   // a warp a flagged pair
        const int r = (int)(flags[f] & 255u), q = (int)(flags[f] >> 8);
        const int ci = ids[q];
        const float cross = k2_exact_dot_tiers(
            K2Strided{x + (row0 + r) * d, 1, c + (size_t)ci * d, 1}, d);
        if (lane == 0) {
          const float v = fmaxf(
              __fadd_rn(__fsub_rn(xs2[r], __fmul_rn(2.f, cross)), csq[ci]),
              0.f);
          // v >= +0, so its bits order as the values do
          atomicMin(key + r,
                    (unsigned long long)__float_as_uint(v) << 32 | (unsigned)q);
        }
      }
      __syncthreads();
      if (threadIdx.x < nr) {           // the least (value, position) wins
        const unsigned long long mine =
            (unsigned long long)__float_as_uint(best) << 32 | (unsigned)arg;
        const unsigned long long k =
            key[threadIdx.x] < mine ? key[threadIdx.x] : mine;
        best = __uint_as_float((unsigned)(k >> 32));
        arg = (int)(k & 0xffffffffu);
        key[threadIdx.x] = ~0ull;
        xun[threadIdx.x] = 0;
      }
      if (threadIdx.x == 0) *nflag = 0;
      __syncthreads();
    }
    if (step >= steps) break;
  }
  k2_cp_wait<0>();
  if (threadIdx.x < nr) {
    a[row0 + threadIdx.x] = ids[arg];
    dout[row0 + threadIdx.x] = best;
  }
}

// The instantiations the launcher picks from, in variant order: 4-byte
// (VEC 1) and 16-byte (VEC 4) copies.
const decltype(&candidate_assign_rowwise_kernel<1>) FNS[] = {
    candidate_assign_rowwise_kernel<1>, candidate_assign_rowwise_kernel<4>};

// The launch over nb point blocks of bn rows and lists of kn centers of d
// floats; aligned: x and c are 16-byte aligned. A CUDA block takes BR rows
// of one point block: (nb, ceil(bn / BR)) blocks.
cudaError_t plan(int nb, int bn, int kn, int d, bool aligned, long long* p) {
  if (nb < 0 || bn < 1 || kn < 1 || kn >= (1 << 24) || d < 0 ||
      (bn + BR - 1) / BR > 65535)
    return cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && aligned;
  k2_plan_init(p, nb, (bn + BR - 1) / BR, 1, NT, SMEM, vec ? 1 : 0,
               vec ? 1 : 0);
  p[K2P_ROWS] = nb;
  p[K2P_COLS] = bn;
  p[K2P_COL_EXTENT] = BR;
  p[K2P_INNER] = kn;
  p[K2P_INNER_TILE] = KC;
  return cudaSuccess;
}

}  // namespace

K2_DESCRIBE(candidate_assign_rowwise, FNS, "VEC1,VEC4")

K2_EXPORT int k2_plan_candidate_assign_rowwise(int nb, int bn, int kn, int d,
                                               int aligned, long long* out) {
  return (int)plan(nb, bn, kn, d, aligned != 0, out);
}

// x: (nb*bn, d) f32; c: (k, d) f32; csq: (k,) f32 exactly rounded |c|^2;
// cand: (nb, kn) i32 center ids in [0, k); skip: (nb,) i32; prev_a i32,
// prev_d f32 and the outputs a i32, dout f32: (nb*bn,). Any bn >= 1,
// 1 <= kn < 2^24, d >= 0.
K2_EXPORT int k2_candidate_assign_rowwise(const float* x, const float* c,
                                          const float* csq, const int* cand,
                                          const int* skip, const int* prev_a,
                                          const float* prev_d, int* a,
                                          float* dout, int nb, int bn, int kn,
                                          int d, cudaStream_t stream) {
  long long p[K2P_WORDS];
  cudaError_t err = plan(nb, bn, kn, d, k2_aligned16(x) && k2_aligned16(c),
                         p);
  if (err != cudaSuccess) return (int)err;
  auto kern = FNS[p[K2P_VARIANT]];
  k2_resident_blocks(kern, NT, (size_t)p[K2P_SMEM], err);  // opts in once
  if (err != cudaSuccess) return (int)err;
  if (nb > 0)
    kern<<<k2_grid(p), (unsigned)p[K2P_THREADS], (size_t)p[K2P_SMEM],
           stream>>>(x, c, csq, cand, skip, prev_a, prev_d, a, dout, bn, kn,
                     d);
  return (int)cudaGetLastError();
}
