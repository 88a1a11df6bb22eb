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
// distinct table row) against 2 n kn_pad d int8 operations, far below the
// int8 tensor cores' rate. At the predict layout (bn = 8, kn_pad = 32, d =
// 784) a block is 6 KB of rows against a 25 KB slab, and the work is ~2,000
// small independent blocks.
//
// Design: one warp per unit of work, a unit being up to ROWS = 8 NTW rows
// of one point block (bn = 8: the whole block), four units a CUDA block,
// each warp on its own with no block-wide barrier. The products run on the
// int8 tensor cores, mma.sync m16n8k32 s8 x s8 -> s32: the candidates are M
// (a chunk of KC = 32 columns is two m16 tiles; slab rows are row-major
// A), the unit's rows are N (n8 tiles; each row contiguous along K is
// col-major B) and d is K. Integer sums are exact in any order, so K is
// permuted to suit the loads: within each 64-byte span of d, the lane of
// quad position t takes the 16 bytes at 16 t of its A and B rows with one
// 16-byte shared load, and feeds words 0 and 1 to one k32 step, words 2 and
// 3 to the next (both operands see the same permutation). The warp streams
// each 32-column chunk's slab rows and the unit's rows through a ring of
// STAGES stages of DC bytes of d in shared memory with 16-byte cp.async
// (byte copies where rows are not 16-byte aligned, d % 16 != 0),
// zero-filled past d and past the chunk's columns, so padding adds nothing;
// each stage stores [64-byte span][row][64 bytes], conflict-free for the
// fragment loads. sum(xq^2) is taken with __dp4a on the staged rows during
// the first chunk. After a chunk's d loop the accumulators go through a
// small shared tile to the epilogue's layout: lane (g, t) owns row g of
// each n8 tile and columns 8t..8t+7 of the chunk, so each row's four lanes
// hold its columns in ascending order. s_hat is kept in a shared window:
// all kn_pad columns when ROWS (kn_pad + 1) floats fit SHAT_BYTES (one pass
// over the slab: the min over every column, then the survivors), else one
// chunk (pass 1 takes the running min, pass 2 recomputes each chunk and
// emits survivors). Survivors are placed by an exclusive prefix count over
// the row's four lanes plus the count carried from earlier chunks. min is
// exact in any order, so no output bit depends on the schedule. The
// shared-memory attribute is set once per device and kernel.
#include <math.h>
#include <stdint.h>
#include "common.cuh"

namespace {
constexpr int NW = 4;                // warps (units) a CUDA block
constexpr int NT = 32 * NW;
constexpr int KC = 32;               // columns per chunk: two m16 tiles
constexpr int DC = 64;               // bytes of d a stage holds per row
constexpr int SPANS = DC / 64;
constexpr int STAGES = 4;
constexpr int SHAT_BYTES = 8192;     // a warp's s_hat window for one pass
constexpr float PAD_SQDIST = 1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <int NTW>
struct Unit {
  static constexpr int ROWS = 8 * NTW;
  static constexpr int SLAB_BYTES = SPANS * KC * 64;   // per stage
  static constexpr int STAGE_BYTES = SLAB_BYTES + SPANS * ROWS * 64;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int TILE_BYTES = ROWS * (KC + 1) * 4;
  // a warp's shared memory with an s_hat window of win columns
  __host__ __device__ static constexpr size_t warp_bytes(int win) {
    return ((size_t)RING_BYTES + TILE_BYTES + (size_t)ROWS * (win + 1) * 4 +
            15) / 16 * 16;
  }
  __host__ __device__ static constexpr bool one_pass(int knp) {
    return (size_t)ROWS * (knp + 1) * 4 <= SHAT_BYTES;
  }
  __host__ __device__ static constexpr size_t max_block_bytes() {
    return NW * warp_bytes(SHAT_BYTES / 4 / ROWS);
  }
};

__device__ __forceinline__ void mma_s8(int (&d)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 lds16(const unsigned char* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Copy stage s of a chunk (slab rows c0..c0+w-1 and the unit's nrow rows,
// bytes s DC .. s DC + DC - 1 of d) into ring slot st, in pieces of VB
// bytes, zeros past d and past the live rows.
template <int VB, int NTW>
__device__ __forceinline__ void fill_stage(unsigned char* st,
                                           const int8_t* slab,
                                           const int8_t* xrows, int w,
                                           int nrow, int d, int s, int lane) {
  using U = Unit<NTW>;
  constexpr int PPR = DC / VB;                  // pieces a row
  const int d0 = s * DC;
  for (int e = lane; e < (KC + U::ROWS) * PPR; e += 32) {
    const int row = e / PPR, k = (e % PPR) * VB;
    const bool is_slab = row < KC;
    const int rr = is_slab ? row : row - KC;
    const int8_t* src =
        (is_slab ? slab : xrows) + (size_t)rr * d + d0 + k;
    const bool ok = (is_slab ? rr < w : rr < nrow) && d0 + k < d;
    unsigned char* dst =
        st + (is_slab ? 0 : U::SLAB_BYTES) +
        (k / 64) * (is_slab ? KC : U::ROWS) * 64 + rr * 64 + k % 64;
    if constexpr (VB == 1) {
      *reinterpret_cast<int8_t*>(dst) = ok ? *src : 0;
    } else {
      k2_cp_async(reinterpret_cast<float*>(dst),
                  reinterpret_cast<const float*>(ok ? src : slab), ok, VB);
    }
  }
}

template <int VB, int NTW>
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
                             int r, int win, long long units) {
  using U = Unit<NTW>;
  constexpr int ROWS = U::ROWS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long u = (long long)blockIdx.x * NW + warp;
  if (u >= units) return;                      // a whole warp
  const int upb = (bn + ROWS - 1) / ROWS;      // units a point block
  const long long b = u / upb;
  const int r0 = (int)(u % upb) * ROWS;
  const int nrow = min(ROWS, bn - r0);
  const size_t row0 = (size_t)b * bn + r0;
  const int g = lane / 4, t = lane % 4;
  if (skip[b] != 0) {
    for (int e = lane; e < nrow * r; e += 32) surv[row0 * r + e] = -1;
    for (int i = lane; i < nrow; i += 32) {
      nsv[row0 + i] = 0;
      lbm[row0 + i] = PAD_SQDIST;
    }
    return;
  }
  const int tsel = rowsel[b];
  const int8_t* slab0 = qtab + (size_t)tsel * knp * d;
  const float* sc_t = qsc + (size_t)tsel * knp;
  const float* rc_t = qerr + (size_t)tsel * knp;
  const float* csq_t = csqtab + (size_t)tsel * knp;
  const int8_t* xrows = xq + row0 * d;
  unsigned char* ring = smem + warp * U::warp_bytes(win);
  int* tile = reinterpret_cast<int*>(ring + U::RING_BYTES);
  float* shat = reinterpret_cast<float*>(ring + U::RING_BYTES + U::TILE_BYTES);
  const int ws = win + 1;                      // s_hat row stride
  const bool one = win >= knp;
  const int nst = (d + DC - 1) / DC;

  int xsq[NTW];                                // sum(xq^2) of row 8 ni + g
  float cut[NTW], lo[NTW];
  int cnt[NTW];
#pragma unroll
  for (int ni = 0; ni < NTW; ++ni) {
    xsq[ni] = 0;
    cut[ni] = PAD_SQDIST;                      // the running min, then the cut
    lo[ni] = PAD_SQDIST;
    cnt[ni] = 0;
  }
  for (int pass = 0; pass < 2; ++pass) {
    for (int c0 = 0; c0 < knp; c0 += KC) {
      const int w = min(KC, knp - c0);
      const int off = one ? c0 : 0;
      if (pass == 0 || !one) {                 // s_hat of this chunk
        const int8_t* slab = slab0 + (size_t)c0 * d;
        const bool first = pass == 0 && c0 == 0;
        int acc[2][NTW][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < NTW; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
#pragma unroll
        for (int s = 0; s < STAGES - 1; ++s) {
          if (s < nst)
            fill_stage<VB, NTW>(ring + s * U::STAGE_BYTES, slab, xrows, w,
                                nrow, d, s, lane);
          k2_cp_commit();
        }
        for (int s = 0; s < nst; ++s) {
          k2_cp_wait<STAGES - 2>();
          __syncwarp();
          if (s + STAGES - 1 < nst)
            fill_stage<VB, NTW>(
                ring + (s + STAGES - 1) % STAGES * U::STAGE_BYTES, slab,
                xrows, w, nrow, d, s + STAGES - 1, lane);
          k2_cp_commit();
          const unsigned char* st = ring + s % STAGES * U::STAGE_BYTES;
#pragma unroll
          for (int sp = 0; sp < SPANS; ++sp) {
            const unsigned char* sa = st + sp * KC * 64 + 16 * t;
            const unsigned char* sb = st + U::SLAB_BYTES + sp * ROWS * 64 +
                                      16 * t;
            uint4 a[4];                        // candidates g, g+8, 16+g, 24+g
#pragma unroll
            for (int q = 0; q < 4; ++q) a[q] = lds16(sa + (g + 8 * q) * 64);
#pragma unroll
            for (int ni = 0; ni < NTW; ++ni) {
              const uint4 x = lds16(sb + (8 * ni + g) * 64);
              if (first)
                xsq[ni] = __dp4a((int)x.w, (int)x.w, __dp4a((int)x.z, (int)x.z,
                          __dp4a((int)x.y, (int)x.y,
                                 __dp4a((int)x.x, (int)x.x, xsq[ni]))));
#pragma unroll
              for (int mi = 0; mi < 2; ++mi) {
                const uint4& p = a[2 * mi];
                const uint4& q = a[2 * mi + 1];
                mma_s8(acc[mi][ni], p.x, q.x, p.y, q.y, x.x, x.y);
                mma_s8(acc[mi][ni], p.z, q.z, p.w, q.w, x.z, x.w);
              }
            }
          }
        }
        k2_cp_wait<0>();
        if (first) {
#pragma unroll
          for (int ni = 0; ni < NTW; ++ni) {
            xsq[ni] += __shfl_xor_sync(FULL, xsq[ni], 1);
            xsq[ni] += __shfl_xor_sync(FULL, xsq[ni], 2);
          }
        }
        // the accumulators to a (row, column) tile: D[cand][row] with
        // cand = 16 mi + g (+8), row = 8 ni + 2t (+1)
        __syncwarp();
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < NTW; ++ni) {
            int* tr = tile + (8 * ni + 2 * t) * (KC + 1) + 16 * mi + g;
            tr[0] = acc[mi][ni][0];
            tr[KC + 1] = acc[mi][ni][1];
            tr[8] = acc[mi][ni][2];
            tr[KC + 1 + 8] = acc[mi][ni][3];
          }
        __syncwarp();
#pragma unroll
        for (int ni = 0; ni < NTW; ++ni) {
          const int row = 8 * ni + g;
          if (row >= nrow) continue;
          const float s = xsc[row0 + row];
          const float xhsq =
              __fmul_rn(__fmul_rn(s, s), __int2float_rn(xsq[ni]));
          const int* tr = tile + row * (KC + 1);
          float* sr = shat + row * ws + off;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int q = 8 * t + j;
            if (q >= w) continue;
            const float two_sc = __fmul_rn(2.f, __fmul_rn(s, sc_t[c0 + q]));
            const float prod = __fmul_rn(two_sc, __int2float_rn(tr[q]));
            const float dist =
                __fadd_rn(__fsub_rn(xhsq, prod), csq_t[c0 + q]);
            sr[q] = sqrtf(fmaxf(dist, 0.f));
          }
        }
        __syncwarp();                          // the tile is rewritten next
      }
      // each lane's own columns 8t..8t+7 of row 8 ni + g (lanes read only
      // what they wrote)
#pragma unroll
      for (int ni = 0; ni < NTW; ++ni) {
        const int row = 8 * ni + g;
        const bool live = row < nrow;
        const float* sr = shat + row * ws + off;
        if (pass == 0) {
          if (live)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int q = 8 * t + j;
              if (q < w)
                cut[ni] = fminf(cut[ni], __fadd_rn(sr[q], rc_t[c0 + q]));
            }
          continue;
        }
        unsigned hit = 0;
        int mine = 0;
        if (live)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int q = 8 * t + j;
            if (q >= w) continue;
            const float lb = __fsub_rn(sr[q], rc_t[c0 + q]);
            if (lb <= cut[ni]) {
              hit |= 1u << j;
              ++mine;
            } else {
              lo[ni] = fminf(lo[ni], lb);
            }
          }
        int incl = mine;                       // prefix over the row's lanes
        int y = __shfl_up_sync(FULL, incl, 1, 4);
        if (t >= 1) incl += y;
        y = __shfl_up_sync(FULL, incl, 2, 4);
        if (t >= 2) incl += y;
        const int total = __shfl_sync(FULL, incl, 3, 4);
        int at = cnt[ni] + incl - mine;
        int* out = surv + (row0 + row) * r;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (hit >> j & 1u) {
            if (at < r) out[at] = c0 + 8 * t + j;
            ++at;
          }
        cnt[ni] += total;
      }
    }
    if (pass == 0) {   // the row's min over its four lanes, then the cut
#pragma unroll
      for (int ni = 0; ni < NTW; ++ni) {
        cut[ni] = fminf(cut[ni], __shfl_xor_sync(FULL, cut[ni], 1));
        cut[ni] = fminf(cut[ni], __shfl_xor_sync(FULL, cut[ni], 2));
        const int row = 8 * ni + g;
        if (row < nrow)
          cut[ni] = __fadd_rn(cut[ni], __fmul_rn(2.f, xerr[row0 + row]));
      }
    }
  }
#pragma unroll
  for (int ni = 0; ni < NTW; ++ni) {
    lo[ni] = fminf(lo[ni], __shfl_xor_sync(FULL, lo[ni], 1));
    lo[ni] = fminf(lo[ni], __shfl_xor_sync(FULL, lo[ni], 2));
    const int row = 8 * ni + g;
    if (row >= nrow) continue;
    int* out = surv + (row0 + row) * r;
    for (int s = cnt[ni] + t; s < r; s += 4) out[s] = -1;
    if (t == 0) {
      nsv[row0 + row] = cnt[ni];
      lbm[row0 + row] = lo[ni];
    }
  }
}

// The instantiations the launcher picks from, in variant order: 16-byte
// (VB 16) or byte copies, by units of 8 NTW rows (NTW by bn).
const decltype(&candidate_assign_int8_kernel<16, 1>) FNS[] = {
    candidate_assign_int8_kernel<16, 1>, candidate_assign_int8_kernel<16, 2>,
    candidate_assign_int8_kernel<16, 4>, candidate_assign_int8_kernel<1, 1>,
    candidate_assign_int8_kernel<1, 2>, candidate_assign_int8_kernel<1, 4>};
const size_t MAX_BYTES[] = {Unit<1>::max_block_bytes(),
                            Unit<2>::max_block_bytes(),
                            Unit<4>::max_block_bytes()};

template <int NTW>
void plan_unit(int bn, int knp, long long* p) {
  using U = Unit<NTW>;
  const int win = U::one_pass(knp) ? knp : KC;
  p[K2P_SMEM] = (long long)(NW * U::warp_bytes(win));
  p[K2P_COL_EXTENT] = U::ROWS;
  p[K2P_INNER_TILE] = win;
}

// The launch over nb point blocks of bn rows and knp candidates of d bytes;
// aligned: xq and qtab are 16-byte aligned. A warp takes a unit of 8 NTW
// rows of one point block, NW units a CUDA block.
cudaError_t plan(int nb, int bn, int knp, int d, int r, bool aligned,
                 long long* p) {
  if (bn < 1 || knp < 1 || d < 0 || r < 0 || nb < 0)
    return cudaErrorInvalidValue;
  const int ntw = bn <= 8 ? 1 : bn <= 16 ? 2 : 4;
  const int rows_unit = 8 * ntw;
  const long long units = (long long)nb * ((bn + rows_unit - 1) / rows_unit);
  const bool vec = d % 16 == 0 && aligned;
  k2_plan_init(p, (units + NW - 1) / NW, 1, 1, NT, 0,
               (vec ? 0 : 3) + (ntw == 1 ? 0 : ntw == 2 ? 1 : 2), vec ? 1 : 0);
  if (ntw == 1) plan_unit<1>(bn, knp, p);
  else if (ntw == 2) plan_unit<2>(bn, knp, p);
  else plan_unit<4>(bn, knp, p);
  p[K2P_ROWS] = nb;
  p[K2P_COLS] = bn;
  p[K2P_INNER] = knp;
  p[K2P_PER_BLOCK] = NW;
  return cudaSuccess;
}
}  // namespace

K2_DESCRIBE(candidate_assign_int8_tiled, FNS,
            "VB16NTW1,VB16NTW2,VB16NTW4,VB1NTW1,VB1NTW2,VB1NTW4")

K2_EXPORT int k2_plan_candidate_assign_int8_tiled(int nb, int bn, int knp,
                                                  int d, int r, int aligned,
                                                  long long* out) {
  return (int)plan(nb, bn, knp, d, r, aligned != 0, out);
}

// xq: (nb*bn, d) int8; xsc, xerr: (nb*bn,) f32; qtab: (T, knp, d) int8;
// qsc, qerr, csqtab: (T, knp) f32; rowsel, skip: (nb,) i32; outputs surv
// (nb*bn, r) i32, nsv (nb*bn,) i32, lbm (nb*bn,) f32.
K2_EXPORT int k2_candidate_assign_int8_tiled(
    const int8_t* xq, const float* xsc, const float* xerr, const int8_t* qtab,
    const float* qsc, const float* qerr, const float* csqtab,
    const int* rowsel, const int* skip, int* surv, int* nsv, float* lbm,
    int nb, int bn, int knp, int d, int r, cudaStream_t stream) {
  long long p[K2P_WORDS];
  cudaError_t err = plan(nb, bn, knp, d, r,
                         k2_aligned16(xq) && k2_aligned16(qtab), p);
  if (err != cudaSuccess) return (int)err;
  if (nb <= 0) return (int)cudaGetLastError();
  auto kernel = FNS[p[K2P_VARIANT]];
  // opts into the largest window's shared memory, once a device
  k2_resident_blocks(kernel, NT, MAX_BYTES[p[K2P_VARIANT] % 3], err);
  if (err != cudaSuccess) return (int)err;
  const int units_row = (int)p[K2P_COL_EXTENT];
  const long long units = (long long)nb * ((bn + units_row - 1) / units_row);
  kernel<<<k2_grid(p), (unsigned)p[K2P_THREADS], (size_t)p[K2P_SMEM],
           stream>>>(xq, xsc, xerr, qtab, qsc, qerr, csqtab, rowsel, skip,
                     surv, nsv, lbm, bn, knp, d, r, (int)p[K2P_INNER_TILE],
                     units);
  return (int)cudaGetLastError();
}
