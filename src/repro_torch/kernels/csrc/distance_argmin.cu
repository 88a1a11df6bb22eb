// K5: the nearest of all k centers for every point, fused with its squared
// distance: Lloyd's assignment step and the port's assign_nearest.
//
// Replaces the Pallas TPU kernel src/repro/kernels/distance_argmin.py
// (distance_argmin / _kernel): for each point, the argmin over every center
// of max(|x|^2 - 2 x.c + |c|^2, 0) and that minimum, carried across center
// tiles with strict < so ties go to the first center in flat order; the
// (n, k) distance matrix is never written.
//
// Bound on an H100: operations. The work is 2 n k d FLOPs against n d + k d
// floats read once (n=60000, d=784, k=1000: 94 GFLOP, 1.4 ms at 67 TFLOP/s,
// against 0.06 ms for the bytes). The products must stay exact f64 (see
// Rounding), which rules out TF32 and bf16. The first design ran them as
// scalar f64 FMAs on the CUDA cores (34 TFLOP/s on the data sheet, 10.7
// reached) from tiles widened to f64 in shared memory, and each FMA fed on
// half an 8-byte shared load: slower than cuBLAS's f32 call.
//
// Design: the products run on the f64 tensor cores (DMMA, 67 TFLOP/s dense),
// mma.sync m16n8k8 with f64 inputs and f64 sums. One CUDA block of 8 warps
// owns BM = 64 points and walks every center in tiles of BN = 128 (the TPU
// kernel's k-minor grid axis, as a loop inside the block); each warp holds a
// 32 x 32 (point, center) tile of f64 sums in registers, 2 x 4 MMA tiles.
// d is walked in chunks of DC = 64 floats: the point rows and center rows of
// a chunk are copied as f32 into shared memory by cp.async (16 bytes a
// thread where d % 4 == 0 and x, c are 16-byte aligned, else 4), double
// buffered, so the next chunk's copy overlaps this chunk's MMAs; the ring
// runs straight on across center tiles. Values are widened to f64 as a
// fragment is loaded, so shared memory holds and serves 4-byte values.
// Rows are padded to LD = DC + 4 floats: the 32 lanes of a fragment load
// hit 32 banks. Past n, k and d the copies zero-fill (cp.async src-size 0),
// so ragged shapes need no padded copies, and a chunk's MMA steps past d
// are skipped. |x|^2 is summed in f64 in a prologue, a warp a row from
// global memory, while the first chunks land.
//
// Epilogue per center tile: each thread screens its sums (Rounding),
// evaluates its 8 centers of each of its 4 rows in column order and keeps
// the first minimum; a pair the screen cannot decide is set aside unless
// its least possible distance already lies at or above the row's minimum
// so far (then it cannot be the first minimum), and the few set aside are
// recomputed exactly after the tile's loops, out of line, and merged in
// as (distance, center) keys; the 4 lanes that share a row merge by
// shuffles (lower center on a tie), the 4 warps that share a row through
// shared memory in column order, and the row's running (min, argmin)
// takes the tile's only when strictly smaller. |x|^2 is rounded in the
// prologue, where no accumulator is live: an exact recompute beside the
// live accumulators made the main loop spill.
//
// nvcc -Xptxas -v for sm_90a (CUDA 12.8): 118 registers, no spills;
// dynamic shared memory 108,288 bytes (two stages of 192 rows x 68 floats,
// the row norms, the tile's center bounds and merge keys), so two blocks
// an SM. Before the rounding, the kernel reached about 60% of its
// bound, and a copy of it whose MMAs take constants instead of loaded
// fragments ran 95% as long (scripts/probe_kernels.py): the DMMA issue
// rate holds it, not the staging or the widening; 938 blocks of 64 points
// also run in 3.55 waves of 264, the last half empty.
//
// Rounding: each f32 x f32 product is exact in f64, so the MMA's f64 sums
// are the exact sums up to the error of their order, and cuBLAS's DGEMM in
// the plain version sums in another. x.c and |x|^2 are correctly rounded to
// f32 (common.cuh: a screen of each sum against its error bound, then an
// exact recompute of the few it cannot decide), which no order changes;
// |c|^2 comes in rounded the same way (exact_round.exact_sqnorm, taken
// outside the kernel as the TPU kernel's wrapper takes it), and the
// screen's bound on x.c uses it rounded up. The distance is then evaluated
// in f32 with explicit __f*_rn steps in the plain version's order, so the
// kernel and ref.distance_argmin_ref agree bit for bit, and a (point,
// center) pair has the value that K1, K7, the Elkan path and the int8
// re-rank give it. The screen costs two directed roundings and a compare
// per pair in the epilogue, the square roots once per row and center.
#include <math.h>
#include <limits.h>
#include <stdint.h>
#include "common.cuh"

namespace {
constexpr int BM = 64, BN = 128;       // points x centers of a block tile
constexpr int NJ = 4;                  // 8-center MMA tiles of a warp
constexpr int WTN = 8 * NJ;            // a warp's tile: 32 points x WTN centers
constexpr int WM = BM / 32, WN = BN / WTN;
constexpr int NT = 32 * WM * WN;
constexpr int DC = 64;                 // floats of d per stage
constexpr int LD = DC + 4;             // padded row stride in shared memory
constexpr int STAGES = 2;            // double-buffered
constexpr int STAGE_FLOATS = (BM + BN) * LD;
constexpr size_t SMEM_BYTES =
    sizeof(float) * STAGES * STAGE_FLOATS + sizeof(double) * (BM + BN) +
    sizeof(unsigned long long) * WN * BM + sizeof(float) * BM;

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// Copy chunk t0 of the point rows row0.. and center rows c0.. into one
// stage: BM + BN rows of DC floats, zero past n, k and d.
template <int VEC>
__device__ __forceinline__ void load_chunk(float* st, const float* x,
                                           const float* c, size_t row0,
                                           int c0, int t0, int n, int k,
                                           int d) {
  constexpr int PER_ROW = DC / VEC;
  for (int e = threadIdx.x; e < (BM + BN) * PER_ROW; e += NT) {
    const int r = e / PER_ROW, j = (e % PER_ROW) * VEC;
    const bool is_x = r < BM;
    const size_t g = is_x ? row0 + r : (size_t)(c0 + r - BM);
    const bool ok = g < (size_t)(is_x ? n : k) && t0 + j < d;
    const float* base = is_x ? x : c;
    cp_async(st + r * LD + j, ok ? base + g * d + t0 + j : base, ok,
             VEC * 4);
  }
}

// The pairs a warp's screen flagged (bit ((i * 2 + h) * NJ + j) * 2 + e
// of each lane's mask): recomputed exactly a warp at a time, then merged
// into their row's key. Out of line, so that the kernel's main loop keeps
// its registers.
__device__ __noinline__ void recompute_flagged(
    unsigned flagged, unsigned long long* red, const float* xs2s,
    const float* x, const float* c, const float* csq, size_t row0, int cw0,
    int rw0, int t, int d) {
  while (__any_sync(0xffffffffu, flagged)) {
    const bool need = flagged != 0;
    const int bit = need ? __ffs(flagged) - 1 : 0;
    flagged &= flagged - 1;
    const int e = bit & 1, j = (bit >> 1) % NJ, ih = (bit >> 1) / NJ;
    const int r = rw0 + (ih >> 1) * 16 + (ih & 1) * 8;
    const int cc = cw0 + j * 8 + 2 * t + e;
    const float cross = k2_exact_dot_lanes(need, x + (row0 + r) * d, 1,
                                           c + (size_t)cc * d, 1, d);
    const float dq = fmaxf(
        __fadd_rn(__fsub_rn(xs2s[r], __fmul_rn(2.f, cross)), csq[cc]), 0.f) +
                     0.f;
    if (need)
      atomicMin(&red[r],
                ((unsigned long long)__float_as_uint(dq) << 32) |
                    (unsigned)cc);
  }
}

template <int VEC>
__global__ void __launch_bounds__(NT, 2)
distance_argmin_kernel(const float* __restrict__ x,
                       const float* __restrict__ c,
                       const float* __restrict__ csq, int* __restrict__ a,
                       float* __restrict__ dmin, int n, int k, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  // per row: the screen's gamma_d |x| (from the f64 |x|^2), beside the
  // correctly rounded f32 |x|^2
  double* xsq = reinterpret_cast<double*>(ring + STAGES * STAGE_FLOATS);
  double* cns = xsq + BM;            // per tile center: sqrt of |c|^2's bound
  // per (warp column, row): the (distance, center) first minimum as one
  // key, distance bits high (non-negative floats order as their bits)
  unsigned long long* red = reinterpret_cast<unsigned long long*>(cns + BN);
  float* xs2s = reinterpret_cast<float*>(red + WN * BM);

  const size_t row0 = (size_t)blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / WN, wn = warp % WN;   // rows wm*32, centers wn*WTN
  const int nkc = max(1, (d + DC - 1) / DC);
  const int steps = ((k + BN - 1) / BN) * nkc;

  double acc[2][NJ][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;
  float best = INFINITY;               // running (min, argmin) of row tid < BM
  int arg = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps)
      load_chunk<VEC>(ring + s * STAGE_FLOATS, x, c, row0, (s / nkc) * BN,
                      (s % nkc) * DC, n, k, d);
    cp_async_commit();
  }
  // each row's correctly rounded |x|^2, a warp a row, while the first
  // chunks land: here no accumulator is live, so the rare exact recompute
  // costs the main loop no registers
  for (int r = warp; r < BM; r += NT / 32) {
    const bool live = row0 + r < (size_t)n;
    const float* xr = x + (row0 + r) * d;
    double s2 = 0.0;
    if (live)
      for (int j = lane; j < d; j += 32) {
        const double v = xr[j];
        s2 = fma(v, v, s2);
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    const float v = k2_round_sum_uniform(s2, k2_gamma(d) * s2, xr, 1, xr, 1,
                                         d);
    if (lane == 0) {
      xs2s[r] = v;
      xsq[r] = k2_gamma(d) * sqrt(s2);
    }
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                   // chunk `step` landed; stage step-1 free
    {
      const int nx = step + STAGES - 1;
      if (nx < steps)
        load_chunk<VEC>(ring + (nx % STAGES) * STAGE_FLOATS, x, c, row0,
                        (nx / nkc) * BN, (nx % nkc) * DC, n, k, d);
      cp_async_commit();
    }
    const int ct = step / nkc, kc = step % nkc, t0 = kc * DC;
    const float* xs = ring + (step % STAGES) * STAGE_FLOATS;
    const float* cs = xs + BM * LD;
#pragma unroll
    for (int kk = 0; kk < DC / 8; ++kk) {
      if (t0 + kk * 8 >= d) break;     // the rest of the chunk is zero
      double af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* p = xs + (wm * 32 + i * 16 + g) * LD + kk * 8 + t;
        af[i][0] = p[0];
        af[i][1] = p[8 * LD];
        af[i][2] = p[4];
        af[i][3] = p[8 * LD + 4];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* p = cs + (wn * WTN + j * 8 + g) * LD + kk * 8 + t;
        const double bf[2] = {p[0], p[4]};
#pragma unroll
        for (int i = 0; i < 2; ++i) dmma(acc[i][j], af[i], bf);
      }
    }
    if (kc != nkc - 1) continue;

    // --- epilogue of center tile ct -------------------------------------
    const int c0 = ct * BN;
    if (threadIdx.x < BN)
      cns[threadIdx.x] = c0 + (int)threadIdx.x < k
                             ? sqrt(k2_sqnorm_up(csq[c0 + threadIdx.x]))
                             : 0.0;
    __syncthreads();
    unsigned flagged = 0;              // pairs the screen left undecided
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + i * 16 + h * 8 + g;
        const float xs2 = xs2s[r];
        const double ex = xsq[r];
        float v = INFINITY;
        int col = INT_MAX;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = c0 + wn * WTN + j * 8 + 2 * t + e;
            if (cc >= k) continue;
            // the screen; where it cannot decide, dq is the least distance
            // the pair can have (its x.c rounded up: every step is
            // monotone), and a later column at or above this row's minimum
            // so far cannot be the row's first minimum: only the others
            // are recomputed
            const double s = acc[i][j][2 * h + e], eb = ex * cns[cc - c0];
            const float up = __double2float_rn(__dadd_ru(s, eb));
            const float lo = __double2float_rn(__dsub_rd(s, eb));
            const float dq = fmaxf(
                __fadd_rn(__fsub_rn(xs2, __fmul_rn(2.f, up)), csq[cc]), 0.f) +
                             0.f;
            if (lo != up) {
              if (dq < v) flagged |= 1u << (((i * 2 + h) * NJ + j) * 2 + e);
              continue;
            }
            if (dq < v) {
              v = dq;
              col = cc;
            }
          }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {   // the 4 lanes of row r
          const float ov = __shfl_xor_sync(0xffffffffu, v, o);
          const int oc = __shfl_xor_sync(0xffffffffu, col, o);
          if (ov < v || (ov == v && oc < col)) {
            v = ov;
            col = oc;
          }
        }
        if (t == 0)
          red[wn * BM + r] =
              ((unsigned long long)__float_as_uint(v) << 32) | (unsigned)col;
      }
    __syncwarp();
    if (__any_sync(0xffffffffu, flagged))    // rare, and out of line
      recompute_flagged(flagged, red + wn * BM, xs2s, x, c, csq, row0,
                        c0 + wn * WTN, wm * 32 + g, t, d);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;
    __syncthreads();
    if (threadIdx.x < BM) {            // the warps in column order
      unsigned long long key = red[threadIdx.x];
#pragma unroll
      for (int w = 1; w < WN; ++w) key = min(key, red[w * BM + threadIdx.x]);
      const float v = __uint_as_float((unsigned)(key >> 32));
      const int col = (int)(key & 0xffffffffu);
      if (v < best) {
        best = v;
        arg = col;
      }
    }
  }
  cp_async_wait<0>();
  if (threadIdx.x < BM && row0 + threadIdx.x < (size_t)n) {
    a[row0 + threadIdx.x] = arg;
    dmin[row0 + threadIdx.x] = best;
  }
}

template <int VEC>
int launch(const float* x, const float* c, const float* csq, int* a,
           float* dmin, int n, int k, int d, cudaStream_t stream) {
  const cudaError_t err =
      k2_set_smem(distance_argmin_kernel<VEC>, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  distance_argmin_kernel<VEC><<<(n + BM - 1) / BM, NT, SMEM_BYTES, stream>>>(
      x, c, csq, a, dmin, n, k, d);
  return (int)cudaGetLastError();
}
}  // namespace

// x: (n, d) f32; c: (k, d) f32; csq: (k,) f32 exactly rounded |c|^2;
// outputs a (n,) i32 and dmin (n,) f32. k >= 1.
K2_EXPORT int k2_distance_argmin(const float* x, const float* c,
                                 const float* csq, int* a, float* dmin, int n,
                                 int k, int d, cudaStream_t stream) {
  if (n < 0 || k < 1 || d < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const bool vec = d % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)c % 16 == 0;
  return vec ? launch<4>(x, c, csq, a, dmin, n, k, d, stream)
             : launch<1>(x, c, csq, a, dmin, n, k, d, stream);
}
