// Correctly rounded |x|^2 and x.c for the torch code around the kernels:
// the value RN_f32(exact) that K1, K5 and K7 give a pair (common.cuh).
//
// Not a port of a TPU kernel. The reference forms these sums in f32 in its
// jnp glue (XLA); the port forms them in f64 and rounds once, and these
// kernels make that one rounding correct, so that every path gives a pair
// one value:
// - k2_exact_sqnorm: the f64 sum of squares of each row (one warp a row,
//   lanes striding over d, a butterfly join), screened and, where the
//   screen cannot decide, recomputed exactly by the warp;
// - k2_exact_split_sqnorms: GDI's two split-score norms in one pass over
//   K3's prefix sums, |csum[r]|^2 and |tot[seg[r]] - csum[r]|^2, the
//   suffix formed in registers and never stored (below);
// - k2_exact_cross: a @ b with every element correctly rounded, the f64
//   products on the f64 tensor cores and the rounding in their epilogue
//   (below);
// - k2_exact_rowdot: x[i] . y[idx[i]] for each row i (GDI's projections),
//   one warp a row, screened with the two rows' f64 norms, which the warp
//   sums beside the product.
// The row kernels are bound by bytes: one read of their input, one write
// of the f32 output. The exact fallback runs for a few elements in a
// hundred thousand and reads its two rows again from global memory.
//
// k2_exact_split_sqnorms. GDI scores each split row r of a leaf by the
// prefix norm |csum[r]|^2 and the suffix norm |tot - csum[r]|^2, tot the
// leaf's total. Two calls of k2_exact_sqnorm would need the (R, d) suffix
// in memory: a gather of the totals and a subtraction that write two (R,
// d) tensors and read three, where the scores need one read of csum (the
// leaf totals, k rows, stay in L2). One warp a row, rows in a grid-stride
// loop, 16-byte loads where d % 4 == 0 and both tensors are 16-byte
// aligned; each suffix element is the f32 __fsub_rn(tot, csum), the value
// torch's subtraction gives (a lone subtraction: there is no product for
// the compiler to contract into an FMA, and the intrinsic forbids it
// anyway). Both f64 sums are screened with gamma_d s; a flagged suffix
// is recomputed by the warp through a loader that forms tot - csum again,
// since there is no suffix row in memory to read.
//
// k2_exact_cross. The products take 2 m k d operations against (m + k) d
// floats read and m k written: at a predict batch's (8192 x 784) by (784 x
// 1000), 12.85 GFLOP, 0.19 ms at the f64 tensor cores' 67 TFLOP/s, against
// 0.02 ms for the bytes. The design is K5's (distance_argmin.cu): mma.sync
// m16n8k8 in f64 from f32 tiles copied by cp.async into a two-stage ring
// (16 bytes a thread where both operands run contiguously along d and are
// 16-byte aligned, else 4 bytes at any element strides), widened to f64
// as a fragment is loaded, zero-filled past m, k and d. A block of 8 warps
// (4 where BN = 64) owns BM = 64 rows of a and walks a run of BN-column
// tiles of b (BN = 128, or 64 where k <= 64), the ring running straight
// across them, each warp a 32 x 32 tile of f64 sums in registers; the
// launcher splits the column tiles over as many blocks as fill the card's
// slots in the fewest waves. The epilogue is a store: each sum is screened
// against gamma_d |a_i| |b_j|, each norm bounded from its f32 squared
// norm rounded up (k2_sqnorm_up): the correctly rounded ones the caller
// has (quant.sqdist_exact has both, as K5's wrapper has |c|^2), or sums
// rounded up by a small prologue kernel, norms_kernel, from the operands
// as they lie (no widened copy). The few sums the screen flags are marked
// in a bitmap in shared memory (a bit per row and column the block walks,
// 4 KB) and recomputed once the block's loop is done, each by a whole
// warp: with the recompute called inside the loop, as K5 calls it, the
// main loop spilled at its 128 registers and took four times as long
// (scripts/probe_kernels.py). Integer operands do not come here: they
// multiply exactly in f64 in the wrapper.
#include <limits.h>
#include <stdint.h>
#include "common.cuh"

namespace {
constexpr int NT = 256;

// The suffix's element i as both factors of its square: the f32
// difference tot[i] - csum[i], rounded to nearest.
struct SuffixSquare {
  const float* tot;
  const float* csum;
  __device__ __forceinline__ float2 operator()(int i) const {
    const float s = __fsub_rn(tot[i], csum[i]);
    return make_float2(s, s);
  }
};

__device__ __forceinline__ void add_split(float c, float t, double& sp,
                                          double& ss) {
  const double cd = c, sd = __fsub_rn(t, c);
  sp = fma(cd, cd, sp);
  ss = fma(sd, sd, ss);
}

template <int VEC>
__global__ void __launch_bounds__(NT)
exact_split_sqnorms_kernel(const float* __restrict__ csum,
                           const float* __restrict__ tot,
                           const long long* __restrict__ row_seg,
                           float* __restrict__ out_p,
                           float* __restrict__ out_s, long long rows,
                           int d) {
  const int lane = threadIdx.x % 32;
  const long long step = (long long)gridDim.x * (NT / 32);
  const double gam = k2_gamma(d);
  for (long long r = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
       r < rows; r += step) {             // the same r in the whole warp
    const float* cr = csum + r * d;
    const float* tr = tot + row_seg[r] * d;
    double sp = 0.0, ss = 0.0;
    if (VEC == 4) {
      const float4* c4 = reinterpret_cast<const float4*>(cr);
      const float4* t4 = reinterpret_cast<const float4*>(tr);
#pragma unroll 4
      for (int j = lane; j < d / 4; j += 32) {
        const float4 c = __ldcs(c4 + j);    // read once: stream past L2
        const float4 t = __ldg(t4 + j);     // a leaf's total: kept in L2
        add_split(c.x, t.x, sp, ss);
        add_split(c.y, t.y, sp, ss);
        add_split(c.z, t.z, sp, ss);
        add_split(c.w, t.w, sp, ss);
      }
    } else {
      for (int j = lane; j < d; j += 32) add_split(cr[j], tr[j], sp, ss);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sp += __shfl_xor_sync(0xffffffffu, sp, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float vp = k2_round_sum_uniform(sp, gam * sp, cr, 1, cr, 1, d);
    float vs;
    if (!k2_screen(ss, gam * ss, vs))
      vs = k2_exact_dot_tiers(SuffixSquare{tr, cr}, d);
    if (lane == 0) {
      out_p[r] = vp;
      out_s[r] = vs;
    }
  }
}

// --- exact_cross on the f64 tensor cores ---------------------------------
constexpr int BM = 64;                 // rows of a per block
constexpr int NJ = 4;                  // 8-column MMA tiles of a warp
constexpr int WTN = 8 * NJ;            // a warp's tile: 32 rows x WTN columns
constexpr int DC = 64;                 // floats of d per stage
constexpr int LD = DC + 4;             // padded row stride: 32 banks a load
constexpr int STAGES = 2;
constexpr int MAXCOLS = 512;           // columns of b a block walks, at most
constexpr int FLAG_WORDS = BM * MAXCOLS / 32;  // a bit per (row, column)

template <int BN>
struct CrossTile {
  static constexpr int WM = BM / 32, WN = BN / WTN, NT = 32 * WM * WN;
  static constexpr int STAGE_FLOATS = (BM + BN) * LD;
  static constexpr size_t SMEM = sizeof(float) * STAGES * STAGE_FLOATS +
                                 sizeof(double) * (BM + BN) +
                                 sizeof(unsigned) * FLAG_WORDS;
};

// One operand as the kernel reads it: element (row, j) of batch entry t at
// p + t * st + row * sr + j * sd (a's rows, or b's columns as rows).
struct Operand {
  const float* p;
  long long st, sr, sd;
};

// Copy chunk t0 of a's rows row0.. and b's columns c0.. into one stage:
// BM + BN rows of DC floats, zero past m, k and d.
template <int VEC, int BN>
__device__ __forceinline__ void load_chunk(float* st, const float* a,
                                           const Operand& A, const float* b,
                                           const Operand& B, int row0, int c0,
                                           int t0, int m, int k, int d) {
  constexpr int PER_ROW = DC / VEC;
  for (int e = threadIdx.x; e < (BM + BN) * PER_ROW;
       e += CrossTile<BN>::NT) {
    const int r = e / PER_ROW, j = (e % PER_ROW) * VEC;
    const bool is_a = r < BM;
    const int g = is_a ? row0 + r : c0 + r - BM;
    const bool ok = g < (is_a ? m : k) && t0 + j < d;
    const float* src = is_a ? a + g * A.sr + (t0 + j) * A.sd
                            : b + g * B.sr + (t0 + j) * B.sd;
    k2_cp_async(st + r * LD + j, ok ? src : a, ok, VEC * 4);
  }
}

// The sums the block's screens marked (bit r * MAXCOLS + c of flags: row
// row0 + r, column col0 + c), recomputed exactly, each by a whole warp,
// and stored. Called once, after the block's loop: a call inside it made
// the main loop spill.
__device__ __noinline__ void recompute_marked(
    const unsigned* flags, const float* a, long long sar, long long sad,
    const float* b, long long sbr, long long sbd, float* out, int row0,
    int col0, int k, int d) {
  const int lane = threadIdx.x % 32, nw = blockDim.x / 32;
  for (int w0 = threadIdx.x / 32 * 32; w0 < FLAG_WORDS; w0 += nw * 32) {
    const unsigned bits = flags[w0 + lane];
    unsigned any = __ballot_sync(0xffffffffu, bits != 0);
    while (any) {
      const int src = __ffs(any) - 1;
      any &= any - 1;
      unsigned bb = __shfl_sync(0xffffffffu, bits, src);
      while (bb) {
        const int e = (w0 + src) * 32 + __ffs(bb) - 1;
        bb &= bb - 1;
        const int r = row0 + e / MAXCOLS, c = col0 + e % MAXCOLS;
        const float v = k2_exact_dot_tiers(
            K2Strided{a + r * sar, sad, b + c * sbr, sbd}, d);
        if (lane == 0) out[(long long)r * k + c] = v;
      }
    }
  }
}

// Block (x, y, z): rows x * BM.. of batch entry z, against column tiles
// y * tpb .. (y + 1) * tpb - 1 of it (tpb * BN <= MAXCOLS). asq (nbat, m)
// and bsq (nbat, k): |a_i|^2 and |b_j|^2 in f32, at most 2^-24 below the
// exact value relatively (2^-150 absolutely).
template <int VEC, int BN>
__global__ void __launch_bounds__(CrossTile<BN>::NT, 2)
exact_cross_kernel(Operand A, Operand B, const float* __restrict__ asq,
                   const float* __restrict__ bsq, float* __restrict__ out,
                   int m, int k, int d, int tpb) {
  using T = CrossTile<BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  double* nas = reinterpret_cast<double*>(ring + STAGES * T::STAGE_FLOATS);
  double* nbs = nas + BM;              // the tile's column bounds
  unsigned* flags = reinterpret_cast<unsigned*>(nbs + BN);

  const long long bt = blockIdx.z;
  const float* a = A.p + bt * A.st;
  const float* b = B.p + bt * B.st;
  out += bt * m * (long long)k;
  asq += bt * m;
  bsq += bt * k;
  const int row0 = blockIdx.x * BM;
  const int kt = (k + BN - 1) / BN;
  const int ct0 = blockIdx.y * tpb, ct1 = min(ct0 + tpb, kt);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / T::WN, wn = warp % T::WN;
  const int nkc = max(1, (d + DC - 1) / DC);
  const int steps = (ct1 - ct0) * nkc;
  const double gam = k2_gamma(d);

  double acc[2][NJ][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;

  if (steps > 0)
    load_chunk<VEC, BN>(ring, a, A, b, B, row0, ct0 * BN, 0, m, k, d);
  k2_cp_commit();
  if (threadIdx.x < BM)
    nas[threadIdx.x] =
        row0 + (int)threadIdx.x < m
            ? gam * sqrt(k2_sqnorm_up(asq[row0 + threadIdx.x])) : 0.0;
  for (int i = threadIdx.x; i < FLAG_WORDS; i += T::NT) flags[i] = 0;
  for (int step = 0; step < steps; ++step) {
    k2_cp_wait<0>();
    __syncthreads();                   // chunk `step` landed; the other free
    {
      const int nx = step + 1;
      if (nx < steps)
        load_chunk<VEC, BN>(ring + (nx % STAGES) * T::STAGE_FLOATS, a, A, b,
                            B, row0, (ct0 + nx / nkc) * BN, (nx % nkc) * DC,
                            m, k, d);
      k2_cp_commit();
    }
    const int ct = ct0 + step / nkc, kc = step % nkc, t0 = kc * DC;
    const float* as = ring + (step % STAGES) * T::STAGE_FLOATS;
    const float* bs = as + BM * LD;
#pragma unroll
    for (int kk = 0; kk < DC / 8; ++kk) {
      if (t0 + kk * 8 >= d) break;     // the rest of the chunk is zero
      double af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* p = as + (wm * 32 + i * 16 + g) * LD + kk * 8 + t;
        af[i][0] = p[0];
        af[i][1] = p[8 * LD];
        af[i][2] = p[4];
        af[i][3] = p[8 * LD + 4];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* p = bs + (wn * WTN + j * 8 + g) * LD + kk * 8 + t;
        const double bf[2] = {p[0], p[4]};
#pragma unroll
        for (int i = 0; i < 2; ++i) k2_dmma(acc[i][j], af[i], bf);
      }
    }
    if (kc != nkc - 1) continue;

    // --- epilogue of column tile ct: screen, store ----------------------
    const int c0 = ct * BN;
    if (threadIdx.x < BN)
      nbs[threadIdx.x] = c0 + (int)threadIdx.x < k
                             ? sqrt(k2_sqnorm_up(bsq[c0 + threadIdx.x]))
                             : 0.0;
    __syncthreads();
    const int fc0 = (ct - ct0) * BN;   // the tile's first flag column
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + i * 16 + h * 8 + g;
        if (row0 + r >= m) continue;
        float* orow = out + (long long)(row0 + r) * k;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = wn * WTN + j * 8 + 2 * t + e;
            if (c0 + cc >= k) continue;
            float v;
            if (k2_screen(acc[i][j][2 * h + e], nas[r] * nbs[cc], v)) {
              orow[c0 + cc] = v;
            } else {                   // rare: recomputed after the loop
              const int f = r * MAXCOLS + fc0 + cc;
              atomicOr(&flags[f / 32], 1u << (f % 32));
            }
          }
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;
  }
  k2_cp_wait<0>();
  __syncthreads();                     // every mark set
  recompute_marked(flags, a, A.sr, A.sd, b, B.sr, B.sd, out, row0, ct0 * BN,
                   k, d);
}

// Each row's f64 sum of squares rounded up to f32 (at least the exact sum
// less its f64 error, far inside what k2_sqnorm_up allows), one warp a
// row: row r of batch entry t at x.p + t * x.st + r * x.sr, elements x.sd
// apart.
__global__ void __launch_bounds__(NT)
norms_kernel(Operand x, float* __restrict__ out, int nbat, int rows,
             int d) {
  const long long w = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= (long long)nbat * rows) return;   // a whole warp
  const float* xr = x.p + (w / rows) * x.st + (w % rows) * x.sr;
  double s = 0.0;
  for (int j = lane; j < d; j += 32) {
    const double v = xr[j * x.sd];
    s = fma(v, v, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) out[w] = __double2float_ru(s);
}

__global__ void __launch_bounds__(NT)
exact_rowdot_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const long long* __restrict__ idx,
                    float* __restrict__ out, long long rows, int d) {
  const long long r = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;               // a whole warp
  const float* xr = x + r * d;
  const float* yr = y + idx[r] * d;
  double s = 0.0, nx = 0.0, ny = 0.0;
  for (int j = lane; j < d; j += 32) {
    const double a = xr[j], b = yr[j];
    s = fma(a, b, s);
    nx = fma(a, a, nx);
    ny = fma(b, b, ny);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    nx += __shfl_xor_sync(0xffffffffu, nx, o);
    ny += __shfl_xor_sync(0xffffffffu, ny, o);
  }
  const float v = k2_round_sum_uniform(s, k2_gamma(d) * sqrt(nx * ny), xr, 1,
                                       yr, 1, d);
  if (lane == 0) out[r] = v;
}

// The instantiations the launchers pick from, in variant order.
const decltype(&k2_exact_sqnorm_kernel<NT>) SQNORM_FNS[] = {
    k2_exact_sqnorm_kernel<NT>};
const decltype(&exact_rowdot_kernel) ROWDOT_FNS[] = {exact_rowdot_kernel};
const decltype(&exact_split_sqnorms_kernel<1>) SPLIT_FNS[] = {
    exact_split_sqnorms_kernel<1>, exact_split_sqnorms_kernel<4>};
// column tiles of 64 (k <= 64) or 128, 4- or 16-byte copies
const decltype(&exact_cross_kernel<1, 64>) CROSS_FNS[] = {
    exact_cross_kernel<1, 64>, exact_cross_kernel<4, 64>,
    exact_cross_kernel<1, 128>, exact_cross_kernel<4, 128>};
const int CROSS_NT[] = {CrossTile<64>::NT, CrossTile<64>::NT,
                        CrossTile<128>::NT, CrossTile<128>::NT};
const size_t CROSS_SMEM[] = {CrossTile<64>::SMEM, CrossTile<64>::SMEM,
                             CrossTile<128>::SMEM, CrossTile<128>::SMEM};

// One warp a row (NT / 32 rows a block) over rows of d floats: the plans of
// exact_sqnorm and exact_rowdot.
void plan_rows(long long rows, int d, long long* p) {
  k2_plan_init(p, (rows + NT / 32 - 1) / (NT / 32), 1, 1, NT, 0, 0, -1);
  p[K2P_ROWS] = rows;
  p[K2P_ROW_EXTENT] = NT / 32;
  p[K2P_INNER] = d;
  p[K2P_INNER_TILE] = 32;
}

// exact_split_sqnorms: persistent, as many blocks as are resident (at most
// one a warp-group of rows), each striding over the rows' groups of NT / 32;
// aligned: csum and tot are 16-byte aligned.
cudaError_t plan_split(long long rows, int d, bool aligned, long long* p) {
  if (rows < 0 || d < 0) return cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && aligned;
  cudaError_t err;
  const long long slots =
      k2_resident_blocks(SPLIT_FNS[vec ? 1 : 0], NT, 0, err);
  if (err != cudaSuccess) return err;
  const long long need = (rows + NT / 32 - 1) / (NT / 32);
  const long long grid = min(need, slots);
  k2_plan_init(p, grid, 1, 1, NT, 0, vec ? 1 : 0, vec ? 1 : 0);
  p[K2P_ROWS] = rows;
  p[K2P_ROW_EXTENT] = NT / 32;
  p[K2P_INNER] = d;
  p[K2P_INNER_TILE] = 32 * (vec ? 4 : 1);
  p[K2P_STRIDE] = grid;
  p[K2P_RESIDENT] = slots;
  return cudaSuccess;
}

// exact_cross over nbat (m, d) x (d, k) products with vec the 16-byte path:
// a block takes BM rows by tpb column tiles, tpb chosen for the fewest
// waves of resident blocks, each block's steps plus one tile for its
// ring's fill, fewer splits on a tie; batches beyond 65,535 launch again.
cudaError_t plan_cross(int nbat, int m, int k, int d, bool vec,
                       long long* p) {
  if (nbat < 0 || m < 0 || k < 0 || d < 0) return cudaErrorInvalidValue;
  const int v = (k <= 64 ? 0 : 2) + (vec ? 1 : 0);
  const int bn = k <= 64 ? 64 : 128;
  cudaError_t err;
  const long long slots =
      k2_resident_blocks(CROSS_FNS[v], CROSS_NT[v], CROSS_SMEM[v], err);
  if (err != cudaSuccess) return err;
  const int mt = (m + BM - 1) / BM, kt = (k + bn - 1) / bn;
  const int zb = max(1, min(nbat, 65535));
  int tpb = 1;
  long long best = LLONG_MAX;
  for (int s = 1; s <= kt; ++s) {
    const int per = (kt + s - 1) / s;
    if (per * bn > MAXCOLS) continue;
    const long long blocks = (long long)mt * zb * ((kt + per - 1) / per);
    const long long cost = (blocks + slots - 1) / slots * (per + 1);
    if (cost < best) {
      best = cost;
      tpb = per;
    }
  }
  k2_plan_init(p, mt, (kt + tpb - 1) / tpb, zb, CROSS_NT[v], CROSS_SMEM[v], v,
               vec ? 1 : 0);
  p[K2P_LAUNCHES] = (nbat + zb - 1) / zb;
  p[K2P_ROWS] = m;
  p[K2P_ROW_EXTENT] = BM;
  p[K2P_COLS] = k;
  p[K2P_COL_EXTENT] = (long long)tpb * bn;
  p[K2P_BATCH] = nbat;
  p[K2P_INNER] = d;
  p[K2P_INNER_TILE] = DC;
  p[K2P_RESIDENT] = slots;
  return cudaSuccess;
}

bool cross_vec(const float* a, const float* b, int d, long long sat,
               long long sam, long long sad, long long sbt, long long sbd,
               long long sbk) {
  return d % 4 == 0 && sad == 1 && sbd == 1 && k2_aligned16(a) &&
         k2_aligned16(b) && sam % 4 == 0 && sbk % 4 == 0 && sat % 4 == 0 &&
         sbt % 4 == 0;
}
}  // namespace

K2_DESCRIBE(exact_sqnorm, SQNORM_FNS, "NT256")
K2_DESCRIBE(exact_rowdot, ROWDOT_FNS, "NT256")
K2_DESCRIBE(exact_split_sqnorms, SPLIT_FNS, "VEC1,VEC4")
K2_DESCRIBE(exact_cross, CROSS_FNS, "BN64/v1,BN64/v4,BN128/v1,BN128/v4")

K2_EXPORT int k2_plan_exact_sqnorm(long long rows, int d, long long* out) {
  if (rows < 0 || d < 0) return (int)cudaErrorInvalidValue;
  plan_rows(rows, d, out);
  return 0;
}

K2_EXPORT int k2_plan_exact_rowdot(long long rows, int d, long long* out) {
  return k2_plan_exact_sqnorm(rows, d, out);
}

K2_EXPORT int k2_plan_exact_split_sqnorms(long long rows, int d, int aligned,
                                          long long* out) {
  return (int)plan_split(rows, d, aligned != 0, out);
}

// The strides as k2_exact_cross takes them; aligned: a and b are 16-byte
// aligned.
K2_EXPORT int k2_plan_exact_cross(int nbat, int m, int k, int d,
                                  long long sat, long long sam, long long sad,
                                  long long sbt, long long sbd, long long sbk,
                                  int aligned, long long* out) {
  const bool vec = aligned && d % 4 == 0 && sad == 1 && sbd == 1 &&
                   sam % 4 == 0 && sbk % 4 == 0 && sat % 4 == 0 &&
                   sbt % 4 == 0;
  return (int)plan_cross(nbat, m, k, d, vec, out);
}

// x: (rows, d) f32 contiguous; out: (rows,) f32.
K2_EXPORT int k2_exact_sqnorm(const float* x, float* out, long long rows,
                              int d, cudaStream_t stream) {
  long long p[K2P_WORDS];
  if (k2_plan_exact_sqnorm(rows, d, p) != 0)
    return (int)cudaErrorInvalidValue;
  auto kern = SQNORM_FNS[p[K2P_VARIANT]];
  if (rows > 0)
    kern<<<k2_grid(p), (unsigned)p[K2P_THREADS], (size_t)p[K2P_SMEM],
           stream>>>(x, out, rows, d);
  return (int)cudaGetLastError();
}

// csum: (rows, d) f32 and tot: (k, d) f32, contiguous; row_seg: (rows,)
// int64 in [0, k); out_p, out_s: (rows,) f32, |csum[r]|^2 and
// |tot[row_seg[r]] - csum[r]|^2, each correctly rounded.
K2_EXPORT int k2_exact_split_sqnorms(const float* csum, const float* tot,
                                     const long long* row_seg, float* out_p,
                                     float* out_s, long long rows, int d,
                                     cudaStream_t stream) {
  if (rows < 0 || d < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  long long p[K2P_WORDS];
  const cudaError_t err =
      plan_split(rows, d, k2_aligned16(csum) && k2_aligned16(tot), p);
  if (err != cudaSuccess) return (int)err;
  auto kern = SPLIT_FNS[p[K2P_VARIANT]];
  kern<<<k2_grid(p), (unsigned)p[K2P_THREADS], (size_t)p[K2P_SMEM],
         stream>>>(csum, tot, row_seg, out_p, out_s, rows, d);
  return (int)cudaGetLastError();
}

// a: (nbat, m, d) and b: (nbat, d, k) f32 with the element strides given
// (sat, sam, sad; sbt, sbd, sbk); asq: (nbat, m) and bsq: (nbat, k) f32,
// the correctly rounded squared norms of a's rows and b's columns, or
// null, and then taken here from a and b; out: (nbat, m, k) f32
// contiguous, each element RN_f32 of its exact sum (a zero as +0).
// scratch: (nbat * (m + k)) f32, used only when asq or bsq is null.
K2_EXPORT int k2_exact_cross(const float* a, const float* b, const float* asq,
                             const float* bsq, float* out, float* scratch,
                             int nbat, int m, int k, int d, long long sat,
                             long long sam, long long sad, long long sbt,
                             long long sbd, long long sbk,
                             cudaStream_t stream) {
  if (nbat < 0 || m < 0 || k < 0 || d < 0) return (int)cudaErrorInvalidValue;
  if ((long long)nbat * m * k == 0) return (int)cudaGetLastError();
  const Operand A{a, sat, sam, sad}, B{b, sbt, sbk, sbd};
  if (asq == nullptr || bsq == nullptr) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    const Operand* ops[2] = {&A, &B};
    const int rows[2] = {m, k};
    const float* given[2] = {asq, bsq};
    float* dst[2] = {scratch, scratch + (long long)nbat * m};
    for (int o = 0; o < 2; ++o) {
      if (given[o] != nullptr) continue;
      const long long warps = (long long)nbat * rows[o];
      norms_kernel<<<(unsigned)((warps + NT / 32 - 1) / (NT / 32)), NT, 0,
                     stream>>>(*ops[o], dst[o], nbat, rows[o], d);
    }
    if (asq == nullptr) asq = dst[0];
    if (bsq == nullptr) bsq = dst[1];
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  long long p[K2P_WORDS];
  cudaError_t err =
      plan_cross(nbat, m, k, d, cross_vec(a, b, d, sat, sam, sad, sbt, sbd,
                                          sbk), p);
  if (err != cudaSuccess) return (int)err;
  auto kernel = CROSS_FNS[p[K2P_VARIANT]];
  const int zb = (int)p[K2P_GRID_Z];
  for (int t0 = 0; t0 < nbat; t0 += zb) {
    const int nz = min(zb, nbat - t0);
    Operand a2 = A, b2 = B;
    a2.p += t0 * A.st;
    b2.p += t0 * B.st;
    kernel<<<dim3((unsigned)p[K2P_GRID_X], (unsigned)p[K2P_GRID_Y], nz),
             (unsigned)p[K2P_THREADS], (size_t)p[K2P_SMEM], stream>>>(
        a2, b2, asq + (long long)t0 * m, bsq + (long long)t0 * k,
        out + (long long)t0 * m * k, m, k, d,
        (int)(p[K2P_COL_EXTENT] / (k <= 64 ? 64 : 128)));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// x: (rows, d) f32 and y: (m, d) f32, contiguous; idx: (rows,) int64 in
// [0, m); out: (rows,) f32.
K2_EXPORT int k2_exact_rowdot(const float* x, const float* y,
                              const long long* idx, float* out,
                              long long rows, int d, cudaStream_t stream) {
  long long p[K2P_WORDS];
  if (k2_plan_exact_rowdot(rows, d, p) != 0)
    return (int)cudaErrorInvalidValue;
  auto kern = ROWDOT_FNS[p[K2P_VARIANT]];
  if (rows > 0)
    kern<<<k2_grid(p), (unsigned)p[K2P_THREADS], (size_t)p[K2P_SMEM],
           stream>>>(x, y, idx, out, rows, d);
  return (int)cudaGetLastError();
}
