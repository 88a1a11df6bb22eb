// K2: k x k squared center distances, the O(k^2 d) term of the k2-means
// iteration (the input of the center k_n-NN graph).
//
// Replaces the Pallas TPU kernel src/repro/kernels/center_knn.py
// (_kernel / _center_sqdist_padded): (128,128) MXU tiles of
// max(|a|^2 - 2 a.b + |b|^2, 0).
//
// Values: those of every (point, center) pair of the port (common.cuh).
// |c_i|^2 and x_ij = c_i.c_j are each RN_f32 of the exact sum of the exact
// f32 products, and out[i][j] = max((|c_i|^2 - 2 x_ij) + |c_j|^2, 0) in
// f32: ref.center_sqdist_ref bit for bit, whatever order anything sums in,
// so a permutation of d changes no distance and no k_n-NN list.
//
// Bound on an H100: operations. The products are 2 k^2 d f64 tensor-core
// operations (1.57 GFLOP at k = 1000, d = 784: 0.023 ms at 67 TFLOP/s);
// x is symmetric, so the kernel forms only the tiles on and above the
// diagonal, about half of that; the bytes (k d floats read, k^2 written)
// take 0.002 ms. Design:
// - a prologue kernel rounds the rows' squared norms (k2_exact_sqnorm_
//   kernel, one warp a row);
// - one block per BT x BT tile (ti, tj), ti <= tj, of the upper triangle;
//   the two panels of f32 rows stream through a two-stage cp.async ring
//   (16 bytes a piece where d % 4 == 0 and c is 16-byte aligned, else 4),
//   zero-filled past k and d (ragged edges are masked, never padded), and
//   are widened to f64 as a fragment is loaded, so no f64 copy of c is
//   made; a diagonal tile copies its one panel once;
// - mma.sync m16n8k8 in f64 (k2_dmma): a warp owns a 32 x 32 tile of f64
//   sums, and S warp groups split each stage's k-steps between them
//   (their sums meet in shared memory after the loop), so that a tile has
//   S times the warps to hide the MMA's latency;
// - the epilogue screens each sum against gamma_d |c_i| |c_j|
//   (Cauchy-Schwarz, the norms bounded from their rounded squares) into a
//   tile of shared memory (x_ii is |c_i|^2 exactly, so the diagonal takes
//   the norm unscreened), and the block writes the tile both ways,
//   out[i][j] and out[j][i], each composed from its own side, a row of
//   the tile at a time so that the stores coalesce;
// - the few sums the screen flags are marked in a bitmap in shared memory
//   and recomputed after the loop, each by a whole warp (common.cuh's
//   tiers): a recompute inside the loop made exact_cross spill.
#include <stdint.h>
#include "common.cuh"

namespace {
constexpr int NT_NORM = 256;
constexpr int STAGES = 2;

template <int BT, int S, int DC>
struct Tile {
  static constexpr int WG = (BT / 32) * (BT / 32);  // warps of a group
  static constexpr int NT = 32 * WG * S;
  static constexpr int LD = DC + 4;   // padded row stride: 32 banks a load
  static constexpr int STAGE_FLOATS = 2 * BT * LD;
  static constexpr size_t RING = sizeof(float) * STAGES * STAGE_FLOATS;
  static constexpr size_t RED = sizeof(double) * (S - 1) * WG * 32 * 32;
  static constexpr size_t XT = sizeof(float) * BT * (BT + 1);  // after RED
  static constexpr size_t BODY = RING > RED + XT ? RING : RED + XT;
  static constexpr int FLAG_WORDS = BT * BT / 32;
  static constexpr size_t SMEM = BODY + sizeof(double) * 2 * BT +
                                 sizeof(float) * 2 * BT +
                                 sizeof(unsigned) * FLAG_WORDS;
};

// Copy chunk t0 of the row panels (rows r0.. and, off the diagonal, c0..)
// into one stage: BT (or 2 BT) rows of DC floats, zero past k and d.
template <int BT, int S, int DC, int VEC>
__device__ __forceinline__ void load_chunk(float* st, const float* c, int r0,
                                           int c0, bool diag, int t0, int k,
                                           int d) {
  using T = Tile<BT, S, DC>;
  constexpr int PER_ROW = DC / VEC;
  const int rows = diag ? BT : 2 * BT;
  for (int e = threadIdx.x; e < rows * PER_ROW; e += T::NT) {
    const int r = e / PER_ROW, j = (e % PER_ROW) * VEC;
    const int g = r < BT ? r0 + r : c0 + r - BT;
    const bool ok = g < k && t0 + j < d;
    k2_cp_async(st + r * T::LD + j, ok ? c + (long long)g * d + t0 + j : c,
                ok, VEC * 4);
  }
}

// (|c_i|^2 - 2 x) + |c_j|^2 in f32, rounded after each operation, clamped
// at 0 (a NaN stays NaN): ref.center_sqdist_ref's composition.
__device__ __forceinline__ float compose(float sqi, float x, float sqj) {
  const float t = __fadd_rn(__fsub_rn(sqi, __fmul_rn(2.f, x)), sqj);
  return t < 0.f ? 0.f : t;
}

__device__ __forceinline__ void store_pair(float* out, const float* csq,
                                           int i, int j, float x, int k) {
  out[(long long)i * k + j] = compose(csq[i], x, csq[j]);
  if (i != j) out[(long long)j * k + i] = compose(csq[j], x, csq[i]);
}

// The sums the screen marked (bit r * BT + cc: row r0 + r, column c0 +
// cc), recomputed exactly, each by a whole warp, and stored both ways.
// Called once, after the loop.
template <int BT>
__device__ __noinline__ void recompute_marked(const unsigned* flags,
                                              const float* c,
                                              const float* csq, float* out,
                                              int r0, int c0, int k, int d) {
  const int lane = threadIdx.x % 32, nw = blockDim.x / 32;
  for (int w0 = threadIdx.x / 32 * 32; w0 < BT * BT / 32; w0 += nw * 32) {
    const unsigned bits = w0 + lane < BT * BT / 32 ? flags[w0 + lane] : 0u;
    unsigned any = __ballot_sync(0xffffffffu, bits != 0);
    while (any) {
      const int src = __ffs(any) - 1;
      any &= any - 1;
      unsigned bb = __shfl_sync(0xffffffffu, bits, src);
      while (bb) {
        const int e = (w0 + src) * 32 + __ffs(bb) - 1;
        bb &= bb - 1;
        const int i = r0 + e / BT, j = c0 + e % BT;
        const float v = k2_exact_dot_tiers(
            K2Strided{c + (long long)i * d, 1, c + (long long)j * d, 1}, d);
        if (lane == 0) store_pair(out, csq, i, j, v, k);
      }
    }
  }
}

// Block b: tile (ti, tj), the b-th of the upper triangle in row order;
// csq (k,): the rows' correctly rounded squared norms.
template <int BT, int S, int DC, int VEC>
__global__ void __launch_bounds__(Tile<BT, S, DC>::NT, 2)
center_sqdist_kernel(const float* __restrict__ c,
                     const float* __restrict__ csq, float* __restrict__ out,
                     int k, int d, int nt) {
  using T = Tile<BT, S, DC>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  double* red = reinterpret_cast<double*>(smem);  // after the loop
  double* nrm = reinterpret_cast<double*>(smem + T::BODY);  // 2 BT bounds
  float* sqs = reinterpret_cast<float*>(nrm + 2 * BT);      // 2 BT norms
  unsigned* flags = reinterpret_cast<unsigned*>(sqs + 2 * BT);

  int ti = 0, b = blockIdx.x;
  while (b >= nt - ti) {
    b -= nt - ti;
    ++ti;
  }
  const int tj = ti + b;
  const bool diag = ti == tj;
  const int r0 = ti * BT, c0 = tj * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / T::WG, wig = warp % T::WG;
  const int wm = wig / (BT / 32), wn = wig % (BT / 32);
  const int g = lane / 4, t = lane % 4;
  const int nkc = max(1, (d + DC - 1) / DC);
  const double gam = k2_gamma(d);

  double acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {  // the ring's first chunks
    if (st < nkc)
      load_chunk<BT, S, DC, VEC>(ring + st * T::STAGE_FLOATS, c, r0, c0, diag,
                                 st * DC, k, d);
    k2_cp_commit();
  }
  for (int r = threadIdx.x; r < 2 * BT; r += T::NT) {
    const int gi = r < BT ? r0 + r : c0 + r - BT;
    const float q = gi < k ? csq[gi] : 0.f;
    sqs[r] = q;
    nrm[r] = sqrt(k2_sqnorm_up(q)) * (r < BT ? gam : 1.0);
  }
  for (int i = threadIdx.x; i < T::FLAG_WORDS; i += T::NT) flags[i] = 0;
  for (int kc = 0; kc < nkc; ++kc) {
    k2_cp_wait<STAGES - 2>();
    __syncthreads();                   // chunk kc landed; chunk kc - 1 read
    {
      const int nx = kc + STAGES - 1;
      if (nx < nkc)
        load_chunk<BT, S, DC, VEC>(ring + (nx % STAGES) * T::STAGE_FLOATS, c,
                                   r0, c0, diag, nx * DC, k, d);
      k2_cp_commit();
    }
    const int t0 = kc * DC;
    const float* as = ring + (kc % STAGES) * T::STAGE_FLOATS;
    const float* bs = diag ? as : as + BT * T::LD;
#pragma unroll
    for (int q = 0; q < DC / 8 / S; ++q) {
      const int kk = q * S + grp;
      if (t0 + kk * 8 >= d) break;     // the rest of the chunk is zero
      double af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* p = as + (wm * 32 + i * 16 + g) * T::LD + kk * 8 + t;
        af[i][0] = p[0];
        af[i][1] = p[8 * T::LD];
        af[i][2] = p[4];
        af[i][3] = p[8 * T::LD + 4];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* p = bs + (wn * 32 + j * 8 + g) * T::LD + kk * 8 + t;
        const double bf[2] = {p[0], p[4]};
#pragma unroll
        for (int i = 0; i < 2; ++i) k2_dmma(acc[i][j], af[i], bf);
      }
    }
  }
  k2_cp_wait<0>();
  __syncthreads();                     // the ring is free
  if constexpr (S > 1) {               // the groups' sums meet in group 0
    if (grp > 0) {
      double* mine = red + (size_t)((grp - 1) * T::WG + wig) * 32 * 32;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mine[((i * 4 + j) * 4 + e) * 32 + lane] = acc[i][j][e];
    }
    __syncthreads();
    if (grp == 0) {
      for (int o = 1; o < S; ++o) {
        const double* theirs =
            red + (size_t)((o - 1) * T::WG + wig) * 32 * 32;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][j][e] += theirs[((i * 4 + j) * 4 + e) * 32 + lane];
      }
    }
  }

  // --- epilogue: the rounded products into a tile of shared memory ------
  float* xt = reinterpret_cast<float*>(smem + T::RED);  // [BT][BT + 1]
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + i * 16 + h * 8 + g;
        if (r0 + r >= k) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = wn * 32 + j * 8 + 2 * t + e;
            if (c0 + cc >= k || (diag && cc < r)) continue;
            float v = sqs[r];          // x_ii = |c_i|^2 exactly
            if (!(diag && cc == r) &&
                !k2_screen(acc[i][j][2 * h + e], nrm[r] * nrm[BT + cc], v)) {
              const int f = r * BT + cc;   // rare: recomputed after
              atomicOr(&flags[f / 32], 1u << (f % 32));
            }
            xt[r * (BT + 1) + cc] = v;
          }
      }
  }
  __syncthreads();
  // --- both ways, a tile row at a time (coalesced), each composed from its
  // own side; a diagonal tile reads its lower half from the upper ---------
  for (int e = threadIdx.x; e < BT * BT; e += T::NT) {
    const int r = e / BT, cc = e % BT;
    if (r0 + r < k && c0 + cc < k) {
      const float x = diag && cc < r ? xt[cc * (BT + 1) + r]
                                     : xt[r * (BT + 1) + cc];
      out[(long long)(r0 + r) * k + c0 + cc] = compose(sqs[r], x, sqs[BT + cc]);
    }
    if (!diag && c0 + r < k && r0 + cc < k)
      out[(long long)(c0 + r) * k + r0 + cc] =
          compose(sqs[BT + r], xt[cc * (BT + 1) + r], sqs[cc]);
  }
  __syncthreads();                     // every mark set, every tile stored
  recompute_marked<BT>(flags, c, csq, out, r0, c0, k, d);
}

// The tile shape, chosen on an H100 at the mnist cell (k = 1000, d = 784;
// scripts/probe_kernels.py --only center_sqdist, PERF.md §6): 32 x 32
// tiles with 2 warps (528 tiles, four an SM) took 0.037-0.044 ms of device
// time, 64 x 64 tiles with 8 warps 0.046-0.048 (136 tiles on 132 SMs:
// four SMs take two), with 4 warps 0.052-0.054; a third ring stage read
// within that spread.
constexpr int CFG_BT = 32, CFG_S = 2, CFG_DC = 64;

using CfgTile = Tile<CFG_BT, CFG_S, CFG_DC>;
// The instantiations the launcher picks from, in variant order: 4-byte
// (VEC 1) and 16-byte (VEC 4) copies.
const decltype(&center_sqdist_kernel<CFG_BT, CFG_S, CFG_DC, 1>) FNS[] = {
    center_sqdist_kernel<CFG_BT, CFG_S, CFG_DC, 1>,
    center_sqdist_kernel<CFG_BT, CFG_S, CFG_DC, 4>};

// The tile launch over k centers of d floats (after the norms' launch);
// aligned: c is 16-byte aligned. One CUDA block a tile on or above the
// diagonal, nt (nt + 1) / 2 of the nt x nt tiles of BT x BT.
cudaError_t plan(int k, int d, bool aligned, long long* p) {
  if (k < 0 || d < 0) return cudaErrorInvalidValue;
  const long long nt = (k + CFG_BT - 1) / CFG_BT;
  const bool vec = d % 4 == 0 && aligned;
  k2_plan_init(p, nt * (nt + 1) / 2, 1, 1, CfgTile::NT, CfgTile::SMEM,
               vec ? 1 : 0, vec ? 1 : 0);
  p[K2P_ROWS] = nt * (nt + 1) / 2;     // the triangle's tiles
  p[K2P_INNER] = d;
  p[K2P_INNER_TILE] = CFG_DC;
  return cudaSuccess;
}
}  // namespace

K2_DESCRIBE(center_sqdist, FNS, "BT32S2DC64/v1,BT32S2DC64/v4")

K2_EXPORT int k2_plan_center_sqdist(int k, int d, int aligned,
                                    long long* out) {
  return (int)plan(k, d, aligned != 0, out);
}

// c: (k, d) f32 contiguous; csq: (k,) f32 scratch (the rows' correctly
// rounded squared norms); out: (k, k) f32.
K2_EXPORT int k2_center_sqdist(const float* c, float* csq, float* out, int k,
                               int d, cudaStream_t stream) {
  long long p[K2P_WORDS];
  cudaError_t err = plan(k, d, k2_aligned16(c), p);
  if (err != cudaSuccess) return (int)err;
  if (k == 0) return (int)cudaGetLastError();
  k2_exact_sqnorm_kernel<NT_NORM>
      <<<(unsigned)((k + NT_NORM / 32 - 1) / (NT_NORM / 32)), NT_NORM, 0,
         stream>>>(c, csq, k, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto kernel = FNS[p[K2P_VARIANT]];
  k2_resident_blocks(kernel, CfgTile::NT, CfgTile::SMEM, err);  // opts in
  if (err != cudaSuccess) return (int)err;
  kernel<<<k2_grid(p), (unsigned)p[K2P_THREADS], (size_t)p[K2P_SMEM],
           stream>>>(c, csq, out, k, d, (int)((k + CFG_BT - 1) / CFG_BT));
  return (int)cudaGetLastError();
}
