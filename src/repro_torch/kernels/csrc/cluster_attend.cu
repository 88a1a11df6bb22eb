// K6: decode attention of one query row over its p selected blocks of a
// cluster-major KV cache (k²-attention), returning the online-softmax state.
//
// Replaces the Pallas TPU kernel src/repro/kernels/cluster_attend.py
// (cluster_attend / _kernel): for each (batch, q-head) row, logits
// q.k * dh^-0.5 in f32 over the valid rows of its p selected (cap, dh)
// blocks, a running max, sum and weighted accumulator carried across
// blocks, and a fully masked block keeps the previous statistics. The TPU
// kernel divides acc by max(l, 1e-30) in its flush; this kernel writes
// (m, l, acc) instead, so that the decode path can merge the recent-token
// ring and the token being decoded into the same softmax (the reference's
// _cm_partial, attention.py, which this kernel replaces on the decode path).
//
// Bound on an H100: bytes. Each valid K and V row is read once per row
// that selects its block, one dot product and one axpy of dh values per row
// read: 4 dh FLOPs against 2 dh * sizeof(T) bytes. The least time is the
// bytes of the distinct selected live rows of K and V, plus q and the
// outputs, over 3.35 TB/s. Validity comes either as the TPU kernel's
// (rows, cap) mask or as per-block sizes (slot < size); with sizes the row
// loop stops at the block's size, so a block filled to 32 of its 512 slots
// costs 32 rows of traffic, not the whole capacity the TPU kernel streams.
// At the decode step (64 query rows, p = 16 blocks of ~32 live rows, dh =
// 128, bf16) that is ~16 MB: a few microseconds, so the launch, the first
// dependent loads (sel, then sizes, then the rows) and the combine are most
// of the kernel's time.
//
// Design: flash-decoding in one launch. Each query row's p blocks are split
// into S contiguous slices, one CUDA block of NW = 4 warps each (S from p
// alone, so that a row's bits depend neither on the batch nor on the card).
// Within a CUDA block each warp takes its own tiles of TRW rows (tile t of
// the slice's j-th block goes to warp (j + t) % NW, so a block's tiles
// spread over the warps and the schedule does not depend on the validity
// form), streams them through its own ring of STAGES stages with cp.async
// (16-byte pieces where rows and tables allow, else one element a piece:
// 4-byte cp.async for f32, plain 2-byte copies for bf16), and keeps its
// own online-softmax state with no block-wide barrier: lanes are grouped
// LPR to a row, each lane a few 16-byte pieces of it, the group's dot
// product is a shuffle tree, the tile's max a warp shuffle, then every lane
// rescales and accumulates its own columns. The warps' states meet in
// shared memory in warp order. A block with S > 1 writes its (m, l, acc) to
// a workspace (bh, S, dh + 2), then bumps its row's ticket after
// __threadfence(); the last block of the row folds the S partials in slice
// order 0, 1, ..., S-1 (m = max, each scaled by exp(m_s - m), a slice with
// no valid row adds nothing) and resets the ticket. No float atomics: the
// order of every sum is fixed by p alone, so two launches give the same
// bits, a row gives the same bits in any batch, and both validity forms
// agree too (a row past the size or masked adds nothing, and a tile with
// no valid row is skipped).
// A row whose blocks are all empty gives (-inf, 0, 0) exactly. Shared
// memory: NW STAGES 2 TILE_BYTES for the rings plus NW (dh + 2) floats,
// the attribute set once per device and kernel.
#include <math.h>
#include <stdint.h>
#include <cuda_bf16.h>
#include "common.cuh"

namespace {
constexpr int NW = 4;
constexpr int NT = 32 * NW;
constexpr int MAX_DH = 256;
constexpr int STAGES = 3;
constexpr int TILE_BYTES = 2048;     // of K (and of V) a warp stage holds
constexpr int MAX_STEPS = 4;         // row groups a tile holds
constexpr int MAX_SPLITS = 8;
constexpr size_t SMEM_MAX =
    (size_t)NW * STAGES * 2 * TILE_BYTES + NW * (MAX_DH + 2) * sizeof(float);
constexpr unsigned FULL = 0xffffffffu;

// The lanes' layout over a row of rb bytes in pieces of VB bytes: LPR
// lanes a row (RG = 32 / LPR rows at once), CPL pieces a lane, TRW rows a
// tile. Computed once per launch on the host.
struct Lanes {
  int lpr, cpl, trw;
};

// The VE floats of one piece of a staged row.
template <typename T, int VB>
__device__ __forceinline__ void load_piece(const unsigned char* p, float* f) {
  if constexpr (sizeof(T) == 4 && VB == 16) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  } else if constexpr (sizeof(T) == 4) {
    f[0] = *reinterpret_cast<const float*>(p);
  } else if constexpr (VB == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    f[0] = __uint_as_float((unsigned)*reinterpret_cast<const uint16_t*>(p)
                           << 16);
  }
}

// The rows of one block of the slice that the kernel reads: the block's
// size (or its capacity, with a validity mask), 0 for an id outside
// [0, rows).
__device__ __forceinline__ int block_rows(const int* sel_r, int j,
                                          const int* vs, int by_sizes,
                                          int rows, int cap, int& id) {
  id = sel_r[j];
  if (id < 0 || id >= rows) return 0;
  return by_sizes ? min(max(vs[id], 0), cap) : cap;
}

// The next tile of the slice [j, j1) that this warp owns, after (j, t):
// tile t of block j belongs to warp (j - j0 + t) % NW. False past the end.
__device__ __forceinline__ bool next_tile(int& j, int& t, int& id, int& n,
                                          int j0, int j1, int warp,
                                          const int* sel_r, const int* vs,
                                          int by_sizes, int rows, int cap,
                                          int trw) {
  t += NW;
  while (j < j1) {
    if (t * trw < n) return true;
    if (++j >= j1) break;
    n = block_rows(sel_r, j, vs, by_sizes, rows, cap, id);
    t = ((warp - (j - j0)) % NW + NW) % NW;
  }
  return false;
}

template <typename T, int VB>
__device__ __forceinline__ void fill_stage(unsigned char* st, const T* kt,
                                           const T* vt, int id, int cap,
                                           int dh, int r0, int nr, int lane) {
  const size_t rb = (size_t)dh * sizeof(T);
  const unsigned char* ks = reinterpret_cast<const unsigned char*>(kt) +
                            ((size_t)id * cap + r0) * rb;
  const unsigned char* vsrc = reinterpret_cast<const unsigned char*>(vt) +
                              ((size_t)id * cap + r0) * rb;
  const int pieces = (int)(nr * rb / VB);
  for (int e = lane; e < pieces; e += 32) {
    const size_t o = (size_t)e * VB;
    if constexpr (VB == 2) {
      *reinterpret_cast<uint16_t*>(st + o) =
          *reinterpret_cast<const uint16_t*>(ks + o);
      *reinterpret_cast<uint16_t*>(st + TILE_BYTES + o) =
          *reinterpret_cast<const uint16_t*>(vsrc + o);
    } else {
      k2_cp_async(reinterpret_cast<float*>(st + o),
                  reinterpret_cast<const float*>(ks + o), true, VB);
      k2_cp_async(reinterpret_cast<float*>(st + TILE_BYTES + o),
                  reinterpret_cast<const float*>(vsrc + o), true, VB);
    }
  }
}

template <typename T, int VB>
__global__ void __launch_bounds__(NT)
cluster_attend_kernel(const float* __restrict__ q, const T* __restrict__ kt,
                      const T* __restrict__ vt, const int* __restrict__ vs,
                      int by_sizes, const int* __restrict__ sel,
                      float* __restrict__ m_out, float* __restrict__ l_out,
                      float* __restrict__ acc_out, float* __restrict__ ws,
                      int* __restrict__ tickets, int rows, int cap, int dh,
                      int p, float scale, int S, Lanes ln) {
  constexpr int VE = VB / (int)sizeof(T);     // elements a piece
  constexpr int CMAX = 8 / VE;                // pieces a lane, at most
  constexpr int EL = CMAX * VE;               // elements a lane, at most
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x / S, slice = blockIdx.x % S;
  const int j0 = (int)((long long)slice * p / S);
  const int j1 = (int)((long long)(slice + 1) * p / S);
  const int* sel_r = sel + (size_t)row * p;
  const int lpr = ln.lpr, cpl = ln.cpl, trw = ln.trw, rg = 32 / lpr;
  const int grp = lane / lpr, sub = lane % lpr;
  const size_t rb = (size_t)dh * sizeof(T);
  const int cpr = (int)(rb / VB);             // pieces a row
  unsigned char* ring = smem + (size_t)warp * STAGES * 2 * TILE_BYTES;
  float* mrg = reinterpret_cast<float*>(smem + (size_t)NW * STAGES * 2 *
                                                   TILE_BYTES);

  float qv[EL], acc[EL];
#pragma unroll
  for (int c = 0; c < CMAX; ++c)
#pragma unroll
    for (int i = 0; i < VE; ++i) {
      const int ch = sub + c * lpr;
      qv[c * VE + i] =
          c < cpl && ch < cpr ? q[(size_t)row * dh + ch * VE + i] : 0.f;
      acc[c * VE + i] = 0.f;
    }
  float m = -INFINITY, l = 0.f;          // l: this lane's row group's sum

  // two walks over this warp's tiles: one starts copies STAGES - 1 ahead
  int ij = j0, it = 0, iid = 0, in = 0;  // the copy side
  if (ij < j1) {
    in = block_rows(sel_r, ij, vs, by_sizes, rows, cap, iid);
    it = warp - NW;                      // next_tile adds NW
  }
  bool ihave = ij < j1 && next_tile(ij, it, iid, in, j0, j1, warp, sel_r, vs,
                                    by_sizes, rows, cap, trw);
  int cj = ij, ct = it, cid = iid, cn = in;  // the compute side
  bool chave = ihave;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (ihave) {
      fill_stage<T, VB>(ring + s * 2 * TILE_BYTES, kt, vt, iid, cap, dh,
                        it * trw, min(trw, in - it * trw), lane);
      ihave = next_tile(ij, it, iid, in, j0, j1, warp, sel_r, vs, by_sizes,
                        rows, cap, trw);
    }
    k2_cp_commit();
  }
  for (int i = 0; chave; ++i) {
    k2_cp_wait<STAGES - 2>();
    __syncwarp();
    if (ihave) {
      fill_stage<T, VB>(ring + (i + STAGES - 1) % STAGES * 2 * TILE_BYTES, kt,
                        vt, iid, cap, dh, it * trw, min(trw, in - it * trw),
                        lane);
      ihave = next_tile(ij, it, iid, in, j0, j1, warp, sel_r, vs, by_sizes,
                        rows, cap, trw);
    }
    k2_cp_commit();
    const unsigned char* kb = ring + i % STAGES * 2 * TILE_BYTES;
    const unsigned char* vb = kb + TILE_BYTES;
    const int r0 = ct * trw, nr = min(trw, cn - r0);
    const int* vrow = by_sizes ? nullptr : vs + (size_t)cid * cap + r0;
    const int nsteps = (nr + rg - 1) / rg;
    float lg[MAX_STEPS];
    float mt = -INFINITY;
#pragma unroll
    for (int st = 0; st < MAX_STEPS; ++st) {
      lg[st] = -INFINITY;
      if (st >= nsteps) continue;              // warp-uniform
      const int r = st * rg + grp;
      float s = 0.f;
      if (r < nr) {
#pragma unroll
        for (int c = 0; c < CMAX; ++c) {
          const int ch = sub + c * lpr;
          if (c < cpl && ch < cpr) {
            float f[VE];
            load_piece<T, VB>(kb + r * rb + (size_t)ch * VB, f);
#pragma unroll
            for (int e = 0; e < VE; ++e) s = fmaf(qv[c * VE + e], f[e], s);
          }
        }
      }
      for (int o = lpr / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(FULL, s, o);
      if (r < nr && (vrow == nullptr || vrow[r] > 0)) lg[st] = s * scale;
      mt = fmaxf(mt, lg[st]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, o));
    if (mt != -INFINITY) {                     // else: keep the state
      const float m_new = fmaxf(m, mt);
      const float corr = m == -INFINITY ? 0.f : expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int e = 0; e < EL; ++e) acc[e] *= corr;
#pragma unroll
      for (int st = 0; st < MAX_STEPS; ++st) {
        if (lg[st] == -INFINITY) continue;
        const float w = expf(lg[st] - m_new);
        const int r = st * rg + grp;
        l += w;
#pragma unroll
        for (int c = 0; c < CMAX; ++c) {
          const int ch = sub + c * lpr;
          if (c < cpl && ch < cpr) {
            float f[VE];
            load_piece<T, VB>(vb + r * rb + (size_t)ch * VB, f);
#pragma unroll
            for (int e = 0; e < VE; ++e)
              acc[c * VE + e] = fmaf(w, f[e], acc[c * VE + e]);
          }
        }
      }
      m = m_new;
    }
    chave = next_tile(cj, ct, cid, cn, j0, j1, warp, sel_r, vs, by_sizes,
                      rows, cap, trw);
    __syncwarp();                              // the slot is refilled next
  }
  k2_cp_wait<0>();
  // the row groups' sums (same m), then the warps' states in warp order
  for (int o = lpr; o < 32; o <<= 1) {
    l += __shfl_xor_sync(FULL, l, o);
#pragma unroll
    for (int e = 0; e < EL; ++e) acc[e] += __shfl_xor_sync(FULL, acc[e], o);
  }
  float* mw = mrg + warp * (dh + 2);
  if (lane == 0) {
    mw[0] = m;
    mw[1] = l;
  }
  if (grp == 0)
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      const int ch = sub + c * lpr;
      if (c < cpl && ch < cpr)
#pragma unroll
        for (int e = 0; e < VE; ++e) mw[2 + ch * VE + e] = acc[c * VE + e];
    }
  __syncthreads();
  float mm = -INFINITY;
#pragma unroll
  for (int w = 0; w < NW; ++w) mm = fmaxf(mm, mrg[w * (dh + 2)]);
  float f[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const float mw_ = mrg[w * (dh + 2)];
    f[w] = mw_ == -INFINITY ? 0.f : expf(mw_ - mm);
  }
  float* out = S == 1 ? nullptr : ws + ((size_t)row * S + slice) * (dh + 2);
  for (int e = tid; e < dh + 1; e += NT) {     // e = 0: l; e >= 1: acc
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) a = fmaf(mrg[w * (dh + 2) + 1 + e], f[w], a);
    if (S == 1) {
      if (e == 0) {
        m_out[row] = mm;
        l_out[row] = a;
      } else {
        acc_out[(size_t)row * dh + e - 1] = a;
      }
    } else {
      if (e == 0) out[0] = mm;
      out[1 + e] = a;
    }
  }
  if (S == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(tickets + row, 1) == S - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block of the row: the S partials in slice order
  const float* part = ws + (size_t)row * S * (dh + 2);
  float mx = -INFINITY;
  for (int s = 0; s < S; ++s) mx = fmaxf(mx, __ldcg(part + s * (dh + 2)));
  for (int e = tid; e < dh + 1; e += NT) {
    float a = 0.f;
    for (int s = 0; s < S; ++s) {
      const float ms = __ldcg(part + s * (dh + 2));
      const float fs = ms == -INFINITY ? 0.f : expf(ms - mx);
      a = fmaf(__ldcg(part + s * (dh + 2) + 1 + e), fs, a);
    }
    if (e == 0) {
      m_out[row] = mx;
      l_out[row] = a;
    } else {
      acc_out[(size_t)row * dh + e - 1] = a;
    }
  }
  if (tid == 0) tickets[row] = 0;
}

// S for rows of p blocks: the largest power of two at most p and
// MAX_SPLITS. A function of p alone: the split fixes the order of the
// combine, so a row's bits must not follow the batch it comes in or the
// card's SM count. S = 8 measured fastest at the decode step (64 rows,
// p = 16: 512 CUDA blocks, 4 resident an SM on 132 SMs; S = 4 and 16
// slower).
int plan_splits(int p) {
  int s = 1;
  while (s < MAX_SPLITS && s * 2 <= p) s *= 2;
  return s;
}

// The instantiations the launcher picks from, in variant order: f32 tables
// in 16- or 4-byte pieces, bf16 tables in 16- or 2-byte pieces.
const void* const FNS[] = {
    (const void*)cluster_attend_kernel<float, 16>,
    (const void*)cluster_attend_kernel<float, 4>,
    (const void*)cluster_attend_kernel<__nv_bfloat16, 16>,
    (const void*)cluster_attend_kernel<__nv_bfloat16, 2>};

// The launch over bh query rows, each over p selected blocks of a (rows,
// cap, dh) table; aligned: both tables are 16-byte aligned. One CUDA block
// a (row, split), S splits a row, each walking its share of the p blocks.
cudaError_t plan(int bh, int rows, int cap, int dh, int p, int table_bf16,
                 bool aligned, long long* out) {
  if (bh < 0 || rows < 0 || cap < 0 || dh < 1 || dh > MAX_DH || p < 0)
    return cudaErrorInvalidValue;
  const int S = plan_splits(p);
  const int rb = dh * (table_bf16 ? 2 : 4);
  const bool vec = rb % 16 == 0 && aligned;
  k2_plan_init(out, (long long)bh * S, 1, 1, NT,
               (size_t)NW * STAGES * 2 * TILE_BYTES +
                   NW * (dh + 2) * sizeof(float),
               (table_bf16 ? 2 : 0) + (vec ? 0 : 1), vec ? 1 : 0);
  out[K2P_ROWS] = bh;
  out[K2P_COLS] = S;
  out[K2P_INNER] = p;
  out[K2P_INNER_TILE] = S;
  return cudaSuccess;
}

template <typename T, int VB>
cudaError_t launch(const long long* pl, const float* q, const void* kt,
                   const void* vt, const int* vs, int by_sizes,
                   const int* sel, float* m, float* l, float* acc, float* ws,
                   int* tickets, int rows, int cap, int dh, int p,
                   float scale, cudaStream_t stream) {
  auto kernel = cluster_attend_kernel<T, VB>;
  cudaError_t err;
  k2_resident_blocks(kernel, NT, SMEM_MAX, err);  // opts in once
  if (err != cudaSuccess) return err;
  const int S = (int)pl[K2P_COLS];
  const int rb = dh * (int)sizeof(T), cpr = rb / VB;
  Lanes ln;
  ln.lpr = 1;
  while (ln.lpr < 32 && ln.lpr < cpr) ln.lpr *= 2;
  ln.cpl = (cpr + ln.lpr - 1) / ln.lpr;
  int trw = 1;
  while (trw * 2 * rb <= TILE_BYTES) trw *= 2;
  ln.trw = min(trw, MAX_STEPS * (32 / ln.lpr));
  kernel<<<k2_grid(pl), (unsigned)pl[K2P_THREADS], (size_t)pl[K2P_SMEM],
           stream>>>(q, static_cast<const T*>(kt), static_cast<const T*>(vt),
                     vs, by_sizes, sel, m, l, acc, ws, tickets, rows, cap, dh,
                     p, scale, S, ln);
  return cudaGetLastError();
}
}  // namespace

K2_DESCRIBE(cluster_attend, FNS, "f32/VB16,f32/VB4,bf16/VB16,bf16/VB2")

K2_EXPORT int k2_plan_cluster_attend(int bh, int rows, int cap, int dh, int p,
                                     int table_bf16, int aligned,
                                     long long* out) {
  return (int)plan(bh, rows, cap, dh, p, table_bf16, aligned != 0, out);
}

// q: (bh, dh) f32; kt, vt: (rows, cap, dh) bf16 (table_bf16 = 1) or f32;
// vs: (rows,) int32 sizes when by_sizes, else (rows, cap) int32 validity;
// sel: (bh, p) int32 table rows (rows outside [0, rows) are skipped);
// outputs m, l (bh,) f32 and acc (bh, dh) f32; ws: (bh, S, dh + 2) f32
// scratch, S = k2_cluster_attend_splits(p); tickets: (bh,) int32, zero
// before the launch and after it. dh <= 256.
K2_EXPORT int k2_cluster_attend_splits(int p) { return plan_splits(p); }

K2_EXPORT int k2_cluster_attend(const float* q, const void* kt,
                                const void* vt, const int* vs, int by_sizes,
                                const int* sel, float* m, float* l,
                                float* acc, float* ws, int* tickets, int bh,
                                int rows, int cap, int dh, int p,
                                int table_bf16, float scale,
                                cudaStream_t stream) {
  long long pl[K2P_WORDS];
  cudaError_t err = plan(bh, rows, cap, dh, p, table_bf16,
                         k2_aligned16(kt) && k2_aligned16(vt), pl);
  if (err != cudaSuccess) return (int)err;
  if (bh == 0) return (int)cudaGetLastError();
  switch (pl[K2P_VARIANT]) {
    case 0:
      return (int)launch<float, 16>(pl, q, kt, vt, vs, by_sizes, sel, m, l,
                                    acc, ws, tickets, rows, cap, dh, p, scale,
                                    stream);
    case 1:
      return (int)launch<float, 4>(pl, q, kt, vt, vs, by_sizes, sel, m, l,
                                   acc, ws, tickets, rows, cap, dh, p, scale,
                                   stream);
    case 2:
      return (int)launch<__nv_bfloat16, 16>(pl, q, kt, vt, vs, by_sizes, sel,
                                            m, l, acc, ws, tickets, rows, cap,
                                            dh, p, scale, stream);
    default:
      return (int)launch<__nv_bfloat16, 2>(pl, q, kt, vt, vs, by_sizes, sel,
                                           m, l, acc, ws, tickets, rows, cap,
                                           dh, p, scale, stream);
  }
}
