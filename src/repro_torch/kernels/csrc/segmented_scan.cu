// K3: segmented inclusive scans of w*x (d lanes), w*|x|^2 and w over a
// leaf-grouped layout, the Lemma-1 sweep of the divisive init.
//
// Replaces the Pallas TPU kernel src/repro/kernels/segmented_scan.py
// (segmented_scan / _kernel), which carries the running sum in scratch
// from one grid step to the next and so relies on the TPU running its grid
// in order.
//
// Bound on an H100: bytes, R d 4 in and R d 4 out (R = 92,000, d = 784:
// 0.17 ms at 3.35 TB/s). The first design took three launches (block
// totals, a serial scan of the totals on 7 blocks, the local scans), read
// x twice and each row once more for |x|^2: 1.5x the bound's bytes, and
// 128 of 132 SMs idle during the serial pass.
//
// Design: one launch, one pass with decoupled look-back. A tile is TR rows
// (TR a power of two that divides bn, so no tile spans two segments; the
// largest whose f32 rows fit TILE_BYTES of shared memory, at most 128)
// by a slice of at most CS = 1024 columns; d > CS takes several slices,
// each its own chain. A CUDA block takes its tile id from an atomic counter,
// so tiles start in order and a tile only ever waits on tiles that are
// already running: no deadlock whatever order the blocks are scheduled in.
// The block then
//  1. copies its tile into shared memory by cp.async (16 bytes a thread
//     where d % 4 == 0 and x is 16-byte aligned, else 4), the one read of x;
//  2. reduces it: each thread owns 4 columns (f32 sums down the rows), each
//     warp owns rows for w |x|^2 (f32, as the plain version sums a row);
//     the slices of one row tile hand their row partials of w |x|^2 to the
//     last slice, which owns the |x|^2 and count lanes;
//  3. publishes its aggregate of the slice's lanes and a flag; a tile that
//     starts a segment publishes it as its inclusive prefix at once and
//     waits on nothing;
//  4. otherwise looks back over its predecessors in the chain, 32 flags at
//     a time by one warp, adding each one's aggregate until it meets an
//     inclusive prefix (at the latest the segment's first tile), and
//     publishes its own inclusive prefix;
//  5. writes csum, qsum and cnt: the exclusive prefix plus its own f32
//     running sum, with 16-byte stores.
// A flag is set by one thread's st.release after a barrier behind the
// block's record writes, and read by ld.acquire; records are read by ld.cg
// (L2), so no stale L1 line is read. A tile's own sums are f32 over at most
// TR rows, as the first design's were over a bn-block, and its aggregate
// record is f32; the inclusive prefixes carried along a chain are f64, so
// a chain of thousands of tiles adds no rounding of its own. The look-back
// reads each aggregate it passes (3 KB at d = 784), so its cost grows with
// the number of tiles that run unresolved at once; 100 KB tiles (two
// blocks an SM) ran faster on the card than 50 KB ones
// (scripts/probe_kernels.py). The counter and the flags are zeroed on the
// stream by the entry point, in scratch that the wrapper allocates
// (k2_segmented_scan_scratch gives its size).
//
// nvcc -Xptxas -v for sm_90a (CUDA 12.8): 64 registers, no spills, 16 bytes
// of static shared memory; the dynamic shared memory is the tile, TR (d + 2)
// floats (100,608 bytes at bn = 32, d = 784).
#include <stdint.h>
#include "common.cuh"

namespace {
constexpr int NT = 256;
constexpr int CS = 4 * NT;             // columns of a slice, 4 per thread
constexpr int TR_MAX = 128;
constexpr size_t TILE_BYTES = 100 * 1024;
constexpr unsigned AGGREGATE = 1, PREFIX = 2;

struct Plan {
  int tr, slices, ls, ntiles;          // ls: lanes of a tile's records
  size_t flag_bytes, agg_bytes, incl_bytes, qp_bytes;
};

Plan plan(int nb, int bn, int d) {
  Plan p;
  const int cw = d < CS ? d : CS;
  const size_t row = sizeof(float) * (((cw + 3) & ~3) + 2);
  p.tr = 1;
  while (p.tr * 2 <= TR_MAX && bn % (p.tr * 2) == 0 &&
         row * p.tr * 2 <= TILE_BYTES)
    p.tr *= 2;
  p.slices = d > CS ? (d + CS - 1) / CS : 1;
  p.ls = (cw + 2 + 31) & ~31;
  p.ntiles = (int)((size_t)nb * bn / p.tr) * p.slices;
  p.flag_bytes = ((sizeof(unsigned) * (p.ntiles + 1)) + 255) & ~(size_t)255;
  p.agg_bytes = sizeof(float) * (size_t)p.ntiles * p.ls;
  p.incl_bytes = sizeof(double) * (size_t)p.ntiles * p.ls;
  p.qp_bytes = sizeof(float) * (size_t)p.ntiles * p.tr;
  return p;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Every thread waits until tile u has published (thread 0 spins).
__device__ __forceinline__ void wait_published(const unsigned* flags,
                                               size_t u) {
  if (threadIdx.x == 0)
    while (ld_acquire(flags + u) == 0) __nanosleep(32);
  __syncthreads();
}

// Set tile u's flag once every thread's record writes are done: the
// barrier orders them before thread 0's release, so a block that acquires
// the flag sees them (the pattern of CUTLASS's semaphore).
__device__ __forceinline__ void publish(unsigned* flags, size_t u,
                                        unsigned f) {
  __syncthreads();
  if (threadIdx.x == 0) st_release(flags + u, f);
}

// A tile's record: lanes c4..c4+3 of this thread, and the owner's |x|^2
// and count lanes at cw, cw+1.
template <typename T>
__device__ __forceinline__ void put_record(T* rec, int c4, int cw, bool owner,
                                           const double (&v)[4], double q,
                                           double n) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (c4 + i < cw) rec[c4 + i] = (T)v[i];
  if (owner) {
    rec[cw] = (T)q;
    rec[cw + 1] = (T)n;
  }
}

// Add a record to this thread's carries, 16-byte loads through L2 (lanes
// past cw land in carries that are never used).
template <typename T>
__device__ __forceinline__ void add_record(const T* rec, int c4, bool mine,
                                           bool owner, int cw,
                                           double (&pc)[4], double& pq,
                                           double& pn) {
  if (mine) {
    if constexpr (sizeof(T) == 4) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(rec + c4));
      pc[0] += v.x;
      pc[1] += v.y;
      pc[2] += v.z;
      pc[3] += v.w;
    } else {
      const double2 a = __ldcg(reinterpret_cast<const double2*>(rec + c4));
      const double2 b = __ldcg(reinterpret_cast<const double2*>(rec + c4 + 2));
      pc[0] += a.x;
      pc[1] += a.y;
      pc[2] += b.x;
      pc[3] += b.y;
    }
  }
  if (owner) {
    pq += __ldcg(rec + cw);
    pn += __ldcg(rec + cw + 1);
  }
}

template <int VEC>
__global__ void __launch_bounds__(NT)
segmented_scan_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const int* __restrict__ b2s, unsigned* flags,
                      float* agg, double* incl, float* qp,
                      float* __restrict__ csum, float* __restrict__ qsum,
                      float* __restrict__ cnt, int bn, int d, int tr,
                      int slices, int ls) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned s_word;
  const int tid = threadIdx.x;
  if (tid == 0) s_word = atomicAdd(flags, 1u);   // flags[0]: the tile counter
  __syncthreads();
  const unsigned t = s_word;
  __syncthreads();
  flags += 1;

  const int rt = t / slices, s = t % slices;
  const int cs0 = s * CS, cw = min(CS, d - cs0), ldx = (cw + 3) & ~3;
  const bool last = s == slices - 1;
  const size_t row0 = (size_t)rt * tr;
  const size_t blk = row0 / bn;
  const bool starts =
      row0 % bn == 0 && (blk == 0 || b2s[blk] != b2s[blk - 1]);
  float* xs = reinterpret_cast<float*>(smem);    // tr x ldx
  float* ws = xs + (size_t)tr * ldx;             // tr
  float* qs = ws + tr;                           // tr: row sums of w |x|^2

  // 1. the tile into shared memory
  {
    const int per_row = ldx / VEC;
    for (int e = tid; e < tr * per_row; e += NT) {
      const int r = e / per_row, j = (e % per_row) * VEC;
      const bool ok = j < cw;
      const float* src = ok ? x + (row0 + r) * d + cs0 + j : x;
      const unsigned dst = (unsigned)__cvta_generic_to_shared(xs + r * ldx + j);
      if (VEC == 4)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         dst), "l"(src), "r"(ok ? 16 : 0));
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                         dst), "l"(src), "r"(ok ? 4 : 0));
    }
    asm volatile("cp.async.commit_group;\n" ::);
    for (int r = tid; r < tr; r += NT) ws[r] = w[row0 + r];
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }

  // 2. the tile's aggregate: 4 columns a thread, w |x|^2 a warp per row
  const int c4 = 4 * tid;
  const bool mine = c4 < cw;
  const bool owner = last && tid == NT - 1;      // the |x|^2 and count lanes
  float ac[4] = {0.f, 0.f, 0.f, 0.f};
  if (mine)
    for (int r = 0; r < tr; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(xs + r * ldx + c4);
      const float wr = ws[r];
      ac[0] += v.x * wr;
      ac[1] += v.y * wr;
      ac[2] += v.z * wr;
      ac[3] += v.w * wr;
    }
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < tr; r += NT / 32) {
      const float wr = ws[r];
      float q = 0.f;
      for (int j = 4 * lane; j < ldx; j += 128) {
        const float4 v = *reinterpret_cast<const float4*>(xs + r * ldx + j);
        q += v.x * wr * v.x + v.y * wr * v.y + v.z * wr * v.z +
             v.w * wr * v.w;
      }
      q = k2_warp_sum(q);
      if (lane == 0) qs[r] = q;
    }
  }
  __syncthreads();
  const size_t rtile0 = (size_t)rt * slices;     // tile id of slice 0
  if (slices > 1) {                              // row partials of w |x|^2
    if (!last) {
      for (int r = tid; r < tr; r += NT) qp[(size_t)t * tr + r] = qs[r];
    } else {
      for (int o = 0; o < slices - 1; ++o) wait_published(flags, rtile0 + o);
      for (int r = tid; r < tr; r += NT) {
        float q = qs[r];
        for (int o = 0; o < slices - 1; ++o)
          q += __ldcg(qp + (rtile0 + o) * tr + r);
        qs[r] = q;
      }
      __syncthreads();
    }
  }
  double aq = 0.0, an = 0.0;                     // the owner's warp sums
  if (last && tid >= NT - 32) {                  // |x|^2 and counts
    for (int r = tid - (NT - 32); r < tr; r += 32) {
      aq += qs[r];
      an += ws[r];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      aq += __shfl_xor_sync(0xffffffffu, aq, o);
      an += __shfl_xor_sync(0xffffffffu, an, o);
    }
  }

  // 3. publish the aggregate (a segment's first tile: its inclusive prefix)
  const double a4[4] = {ac[0], ac[1], ac[2], ac[3]};
  if (starts)
    put_record(incl + (size_t)t * ls, c4, cw, owner, a4, aq, an);
  else
    put_record(agg + (size_t)t * ls, c4, cw, owner, a4, aq, an);
  publish(flags, t, starts ? PREFIX : AGGREGATE);

  // 4. look back to the nearest inclusive prefix of this chain, 32
  //    predecessors at a time: warp 0 reads their flags at once and waits
  //    until every one up to the nearest prefix is set; then every thread
  //    adds those records (the aggregates, and that prefix)
  double pc[4] = {0.0, 0.0, 0.0, 0.0}, pq = 0.0, pn = 0.0;
  if (!starts) {
    for (int j = rt - 1;; j -= 32) {   // j: the window's nearest row tile
      if (tid < 32) {
        unsigned f = PREFIX;           // before row tile 0: never reached,
        unsigned pre;                  // since row tile 0 starts a segment
        while (true) {
          if (j - tid >= 0)
            f = ld_acquire(flags + (size_t)(j - tid) * slices + s);
          pre = __ballot_sync(0xffffffffu, f == PREFIX);
          const unsigned empty = __ballot_sync(0xffffffffu, f == 0);
          const unsigned upto = pre ? (pre & (0u - pre)) * 2u - 1u : ~0u;
          if (!(empty & upto)) break;
          __nanosleep(32);
        }
        if (tid == 0) s_word = pre ? (unsigned)(__ffs(pre) - 1) | 0x100u : 31u;
      }
      __syncthreads();
      const unsigned sw = s_word;
      __syncthreads();                 // s_word is read before it is reused
      const int nrec = (int)(sw & 0xffu) + 1;
      const bool hit = sw & 0x100u;
      const int nagg = nrec - (hit ? 1 : 0);
#pragma unroll 8
      for (int l = 0; l < nagg; ++l)
        add_record(agg + ((size_t)(j - l) * slices + s) * ls, c4, mine,
                   owner, cw, pc, pq, pn);
      if (hit) {
        add_record(incl + ((size_t)(j - nagg) * slices + s) * ls, c4, mine,
                   owner, cw, pc, pq, pn);
        break;
      }
    }
    const double p4[4] = {pc[0] + ac[0], pc[1] + ac[1], pc[2] + ac[2],
                          pc[3] + ac[3]};
    put_record(incl + (size_t)t * ls, c4, cw, owner, p4, pq + aq, pn + an);
    publish(flags, t, PREFIX);
  }

  // 5. prefix plus the tile's own running sums
  if (mine) {
    const float p0 = (float)pc[0], p1 = (float)pc[1], p2 = (float)pc[2],
                p3 = (float)pc[3];
    float r0 = 0.f, r1 = 0.f, r2 = 0.f, r3 = 0.f;
    for (int r = 0; r < tr; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(xs + r * ldx + c4);
      const float wr = ws[r];
      r0 += v.x * wr;
      r1 += v.y * wr;
      r2 += v.z * wr;
      r3 += v.w * wr;
      float* out = csum + (row0 + r) * d + cs0 + c4;
      if (VEC == 4) {
        *reinterpret_cast<float4*>(out) =
            make_float4(p0 + r0, p1 + r1, p2 + r2, p3 + r3);
      } else {
        const float o[4] = {p0 + r0, p1 + r1, p2 + r2, p3 + r3};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (c4 + i < cw) out[i] = o[i];
      }
    }
  }
  if (owner)
    for (int r = 0; r < tr; ++r) {
      pq += qs[r];
      pn += ws[r];
      qsum[row0 + r] = (float)pq;
      cnt[row0 + r] = (float)pn;
    }
}

template <int VEC>
int launch(const Plan& p, const float* x, const float* w, const int* b2s,
           unsigned char* scratch, float* csum, float* qsum, float* cnt,
           int bn, int d, cudaStream_t stream) {
  const int ldx = ((d < CS ? d : CS) + 3) & ~3;
  const size_t smem = sizeof(float) * ((size_t)p.tr * (ldx + 2));
  cudaError_t err = k2_set_smem(segmented_scan_kernel<VEC>, smem);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch, 0, p.flag_bytes, stream);
  if (err != cudaSuccess) return (int)err;
  float* agg = reinterpret_cast<float*>(scratch + p.flag_bytes);
  double* incl = reinterpret_cast<double*>(scratch + p.flag_bytes +
                                           p.agg_bytes);
  float* qp = reinterpret_cast<float*>(scratch + p.flag_bytes + p.agg_bytes +
                                       p.incl_bytes);
  segmented_scan_kernel<VEC><<<p.ntiles, NT, smem, stream>>>(
      x, w, b2s, reinterpret_cast<unsigned*>(scratch), agg, incl, qp, csum,
      qsum, cnt, bn, d, p.tr, p.slices, p.ls);
  return (int)cudaGetLastError();
}
}  // namespace

// Bytes of scratch that k2_segmented_scan needs for (nb*bn, d) rows.
K2_EXPORT int k2_segmented_scan_scratch(int nb, int bn, int d,
                                        size_t* bytes) {
  if (nb < 0 || bn < 1 || d < 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan(nb, bn, d);
  *bytes = p.flag_bytes + p.agg_bytes + p.incl_bytes + p.qp_bytes;
  return 0;
}

// x: (nb*bn, d) f32; w: (nb*bn,) f32; b2s: (nb,) i32, non-decreasing;
// scratch: k2_segmented_scan_scratch bytes, 256-byte aligned; csum:
// (nb*bn, d), qsum and cnt: (nb*bn,) f32.
K2_EXPORT int k2_segmented_scan(const float* x, const float* w, const int* b2s,
                                void* scratch, float* csum, float* qsum,
                                float* cnt, int nb, int bn, int d,
                                cudaStream_t stream) {
  if (nb < 0 || bn < 1 || d < 0) return (int)cudaErrorInvalidValue;
  if (nb == 0) return (int)cudaGetLastError();
  const Plan p = plan(nb, bn, d);
  unsigned char* s = static_cast<unsigned char*>(scratch);
  const bool vec = d % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)csum % 16 == 0;
  return vec ? launch<4>(p, x, w, b2s, s, csum, qsum, cnt, bn, d, stream)
             : launch<1>(p, x, w, b2s, s, csum, qsum, cnt, bn, d, stream);
}
