// Correctly rounded |x|^2 and x.c for the torch code around the kernels:
// the value RN_f32(exact) that K1, K5 and K7 give a pair (common.cuh).
//
// Not a port of a TPU kernel. The reference forms these sums in f32 in its
// jnp glue (XLA); the port forms them in f64 and rounds once, and these two
// kernels make that one rounding correct, so that every path gives a pair
// one value:
// - k2_exact_sqnorm: the f64 sum of squares of each row (one warp a row,
//   lanes striding over d, a butterfly join), screened and, where the
//   screen cannot decide, recomputed exactly by the warp;
// - k2_exact_cross: the rounding of an f64 product s = a @ b taken outside
//   (torch.matmul, a DGEMM: a plain large product stays a library call),
//   one thread an element, screened with the f64 norms of a's row and b's
//   column (Cauchy-Schwarz); an element the screen cannot decide is recomputed
//   exactly from a and b by its whole warp. It replaces the f64 -> f32
//   cast;
// - k2_exact_rowdot: x[i] . y[idx[i]] for each row i (GDI's projections),
//   one warp a row, screened with the two rows' f64 norms, which the warp
//   sums beside the product.
// All are bound by bytes: one read of their input, one write of the f32
// output. The exact fallback runs for a few elements in a hundred thousand
// and reads its two rows again from global memory.
#include <stdint.h>
#include "common.cuh"

namespace {
constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
exact_sqnorm_kernel(const float* __restrict__ x, float* __restrict__ out,
                    long long rows, int d) {
  const long long r = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;               // a whole warp
  const float* xr = x + r * d;
  double s = 0.0;
  for (int j = lane; j < d; j += 32) s = fma((double)xr[j], (double)xr[j], s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float v = k2_round_sum_uniform(s, k2_gamma(d) * s, xr, 1, xr, 1, d);
  if (lane == 0) out[r] = v;
}

// element (t, i, j) of a (nbat, m, k) batch: a's row (t, i) has stride
// sad along d, b's column (t, j) stride sbd
__global__ void __launch_bounds__(NT)
exact_cross_kernel(const double* __restrict__ s, const float* __restrict__ a,
                   const float* __restrict__ b, const double* __restrict__ na,
                   const double* __restrict__ nb, float* __restrict__ out,
                   long long total, int m, int k, int d, long long sat,
                   long long sam, long long sad, long long sbt,
                   long long sbd, long long sbk) {
  // no early return: a flagged element is recomputed by its whole warp
  const long long e = min((long long)blockIdx.x * NT + threadIdx.x,
                          total - 1);
  const long long t = e / ((long long)m * k);
  const int i = (int)(e / k % m), j = (int)(e % k);
  const float* ar = a + t * sat + i * sam;
  const float* bc = b + t * sbt + j * sbk;
  const float v = k2_round_sum(s[e], k2_gamma(d) * na[t * m + i] *
                                         nb[t * k + j],
                               ar, sad, bc, sbd, d);
  if ((long long)blockIdx.x * NT + threadIdx.x < total) out[e] = v;
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
}  // namespace

// x: (rows, d) f32 contiguous; out: (rows,) f32.
K2_EXPORT int k2_exact_sqnorm(const float* x, float* out, long long rows,
                              int d, cudaStream_t stream) {
  if (rows < 0 || d < 0) return (int)cudaErrorInvalidValue;
  if (rows > 0)
    exact_sqnorm_kernel<<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT,
                          0, stream>>>(x, out, rows, d);
  return (int)cudaGetLastError();
}

// s: (nbat, m, k) f64 contiguous, the f64 product of a (nbat, m, d) and
// b (nbat, d, k), both f32 with the element strides given; na: (nbat, m)
// and nb: (nbat, k) f64 norms of a's rows and b's columns; out: (nbat, m,
// k) f32.
K2_EXPORT int k2_exact_cross(const double* s, const float* a, const float* b,
                             const double* na, const double* nb, float* out,
                             int nbat, int m, int k, int d, long long sat,
                             long long sam, long long sad, long long sbt,
                             long long sbd, long long sbk,
                             cudaStream_t stream) {
  if (nbat < 0 || m < 0 || k < 0 || d < 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)nbat * m * k;
  if (total > 0)
    exact_cross_kernel<<<(unsigned)((total + NT - 1) / NT), NT, 0, stream>>>(
        s, a, b, na, nb, out, total, m, k, d, sat, sam, sad, sbt, sbd, sbk);
  return (int)cudaGetLastError();
}

// x: (rows, d) f32 and y: (m, d) f32, contiguous; idx: (rows,) int64 in
// [0, m); out: (rows,) f32.
K2_EXPORT int k2_exact_rowdot(const float* x, const float* y,
                              const long long* idx, float* out,
                              long long rows, int d, cudaStream_t stream) {
  if (rows < 0 || d < 0) return (int)cudaErrorInvalidValue;
  if (rows > 0)
    exact_rowdot_kernel<<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT,
                          0, stream>>>(x, y, idx, out, rows, d);
  return (int)cudaGetLastError();
}
