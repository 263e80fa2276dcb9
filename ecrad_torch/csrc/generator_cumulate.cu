// McICA cloud generator: the overlap cumulator and the generator's packed
// per-level scalars in one launch.
//
// Replaces no TPU kernel (the JAX package leaves the cumulator to XLA): on
// the card it replaces the plain torch version, ecrad_torch/solvers/
// cuda_generator.py generator_cumulate_plain (cum_cloud_cover_exp_ran_jnp,
// then pack_scalars), a Python loop over the level pairs that issued ~1,250
// small kernels a band set.  Wrapper: cuda_generator.py generator_cumulate.
//
// One thread per column walks the levels in order (radiation_cloud_cover.F90
// :124-229, Exponential-Random, or Maximum-Random through max_ran) and
// carries the cumulative clear-sky product in a register; the previous
// level's fraction, cover, pair cover, overhang and inhomogeneity overlap
// (the _m1 fields) stay in registers too.  It writes each level's eight
// scalars in generator_scan.cu's order (any_cloud, frac, frac_m1, cum,
// cum_m1, pair_m1, overhang_m1, op_inhom_m1) as one run of 8 values (a
// 32-byte sector in float32), and the column's total cloud cover.
//
// The arithmetic is the plain version's, op for op, one rounding per torch
// op: the file compiles without FMA contraction (kernels.SOURCE_FLAGS) and
// divides in IEEE, so its float32 scalars equal the plain version's bit for
// bit.  That matters downstream: the generator's scan compares random
// numbers against these covers, and one decision flipped by a rounding
// turns a layer of a g-point from cloud to clear.  The inhomogeneity overlap
// op^(1/decorr) follows torch.pow with a scalar exponent on the card: its
// special cases (x * x at 2, the IFS's decorrelation scaling of 0.5), else
// pow.
//
// What bounds it: latency.  A band set of 8,192 columns reads ~9 MB and
// writes ~36 MB, ~14 us at 3.35 TB/s, but each thread runs nlev dependent
// steps with a division in each.  Blocks of 64 threads spread even 2,048
// columns over 32 SMs; there is no barrier and no shared memory.
#include "common.cuh"

namespace {

using ecrad::d_sqrt;

// packed scalar row (generator_scan.cu's order)
enum { kAny, kF, kFm1, kC, kCm1, kPm1, kOm1, kOpim1, kNScalar };

// cuda_generator.py MAX_CLOUD_FRAC: at or above it a layer is overcast
constexpr double kMaxCloudFrac = 1.0 - 2.0e-6;
constexpr int kCumulateThreads = 64;

__device__ __forceinline__ float d_pow(float x, float e) { return powf(x, e); }
__device__ __forceinline__ double d_pow(double x, double e) {
  return pow(x, e);
}
__device__ __forceinline__ float d_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double d_rsqrt(double x) { return rsqrt(x); }

// x ** e as torch.pow(tensor, e) computes it on the card: 1 at 0, x at 1,
// sqrt, rsqrt and the reciprocal at 0.5, -0.5 and -1; with e rounded to T,
// x * x, x * x * x and 1.0 / (x * x) (a double quotient) at 2, 3 and -2;
// else pow.
template <typename T>
__device__ __forceinline__ T pow_as_torch(T x, double e) {
  if (e == 0.0) return T(1);
  if (e == 1.0) return x;
  if (e == 0.5) return d_sqrt(x);
  if (e == -0.5) return d_rsqrt(x);
  if (e == -1.0) return T(1) / x;
  const T et = T(e);
  if (et == T(2)) return x * x;
  if (et == T(3)) return x * x * x;
  if (et == T(-2)) return T(1.0 / double(x * x));
  return d_pow(x, et);
}

// frac (ncol, nlev), overlap_param (ncol, nlev - 1); writes scalars (ncol,
// nlev, 8) and total_cloud_cover (ncol,)
template <typename T>
__global__ void __launch_bounds__(kCumulateThreads)
    generator_cumulate_kernel(const T *__restrict__ frac,
                              const T *__restrict__ overlap_param,
                              T *__restrict__ scalars,
                              T *__restrict__ total_cloud_cover, int ncol,
                              int nlev, int max_ran, double exponent,
                              T threshold) {
  const int col = blockIdx.x * kCumulateThreads + threadIdx.x;
  if (col >= ncol) return;  // no barrier in this kernel
  frac += (size_t)col * nlev;
  overlap_param += (size_t)col * (nlev - 1);
  T *out = scalars + (size_t)col * nlev * kNScalar;
  // level 0: cum = frac; its _m1 fields are the dummy level's zeros
  T f = frac[0], cum = f, cum_product = T(1) - f;
  T f_m1 = T(0), cum_m1 = T(0), pair_m1 = T(0), over_m1 = T(0);
  T op_m1 = T(0);
  for (int j = 0;; ++j, out += kNScalar) {
    out[kAny] = f >= threshold ? T(1) : T(0);
    out[kF] = f;
    out[kFm1] = f_m1;
    out[kC] = cum;
    out[kCm1] = cum_m1;
    out[kPm1] = pair_m1;
    out[kOm1] = over_m1;
    out[kOpim1] = op_m1;
    if (j == nlev - 1) break;
    const T f1 = frac[j + 1], a = overlap_param[j];
    const T fmax = f > f1 ? f : f1;
    const T pair =
        max_ran ? fmax : a * fmax + (T(1) - a) * ((f + f1) - f * f1);
    const T clear = T(1) - f;
    cum_product = f >= T(kMaxCloudFrac)
                      ? T(0)
                      : cum_product * (T(1) - pair) /
                            (clear < T(1.0e-12) ? T(1.0e-12) : clear);
    const T cum1 = T(1) - cum_product;
    f_m1 = f;
    cum_m1 = cum;
    pair_m1 = pair;
    over_m1 = cum1 - cum;
    op_m1 = a > T(0) ? pow_as_torch(a < T(1e-30) ? T(1e-30) : a, exponent)
                     : a;
    f = f1;
    cum = cum1;
  }
  total_cloud_cover[col] = cum;
}

template <typename T>
int launch(const void *frac, const void *overlap_param, void *scalars,
           void *total_cloud_cover, int ncol, int nlev, int max_ran,
           double exponent, double threshold, void *stream) {
  const int blocks = (ncol + kCumulateThreads - 1) / kCumulateThreads;
  generator_cumulate_kernel<T><<<blocks, kCumulateThreads, 0,
                                 (cudaStream_t)stream>>>(
      (const T *)frac, (const T *)overlap_param, (T *)scalars,
      (T *)total_cloud_cover, ncol, nlev, max_ran, exponent, T(threshold));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The cloud fraction (ncol, nlev) and overlap parameter (ncol, nlev - 1);
// writes the packed scalars (ncol, nlev, 8) and the total cloud cover
// (ncol,); Maximum-Random overlap where max_ran, else Exponential-Random;
// the inhomogeneity overlap's exponent 1 / decorr and the cloud-fraction
// threshold
int ecrad_generator_cumulate_f32(const void *frac, const void *overlap_param,
                                 void *scalars, void *total_cloud_cover,
                                 int ncol, int nlev, int max_ran,
                                 double exponent, double threshold,
                                 void *stream) {
  return launch<float>(frac, overlap_param, scalars, total_cloud_cover, ncol,
                       nlev, max_ran, exponent, threshold, stream);
}

int ecrad_generator_cumulate_f64(const void *frac, const void *overlap_param,
                                 void *scalars, void *total_cloud_cover,
                                 int ncol, int nlev, int max_ran,
                                 double exponent, double threshold,
                                 void *stream) {
  return launch<double>(frac, overlap_param, scalars, total_cloud_cover, ncol,
                        nlev, max_ran, exponent, threshold, stream);
}

}  // extern "C"
