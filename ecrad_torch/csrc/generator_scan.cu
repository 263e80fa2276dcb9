// McICA cloud generator: the threefry draws, the overlap scan and the
// sampling epilogue in one kernel.
//
// Replaces the TPU kernel ecrad_tpu/solvers/pallas_generator.py:
// generator_scan (_gen_kernel), the threefry draws that feed it
// (ecrad_tpu/solvers/cloud_generator.py draw) and the generator's sampling
// epilogue.  Plain version and wrapper: ecrad_torch/solvers/
// cuda_generator.py (generator_draw_scan_plain, generator_draw_scan).
//
// The kernel makes the sample itself, from the per-column seeds: key =
// (0, seed), k_i = threefry2x32(key, (0, i)) for i = 0..3 (jax.random.key,
// split), the trigger uniform(k_1) at counter g times the total cloud
// cover, and rc, ri, ri2 uniform(k_2..k_4) at counter l * ng + g, with
// uniform as jax.random.uniform under jax_threefry_partitionable (float32:
// the top 23 bits of b0 ^ b1; float64: the top 52 bits of b0:b1).  Per
// (column, g-point) the scan carries found_cloud, is_cloud and the previous
// inhomogeneity draw down the levels (radiation_cloud_generator.F90:
// 587-720) and gives the CDF entry; the exp-exp variant chains the
// inhomogeneity draw across clear gaps (:497-509).  The draws and the scan
// are pure selection, so the CDF equals the plain version's bit for bit.
// Each CDF entry then becomes the optical-depth scaling in registers,
// exp(cheb(ndtri(cdf))) with the coefficients interpolated in the layer's
// fractional standard deviation (cuda_generator.py sample_pdf_cheb, the fit
// of cloud_generator.py fit_pdf_cheb), zero where the entry is 0 (the scan
// emits 0 in a layer below the cloud-fraction threshold) or the column's
// total cover is under the threshold.  So the random planes, the CDF plane
// and the sampler's full-plane temporaries never reach device memory: it
// reads the packed per-level scalars, the seeds and the fractional standard
// deviation and writes od_scaling once.
//
// What bounds it: integer operations.  Each element costs three
// Threefry-2x32 hashes of 20 rounds, about 75 integer operations each,
// against ~20 for the scan and 4-8 bytes written.  The design therefore
// keeps every lane busy: one thread per (column, g-point) over a flat index
// in blocks of 128, whatever ng is (140, 112, 32 or 1); there is no barrier,
// so nothing ties a thread to its column's block.  The three hashes of a
// level are independent of each other and of the carries, which leaves the
// scheduler three chains per thread and many warps per SM.  Rotations are
// funnel shifts.  The eight scalars of a level are shared by the g-points
// of a column and are read through L1.  At ng = 1 neighbouring threads
// write entries nlev apart.  A clear entry skips the epilogue; a cloudy one
// adds ~160 float operations and 30 coefficient loads (two rows of the
// fit's table, the same for every g-point of a column and level, so a
// warp's loads are broadcasts from L1) to the ~210 integer instructions of
// its draws, which still bound it.  The arithmetic follows the plain torch
// version op for op in the working type; nvcc contracts multiply-adds.
#include <cstdint>

#include "common.cuh"

namespace {

using ecrad::d_exp;
using ecrad::d_log;
using ecrad::d_sqrt;

// packed scalar row (same order as the JAX package's _ANY.._OPIM1)
enum { kAny, kF, kFm1, kC, kCm1, kPm1, kOm1, kOpim1, kNScalar };

// One level of the overlap scan for one (column, g-point): updates the
// carries and returns the CDF entry.
template <typename T>
__device__ __forceinline__ T scan_level(const T *__restrict__ sc, T trig,
                                        T vrc, T vri, T vri2, int exp_exp,
                                        bool &found, bool &is_cloud,
                                        T &ri_prev) {
  const T f = sc[kF], f_m1 = sc[kFm1], c = sc[kC], c_m1 = sc[kCm1];
  const T p_m1 = sc[kPm1], o_m1 = sc[kOm1], opi_m1 = sc[kOpim1];
  const bool any_c = sc[kAny] != T(0);
  const bool prev = is_cloud;
  const bool first = (trig <= c) && !found;
  found = found || first;
  const bool cond = prev ? (vrc * f_m1 < (f + f_m1 - p_m1))
                         : (vrc * (c_m1 - f_m1) < (p_m1 - o_m1 - f_m1));
  const bool isc = (first || (found && cond)) && any_c;
  const bool keep = vri2 < opi_m1;
  T emit;
  if (exp_exp) {
    const T chain = keep ? ri_prev : vri;
    emit = isc ? chain : T(0);
    ri_prev = chain;
  } else {
    emit = isc ? ((keep && prev) ? ri_prev : vri) : T(0);
    ri_prev = emit;
  }
  is_cloud = isc;
  return emit;
}

// --- Threefry-2x32 (20 rounds), as jax.random's threefry2x32 ----------------

struct KeySchedule {
  uint32_t k0, k1, k2;  // the key and k0 ^ k1 ^ 0x1BD11BDA
};

__device__ __forceinline__ KeySchedule key_schedule(uint32_t k0,
                                                    uint32_t k1) {
  return {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void rounds4(uint32_t &x0, uint32_t &x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

// (x0, x1) <- threefry2x32(key, (x0, x1))
__device__ __forceinline__ void threefry2x32(const KeySchedule &k,
                                             uint32_t &x0, uint32_t &x1) {
  x0 += k.k0; x1 += k.k1;
  rounds4<13, 15, 26, 6>(x0, x1);  x0 += k.k1; x1 += k.k2 + 1u;
  rounds4<17, 29, 16, 24>(x0, x1); x0 += k.k2; x1 += k.k0 + 2u;
  rounds4<13, 15, 26, 6>(x0, x1);  x0 += k.k0; x1 += k.k1 + 3u;
  rounds4<17, 29, 16, 24>(x0, x1); x0 += k.k1; x1 += k.k2 + 4u;
  rounds4<13, 15, 26, 6>(x0, x1);  x0 += k.k2; x1 += k.k0 + 5u;
}

// jax.random.uniform's [0, 1) from the hash's two words: the mantissa of
// [1, 2), minus 1 (exact)
__device__ __forceinline__ float to_uniform(uint32_t b0, uint32_t b1,
                                            float) {
  return __uint_as_float(((b0 ^ b1) >> 9) | 0x3f800000u) - 1.0f;
}

__device__ __forceinline__ double to_uniform(uint32_t b0, uint32_t b1,
                                             double) {
  return __hiloint2double((int)((b0 >> 12) | 0x3ff00000u),
                          (int)((b0 << 20) | (b1 >> 12))) - 1.0;
}

// uniform(key) at the flat counter n (< 2^32, so the high word is 0)
template <typename T>
__device__ __forceinline__ T draw(const KeySchedule &k, uint32_t n) {
  uint32_t x0 = 0u, x1 = n;
  threefry2x32(k, x0, x1);
  return to_uniform(x0, x1, T());
}

// split(key, 4)[i] = threefry2x32(key, (0, i))
__device__ __forceinline__ KeySchedule split(const KeySchedule &k,
                                             uint32_t i) {
  uint32_t x0 = 0u, x1 = i;
  threefry2x32(k, x0, x1);
  return key_schedule(x0, x1);
}

// --- the sampling epilogue (cuda_generator.py ndtri, cheb_eval) -----------

// Horner's steps y <- x * y + c over the coefficients c (cephes polevl from
// y = c0, p1evl from y = 1), the constants rounded to T as torch rounds a
// Python float
template <typename T>
__device__ __forceinline__ T horner(T, T y) {
  return y;
}
template <typename T, typename... C>
__device__ __forceinline__ T horner(T x, T y, double c, C... rest) {
  return horner(x, x * y + T(c), rest...);
}

constexpr double kExpM2 = 0.13533528323661269189;  // exp(-2)
constexpr double kS2Pi = 2.50662827463100050242;   // sqrt(2 pi)

// The inverse normal CDF (cephes; cuda_generator.py ndtri), evaluating only
// the branch of this element: the central rational approximation, or a
// tail's with x < 8 or x >= 8
template <typename T>
__device__ __forceinline__ T ndtri(T p) {
  const bool flip = p > T(1.0 - kExpM2);
  const T y = flip ? T(1) - p : p;
  if (y > T(kExpM2)) {
    const T yc = y - T(0.5);
    const T y2 = yc * yc;
    const T num = horner(y2, T(-5.99633501014107895267e1),
                         9.80010754185999661536e1, -5.66762857469070293439e1,
                         1.39312609387279679503e1, -1.23916583867381258016e0);
    const T den = horner(y2, T(1), 1.95448858338141759834e0,
                         4.67627912898881538453e0, 8.63602421390890590575e1,
                         -2.25462687854119370527e2, 2.00260212380060660359e2,
                         -8.20372256168538034268e1, 1.59056225126211695515e1,
                         -1.18331621121330003142e0);
    return (yc + yc * (y2 * num / den)) * T(kS2Pi);
  }
  const T ysafe = y < T(1e-30) ? T(1e-30) : (y > T(1) ? T(1) : y);
  const T x = d_sqrt(T(-2) * d_log(ysafe));
  const T x0 = x - d_log(x) / x;
  const T z = T(1) / x;
  T x1;
  if (x < T(8)) {
    x1 = z * horner(z, T(4.05544892305962419923e0), 3.15251094599893866154e1,
                    5.71628192246421288162e1, 4.40805073893200834700e1,
                    1.46849561928858024014e1, 2.18663306850790267539e0,
                    -1.40256079171354495875e-1, -3.50424626827848203418e-2,
                    -8.57456785154685413611e-4) /
         horner(z, T(1), 1.57799883256466749731e1, 4.53907635128879210584e1,
                4.13172038254672030440e1, 1.50425385692907503408e1,
                2.50464946208309415979e0, -1.42182922854787788574e-1,
                -3.80806407691578277194e-2, -9.33259480895457427372e-4);
  } else {
    x1 = z * horner(z, T(3.23774891776946035970e0), 6.91522889068984211695e0,
                    3.93881025292474443415e0, 1.33303460815807542389e0,
                    2.01485389549179081538e-1, 1.23716634817820021358e-2,
                    3.01581553508235416007e-4, 2.65806974686737550832e-6,
                    6.23974539184983651783e-9) /
         horner(z, T(1), 6.02427039364742014255e0, 3.67983563856160859403e0,
                1.37702099489081330271e0, 2.16236993594496635890e-1,
                1.34204006088543189037e-2, 3.28014464682127739104e-4,
                2.89247864745380683936e-6, 6.79019408009981274425e-9);
  }
  const T xt = x1 - x0;  // the lower tail's value
  return flip ? -xt : xt;
}

// The Chebyshev fit of log(od_scaling) in the normal quantile
// (cloud_generator.py fit_pdf_cheb; its table (nfsd, ncoef) in T is a kernel
// argument of its own) and the total-cover threshold
template <typename T>
struct ChebFit {
  int nfsd, ncoef;
  T z_sum, z_span, fsd1, inv_int, threshold;
};

// od_scaling of one cloudy CDF entry (cuda_generator.py sample_pdf_cheb:
// cheb_coeffs_for, then cheb_eval)
template <typename T>
__device__ __forceinline__ T sample_cheb(T cdf, T fsd,
                                         const T *__restrict__ cheb,
                                         const ChebFit<T> &fit) {
  const T p = cdf < T(1e-7) ? T(1e-7)
                            : (cdf > T(1.0 - 1e-7) ? T(1.0 - 1e-7) : cdf);
  const T t0 = (T(2) * ndtri(p) - fit.z_sum) / fit.z_span;
  const T t = t0 < T(-1) ? T(-1) : (t0 > T(1) ? T(1) : t0);
  // the fsd column: torch's int64 truncation, clamped to [1, nfsd - 1]
  const T wf = (fsd - fit.fsd1) * fit.inv_int + T(1);
  const int i = !(wf >= T(1)) ? 1
                : (wf >= T(fit.nfsd - 1) ? fit.nfsd - 1 : (int)wf);
  const T w0 = wf - T(i);
  const T w = w0 < T(0) ? T(0) : (w0 > T(1) ? T(1) : w0);
  const T *c0 = cheb + (i - 1) * fit.ncoef, *c1 = c0 + fit.ncoef;
  const T two_t = T(2) * t;
  T b1 = T(0), b2 = T(0);
  for (int k = fit.ncoef - 1; k > 0; --k) {
    const T b = two_t * b1 - b2 + ((T(1) - w) * c0[k] + w * c1[k]);
    b2 = b1;
    b1 = b;
  }
  return d_exp(t * b1 - b2 + ((T(1) - w) * c0[0] + w * c1[0]));
}

constexpr int kDrawThreads = 128;

// The draws, the scan and the epilogue, writing od_scaling (fsd (ncol,
// nlev), the fit's table cheb (nfsd, ncoef))
template <typename T>
__global__ void __launch_bounds__(kDrawThreads)
    generator_draw_scan_kernel(const uint32_t *__restrict__ iseed,
                               const T *__restrict__ scalars,
                               const T *__restrict__ total_cloud_cover,
                               const T *__restrict__ fsd,
                               const T *__restrict__ cheb, ChebFit<T> fit,
                               T *__restrict__ out, int ncol, int nlev,
                               int ng, int exp_exp) {
  const int idx = blockIdx.x * kDrawThreads + threadIdx.x;
  if (idx >= ncol * ng) return;  // no barrier in this kernel
  const int col = idx / ng;
  const int g = idx - col * ng;
  const KeySchedule key = key_schedule(0u, iseed[col]);   // jax.random.key
  const KeySchedule k_rc = split(key, 1), k_ri = split(key, 2);
  const KeySchedule k_ri2 = split(key, 3);
  const T tcc = total_cloud_cover[col];
  const T trig = draw<T>(split(key, 0), (uint32_t)g) * tcc;
  // the column mask: the total cover thresholded, > 0
  const bool col_on = tcc >= fit.threshold && tcc > T(0);
  bool found = false, is_cloud = false;
  T ri_prev = T(0);
  const T *sc = scalars + (size_t)col * nlev * kNScalar;
  out += (size_t)col * nlev * ng + g;
  uint32_t n = (uint32_t)g;
  for (int l = 0; l < nlev;
       ++l, n += (uint32_t)ng, sc += kNScalar, out += ng) {
    const T vrc = draw<T>(k_rc, n), vri = draw<T>(k_ri, n);
    const T vri2 = draw<T>(k_ri2, n);
    const T cdf = scan_level(sc, trig, vrc, vri, vri2, exp_exp, found,
                             is_cloud, ri_prev);
    *out = (cdf > T(0) && col_on)
               ? sample_cheb(cdf, fsd[(size_t)col * nlev + l], cheb, fit)
               : T(0);
  }
}

template <typename T>
int launch(const void *iseed, const void *scalars,
           const void *total_cloud_cover, const void *fsd, const void *cheb,
           void *od_scaling, int ncol, int nlev, int ng, int exp_exp,
           int nfsd, int ncoef, double z_sum, double z_span, double fsd1,
           double inv_int, double threshold, void *stream) {
  const ChebFit<T> fit{nfsd, ncoef, T(z_sum), T(z_span), T(fsd1),
                       T(inv_int), T(threshold)};
  const long long n = (long long)ncol * ng;
  const int blocks = (int)((n + kDrawThreads - 1) / kDrawThreads);
  generator_draw_scan_kernel<T><<<blocks, kDrawThreads, 0,
                                  (cudaStream_t)stream>>>(
      (const uint32_t *)iseed, (const T *)scalars,
      (const T *)total_cloud_cover, (const T *)fsd, (const T *)cheb, fit,
      (T *)od_scaling, ncol, nlev, ng, exp_exp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The seeds (ncol,) as uint32, the packed scalars (ncol, nlev, 8), the
// total cloud cover (ncol,), the fractional standard deviation (ncol, nlev),
// the fit's table (nfsd, ncoef) and axes (z_lo + z_hi, z_hi - z_lo, fsd1,
// inv_int) and the cloud-fraction threshold; writes od_scaling (ncol, nlev,
// ng)
int ecrad_generator_draw_sample_f32(
    const void *iseed, const void *scalars, const void *total_cloud_cover,
    const void *fsd, const void *cheb, void *od_scaling, int ncol, int nlev,
    int ng, int exp_exp, int nfsd, int ncoef, double z_sum, double z_span,
    double fsd1, double inv_int, double threshold, void *stream) {
  return launch<float>(iseed, scalars, total_cloud_cover, fsd, cheb,
                       od_scaling, ncol, nlev, ng, exp_exp, nfsd,
                       ncoef, z_sum, z_span, fsd1, inv_int, threshold,
                       stream);
}

int ecrad_generator_draw_sample_f64(
    const void *iseed, const void *scalars, const void *total_cloud_cover,
    const void *fsd, const void *cheb, void *od_scaling, int ncol, int nlev,
    int ng, int exp_exp, int nfsd, int ncoef, double z_sum, double z_span,
    double fsd1, double inv_int, double threshold, void *stream) {
  return launch<double>(iseed, scalars, total_cloud_cover, fsd, cheb,
                        od_scaling, ncol, nlev, ng, exp_exp, nfsd,
                        ncoef, z_sum, z_span, fsd1, inv_int, threshold,
                        stream);
}

const char *ecrad_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
