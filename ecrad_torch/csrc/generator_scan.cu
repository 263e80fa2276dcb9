// McICA cloud-generator level scan, in two builds.
//
// Replaces the TPU kernel ecrad_tpu/solvers/pallas_generator.py:
// generator_scan (_gen_kernel) and, in the draw build, the threefry draws
// that feed it (ecrad_tpu/solvers/cloud_generator.py draw).  Plain versions
// and wrappers: ecrad_torch/solvers/cuda_generator.py.
//
// Per (column, g-point) the scan carries found_cloud, is_cloud and the
// previous inhomogeneity draw down the levels (radiation_cloud_generator.F90:
// 587-720) and writes the CDF plane; the exp-exp variant chains the
// inhomogeneity draw across clear gaps (:497-509).  The scan is pure
// selection, so both builds equal their plain versions bit for bit.
//
// The planes-in build (generator_scan) takes the three random planes and
// the trigger, as the Pallas function does.  What bounds it on the H100:
// bytes.  Per element it reads three planes and writes one, with a few
// compares.  It runs one block per column with one thread per g-point, so
// that each level's loads are contiguous over g.
//
// The draw build (generator_draw_scan) makes the sample itself, from the
// per-column seeds: key = (0, seed), k_i = threefry2x32(key, (0, i)) for
// i = 0..3 (jax.random.key, split), the trigger uniform(k_1) at counter g
// times the total cloud cover, and rc, ri, ri2 uniform(k_2..k_4) at counter
// l * ng + g, with uniform as jax.random.uniform under
// jax_threefry_partitionable (float32: the top 23 bits of b0 ^ b1; float64:
// the top 52 bits of b0:b1).  So the three planes never touch device memory:
// it reads the packed per-level scalars and the seeds and writes the CDF.
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
// write CDF entries nlev apart (no main path runs that width).
#include <cstdint>

#include "common.cuh"

namespace {

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

template <typename T>
__global__ void generator_scan_kernel(const T *__restrict__ rc,
                                      const T *__restrict__ ri,
                                      const T *__restrict__ ri2,
                                      const T *__restrict__ scalars,
                                      const T *__restrict__ trigger,
                                      T *__restrict__ cdf, int nlev, int ng,
                                      int exp_exp) {
  const int col = blockIdx.x;
  const int g = threadIdx.x;
  if (g >= ng) return;  // no block-wide synchronisation in this kernel
  const T trig = trigger[(size_t)col * ng + g];
  bool found = false, is_cloud = false;
  T ri_prev = T(0);
  for (int l = 0; l < nlev; ++l) {
    const size_t idx = ((size_t)col * nlev + l) * ng + g;
    cdf[idx] = scan_level(scalars + ((size_t)col * nlev + l) * kNScalar,
                          trig, rc[idx], ri[idx], ri2[idx], exp_exp, found,
                          is_cloud, ri_prev);
  }
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

constexpr int kDrawThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kDrawThreads)
    generator_draw_scan_kernel(const uint32_t *__restrict__ iseed,
                               const T *__restrict__ scalars,
                               const T *__restrict__ total_cloud_cover,
                               T *__restrict__ cdf, int ncol, int nlev,
                               int ng, int exp_exp) {
  const int idx = blockIdx.x * kDrawThreads + threadIdx.x;
  if (idx >= ncol * ng) return;  // no barrier in this kernel
  const int col = idx / ng;
  const int g = idx - col * ng;
  const KeySchedule key = key_schedule(0u, iseed[col]);   // jax.random.key
  const KeySchedule k_rc = split(key, 1), k_ri = split(key, 2);
  const KeySchedule k_ri2 = split(key, 3);
  const T trig = draw<T>(split(key, 0), (uint32_t)g) * total_cloud_cover[col];
  bool found = false, is_cloud = false;
  T ri_prev = T(0);
  const T *sc = scalars + (size_t)col * nlev * kNScalar;
  T *out = cdf + (size_t)col * nlev * ng + g;
  uint32_t n = (uint32_t)g;
  for (int l = 0; l < nlev;
       ++l, n += (uint32_t)ng, sc += kNScalar, out += ng) {
    const T vrc = draw<T>(k_rc, n), vri = draw<T>(k_ri, n);
    const T vri2 = draw<T>(k_ri2, n);
    *out = scan_level(sc, trig, vrc, vri, vri2, exp_exp, found, is_cloud,
                      ri_prev);
  }
}

template <typename T>
int launch(const void *rc, const void *ri, const void *ri2,
           const void *scalars, const void *trigger, void *cdf, int ncol,
           int nlev, int ng, int exp_exp, void *stream) {
  const int threads = ((ng + 31) / 32) * 32;
  generator_scan_kernel<T><<<ncol, threads, 0, (cudaStream_t)stream>>>(
      (const T *)rc, (const T *)ri, (const T *)ri2, (const T *)scalars,
      (const T *)trigger, (T *)cdf, nlev, ng, exp_exp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_draw(const void *iseed, const void *scalars,
                const void *total_cloud_cover, void *cdf, int ncol, int nlev,
                int ng, int exp_exp, void *stream) {
  const long long n = (long long)ncol * ng;
  const int blocks = (int)((n + kDrawThreads - 1) / kDrawThreads);
  generator_draw_scan_kernel<T>
      <<<blocks, kDrawThreads, 0, (cudaStream_t)stream>>>(
          (const uint32_t *)iseed, (const T *)scalars,
          (const T *)total_cloud_cover, (T *)cdf, ncol, nlev, ng, exp_exp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ecrad_generator_scan_f32(const void *rc, const void *ri, const void *ri2,
                             const void *scalars, const void *trigger,
                             void *cdf, int ncol, int nlev, int ng,
                             int exp_exp, void *stream) {
  return launch<float>(rc, ri, ri2, scalars, trigger, cdf, ncol, nlev, ng,
                       exp_exp, stream);
}

int ecrad_generator_scan_f64(const void *rc, const void *ri, const void *ri2,
                             const void *scalars, const void *trigger,
                             void *cdf, int ncol, int nlev, int ng,
                             int exp_exp, void *stream) {
  return launch<double>(rc, ri, ri2, scalars, trigger, cdf, ncol, nlev, ng,
                        exp_exp, stream);
}

int ecrad_generator_draw_scan_f32(const void *iseed, const void *scalars,
                                  const void *total_cloud_cover, void *cdf,
                                  int ncol, int nlev, int ng, int exp_exp,
                                  void *stream) {
  return launch_draw<float>(iseed, scalars, total_cloud_cover, cdf, ncol,
                            nlev, ng, exp_exp, stream);
}

int ecrad_generator_draw_scan_f64(const void *iseed, const void *scalars,
                                  const void *total_cloud_cover, void *cdf,
                                  int ncol, int nlev, int ng, int exp_exp,
                                  void *stream) {
  return launch_draw<double>(iseed, scalars, total_cloud_cover, cdf, ncol,
                             nlev, ng, exp_exp, stream);
}

const char *ecrad_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
