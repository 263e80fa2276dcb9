// Shared device code for the ecrad_torch CUDA kernels: math overloads,
// the two-stream layer coefficients (same formulas as
// ecrad_torch/solvers/two_stream.py, which is the plain version), the
// McICA cloud merges, and a deterministic block reduction over g-points.
//
// Every kernel of this package runs one thread block per column with one
// thread per g-point, in the classic (ncol, nlev, ng) layout, so that the
// loads of one level are contiguous across a warp; the level recurrences
// are loops inside each thread.
#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace ecrad {

__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return exp(x); }
__device__ __forceinline__ float d_expm1(float x) { return expm1f(x); }
__device__ __forceinline__ double d_expm1(double x) { return expm1(x); }
__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float d_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double d_abs(double x) { return fabs(x); }

template <typename T> __device__ __forceinline__ T d_max(T a, T b) {
  return a > b ? a : b;
}
template <typename T> __device__ __forceinline__ T d_min(T a, T b) {
  return a < b ? a : b;
}

template <typename T> struct Limits;
// k_min: the Meador-Weaver k guard (1e-12 in double, 1e-6 in single
// precision).  tiny: the 1e-300 floor of the reference's merge divisions,
// which rounds to 0 in float, so every division it guards sits behind a
// branch on the divisor's sign, as in the reference's where().
template <> struct Limits<float> {
  static __device__ __forceinline__ float k_min() { return 1.0e-6f; }
  static __device__ __forceinline__ float eps() { return FLT_EPSILON; }
  static __device__ __forceinline__ float tiny() { return 0.0f; }
};
template <> struct Limits<double> {
  static __device__ __forceinline__ double k_min() { return 1.0e-12; }
  static __device__ __forceinline__ double eps() { return DBL_EPSILON; }
  static __device__ __forceinline__ double tiny() { return 1.0e-300; }
};

constexpr double kLwDiffusivity = 1.66;

// LW no-scattering transmittance + sources (radiation_two_stream.F90:
// 342-409).
template <typename T>
__device__ __forceinline__ void lw_no_scattering_trans(
    T od, T ptop, T pbot, T &trans, T &src_up, T &src_dn) {
  const T coeff0 = T(kLwDiffusivity) * od;
  trans = d_exp(-coeff0);
  if (od > T(1.0e-3)) {
    const T coeff = (pbot - ptop) / d_max(coeff0, T(1.0e-30));
    src_up = (coeff + ptop) - trans * (coeff + pbot);
    src_dn = (-coeff + pbot) - trans * (-coeff + ptop);
  } else {
    src_up = src_dn = coeff0 * T(0.5) * (ptop + pbot);
  }
}

// LW reflectance/transmittance + linear-in-tau sources
// (radiation_two_stream.F90:246-334).
template <typename T>
__device__ __forceinline__ void lw_ref_trans(
    T od, T ssa, T g, T ptop, T pbot, T &refl, T &trans, T &src_up,
    T &src_dn) {
  const T factor = T(kLwDiffusivity * 0.5) * ssa;
  const T gamma1 = T(kLwDiffusivity) - factor * (T(1) + g);
  const T gamma2 = factor * (T(1) - g);
  const T k = d_sqrt(d_max((gamma1 - gamma2) * (gamma1 + gamma2),
                           Limits<T>::k_min()));
  if (od > T(1.0e-3)) {
    const T exponential = d_exp(-k * od);
    const T exponential2 = exponential * exponential;
    const T reftrans_factor =
        T(1) / (k + gamma1 + (k - gamma1) * exponential2);
    refl = gamma2 * (T(1) - exponential2) * reftrans_factor;
    trans = T(2) * k * exponential * reftrans_factor;
    const T coeff = (pbot - ptop) / (od * (gamma1 + gamma2));
    const T coeff_up_top = coeff + ptop;
    const T coeff_up_bot = coeff + pbot;
    const T coeff_dn_top = -coeff + ptop;
    const T coeff_dn_bot = -coeff + pbot;
    src_up = coeff_up_top - refl * coeff_dn_top - trans * coeff_up_bot;
    src_dn = coeff_dn_bot - refl * coeff_up_bot - trans * coeff_dn_top;
  } else {
    refl = gamma2 * od;
    trans = (T(1) - k * od) / (T(1) + od * (gamma1 - k));
    src_up = src_dn = (T(1) - refl - trans) * T(0.5) * (ptop + pbot);
  }
}

// Direct-beam transmittance (the trans_dir_dir of sw_ref_trans).
template <typename T>
__device__ __forceinline__ T sw_direct_trans(T mu0, T od) {
  return d_exp(d_max(-d_max(od / mu0, T(0)), T(-1000)));
}

// SW Meador-Weaver coefficients (radiation_two_stream.F90:563-775), in
// the regrouped expm1 form of ecrad_torch/solvers/two_stream.py.
template <typename T>
__device__ __forceinline__ void sw_ref_trans(
    T mu0, T od, T ssa, T g, T &ref_diff, T &trans_diff, T &ref_dir,
    T &trans_dir_diff, T &trans_dir_dir) {
  trans_dir_dir = sw_direct_trans(mu0, od);
  const T factor = T(0.75) * g;
  const T gamma1 = T(2) - ssa * (T(1.25) + factor);
  const T gamma2 = ssa * (T(0.75) - factor);
  const T gamma3 = T(0.5) - mu0 * factor;
  const T gamma4 = T(1) - gamma3;
  const T alpha1 = gamma1 * gamma4 + gamma2 * gamma3;
  const T alpha2 = gamma1 * gamma3 + gamma2 * gamma4;
  const T ksq = (T(2) * (T(1) - ssa)) * (T(2) - ssa * (T(0.5) + T(1.5) * g));
  const T k = d_sqrt(d_max(ksq, T(1.0e-12)));

  const T exponential = d_exp(-k * od);
  const T exponential2 = exponential * exponential;
  const T one_minus_exp2 = -d_expm1(T(-2) * k * od);
  const T k_mu0 = k * mu0;
  const T one_minus_kmu0_sqr = (T(1) - k_mu0) * (T(1) + k_mu0);
  const T k_2_exponential = T(2) * k * exponential;
  const T reftrans_factor =
      T(1) / (k * (T(1) + exponential2) + gamma1 * one_minus_exp2);

  ref_diff = gamma2 * one_minus_exp2 * reftrans_factor;
  trans_diff = d_min(d_max(k_2_exponential * reftrans_factor, T(0)),
                     T(1) - ref_diff);

  const T eps = Limits<T>::eps();
  const T denom = d_abs(one_minus_kmu0_sqr) > eps ? one_minus_kmu0_sqr : eps;
  const T reftrans_dir = mu0 * ssa * reftrans_factor / denom;

  T rdir = reftrans_dir *
           (alpha2 * (one_minus_exp2 - k_mu0 * (T(1) + exponential2)) +
            k * gamma3 * ((T(1) - k_mu0) + (T(1) + k_mu0) * exponential2) -
            k_2_exponential * (gamma3 - alpha2 * mu0) * trans_dir_dir);
  T tdif = reftrans_dir *
           (k_2_exponential * (gamma4 + alpha1 * mu0) -
            trans_dir_dir *
                (alpha1 * (one_minus_exp2 + k_mu0 * (T(1) + exponential2)) +
                 k * gamma4 *
                     ((T(1) + k_mu0) + (T(1) - k_mu0) * exponential2)));
  const T max_dir = mu0 * (T(1) - trans_dir_dir);
  rdir = d_min(d_max(rdir, T(0)), max_dir);
  tdif = d_min(d_max(tdif, T(0)), max_dir - rdir);
  ref_dir = rdir;
  trans_dir_diff = tdif;
}

template <typename T>
__device__ __forceinline__ void delta_eddington(T &od, T &ssa, T &g) {
  const T f = g * g;
  const T od_new = od * (T(1) - ssa * f);
  const T ssa_new = ssa * (T(1) - f) / (T(1) - ssa * f);
  const T g_new = g / (T(1) + g);
  od = od_new;
  ssa = ssa_new;
  g = g_new;
}

// Total-sky LW merge of a cloudy layer (radiation_mcica_lw.F90:133-171,
// cloud scattering on, aerosol scattering off).
template <typename T>
__device__ __forceinline__ void merge_lw(T od, T odc, T ssac, T gc,
                                         T &od_t, T &ssa_t, T &g_t) {
  od_t = od + odc;
  const T scat = ssac * odc;
  const T gscat = gc * ssac * odc;
  ssa_t = od_t > T(0) ? scat / d_max(od_t, Limits<T>::tiny()) : T(0);
  g_t = scat > T(0) ? gscat / d_max(scat, Limits<T>::tiny()) : T(0);
}

// Total-sky SW merge of a cloudy layer (radiation_mcica_sw.F90).
template <typename T>
__device__ __forceinline__ void merge_sw(T od, T ssa, T g, T odc, T ssac,
                                         T gc, T &od_t, T &ssa_t, T &g_t) {
  od_t = od + odc;
  const T scat = ssa * od + ssac * odc;
  const T gscat = g * ssa * od + gc * ssac * odc;
  ssa_t = od_t > T(0) ? scat / d_max(od_t, Limits<T>::tiny()) : T(0);
  g_t = scat > T(0) ? gscat / d_max(scat, Limits<T>::tiny()) : T(0);
}

// --- Tripleclouds: per-level overlap data and the interface mixes ---------
// The overlap matrices are stored per interface as 9 entries, k = 3*i + j
// (interface j lies above layer j; interface nlev is the surface).
template <typename T> struct TcLevel {
  T u[9], v[9];  // overlap matrices at the interface the sweep mixes at
  T rf[3];       // region fractions of the layer
  T scal[2];     // od scalings of the two cloudy regions
  int clear;     // the layer is clear (cloud fraction <= 0)
  int skip;      // ... and so is its neighbour across that interface
};

// Stage one level's per-column data in shared memory: the same for every
// g-point, so a few threads load it once and the block reads it after the
// barrier.  u9/rf3 may be null (the SW sweeps do not read them).  `other`
// is the neighbouring layer across the mixing interface; layers outside
// 0..nlev-1 count as clear.  The caller must not overwrite `s` before every
// thread is done reading the previous level (a block_sum or a barrier).
template <typename T>
__device__ __forceinline__ void tc_stage(TcLevel<T> &s, const T *u9,
                                         const T *v9, const T *rf3,
                                         const T *scal2,
                                         const unsigned char *clear, int col,
                                         int nlev, int l, int iface,
                                         int other) {
  const int t = threadIdx.x;
  const size_t ifo = ((size_t)col * (nlev + 1) + iface) * 9;
  const size_t lo = (size_t)col * nlev + l;
  if (t < 9) {
    if (u9 != nullptr) s.u[t] = u9[ifo + t];
    s.v[t] = v9[ifo + t];
  } else if (t < 12) {
    if (rf3 != nullptr) s.rf[t - 9] = rf3[lo * 3 + (t - 9)];
  } else if (t < 14) {
    s.scal[t - 12] = scal2[lo * 2 + (t - 12)];
  } else if (t == 14) {
    const bool c = clear[lo] != 0;
    const bool o = (other < 0 || other >= nlev)
                       ? true
                       : clear[(size_t)col * nlev + other] != 0;
    s.clear = c;
    s.skip = c && o;
  }
  __syncthreads();
}

// out[r] = sum_l m[3l + r] x[l]: the v-matrix mix of the up sweeps
// (pallas_tripleclouds._mix_v).
template <typename T>
__device__ __forceinline__ void mix_cols(const T *m, const T (&x)[3],
                                         T (&out)[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
    out[r] = m[r] * x[0] + m[3 + r] * x[1] + m[6 + r] * x[2];
}

// out[i] = sum_j m[3i + j] x[j]: the v-matrix mix of the down sweeps and
// the u-matrix mix of sources and derivatives (_mix_v_dn, _mix_u).
template <typename T>
__device__ __forceinline__ void mix_rows(const T *m, const T (&x)[3],
                                         T (&out)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = m[3 * i] * x[0] + m[3 * i + 1] * x[1] + m[3 * i + 2] * x[2];
}

// Deterministic sum of NV values over the threads of a block (at most
// 1024 threads): a fixed shuffle tree within each warp, then thread 0
// adds the warp partials in warp order.  Every thread of the block must
// call it; the result is valid in thread 0 only.  `red` is shared
// scratch of NV * 32 elements.
template <typename T, int NV>
__device__ __forceinline__ void block_sum(T (&v)[NV], T *red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarp = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[i] += __shfl_down_sync(0xffffffffu, v[i], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) red[i * 32 + warp] = v[i];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      T s = red[i * 32];
      for (int w = 1; w < nwarp; ++w) s += red[i * 32 + w];
      v[i] = s;
    }
  }
  __syncthreads();
}

}  // namespace ecrad
