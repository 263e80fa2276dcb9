// McICA cloud-generator level scan.
//
// Replaces the TPU kernel ecrad_tpu/solvers/pallas_generator.py:
// generator_scan (_gen_kernel).  Plain version and wrapper:
// ecrad_torch/solvers/cuda_generator.py.
//
// Per (column, g-point) it carries found_cloud, is_cloud and the previous
// inhomogeneity draw down the levels (radiation_cloud_generator.F90:
// 587-720) and writes the CDF plane; the exp-exp variant chains the
// inhomogeneity draw across clear gaps (:497-509).
//
// What bounds it on the H100: bytes.  Per element it reads three random
// planes and writes one, with a few compares; the per-level scalars are
// one 8-value row per column, read by every thread of the block.  The
// design keeps all carries in registers (the TPU kept them in VMEM
// scratch), runs one block per column with one thread per g-point so
// that each level's loads are contiguous over g, and uses booleans for
// the masks (the TPU needed f32 0/1 algebra).  The grid is one block per
// column, so no column is ever skipped, for any ncol.
#include "common.cuh"

namespace {

// packed scalar row (same order as the JAX package's _ANY.._OPIM1)
enum { kAny, kF, kFm1, kC, kCm1, kPm1, kOm1, kOpim1, kNScalar };

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
    const T *sc = scalars + ((size_t)col * nlev + l) * kNScalar;
    const T f = sc[kF], f_m1 = sc[kFm1], c = sc[kC], c_m1 = sc[kCm1];
    const T p_m1 = sc[kPm1], o_m1 = sc[kOm1], opi_m1 = sc[kOpim1];
    const bool any_c = sc[kAny] != T(0);
    const size_t idx = ((size_t)col * nlev + l) * ng + g;
    const T vrc = rc[idx], vri = ri[idx], vri2 = ri2[idx];

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
    cdf[idx] = emit;
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

const char *ecrad_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
