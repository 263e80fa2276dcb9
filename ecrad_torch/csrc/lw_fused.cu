// Fused McICA longwave solver: two-stream + cloud merge + adding sweeps
// in one kernel.
//
// Replaces the TPU kernels of ecrad_tpu/solvers/pallas_mcica.py:lw_fused
// (_lw_p1_kernel, _lw_p2_kernel, _lw_p3_kernel, _lw_deriv_kernel: four
// pallas_calls).  Plain version and wrapper: ecrad_torch/solvers/
// cuda_mcica.py (lw_fused_plain, lw_fused).
//
// Per column and g-point, for each layer it computes the clear-sky
// no-scattering transmittance and sources, expands the band cloud
// properties to the g-point (band_of_g lookup), merges them for cloudy
// layers (_merge_lw) and computes lw_ref_trans.  Sweeps, in order:
//   P1 clear down;  fup_surf_c = emission + albedo * fdn_surf_c;
//   P2 surface -> TOA: clear up + total-sky Moebius up, storing the
//      albedo and source of the atmosphere below each layer;
//   P3 total-sky down;  fup_surf_t = albedo * fdn_surf_t + emission;
//   D  surface -> TOA: Hogan-Bozzo d(flux_up)/d(flux_up_surf), clear
//      and total, from d0 = fup_surf / sum_g fup_surf.
// Per-level broadband sums over g are deterministic block reductions
// (common.cuh block_sum), so repeated runs agree bit for bit.
//
// What bounds it on the H100: arithmetic and the level recurrence.  Each
// layer costs two to three exponentials and a division per g-point per
// sweep, recomputed in each of the four sweeps (as on the TPU) rather
// than stored; the only traffic besides the inputs is the per-layer
// albedo/source planes that link P2 to P3, which live in scratch that
// the wrapper allocates.  One block per column with one thread per
// g-point keeps the carries in registers, makes every level's loads
// contiguous over g, and puts the whole column's reductions inside one
// block.  The grid is one block per column, so no column is ever
// skipped, for any ncol.
#include "common.cuh"

namespace {

using namespace ecrad;

template <typename T> struct LwArgs {
  const T *od, *odc_b, *ssac_b, *gc_b, *od_scaling, *planck_hl;
  const unsigned char *mask;
  const T *emission, *albedo;
  const int *band_of_g;
  T *dn_bb_c, *fdn_surf_c, *up_bb_c, *fup_toa_c, *fup_surf_c;
  T *src_top_t, *dn_bb_t, *up_bb_t, *fdn_surf_t, *fup_surf_t;
  T *deriv_c, *deriv_t;      // null when derivatives are off
  T *alb_below, *src_below;  // scratch (ncol, nlev, ng)
  int nlev, ng, nband;
};

// Layer coefficients of one (column, layer, g): clear no-scattering and
// total-sky (cloud-merged where the layer is cloudy, clear otherwise).
template <typename T>
__device__ __forceinline__ void lw_layer(const LwArgs<T> &a, int col, int l,
                                         int g, int band, T &trans_c,
                                         T &s_up_c, T &s_dn_c, T &refl,
                                         T &trans, T &s_up, T &s_dn) {
  const size_t lg = ((size_t)col * a.nlev + l) * a.ng + g;
  const size_t hl = ((size_t)col * (a.nlev + 1) + l) * a.ng + g;
  const T od = a.od[lg];
  const T ptop = a.planck_hl[hl];
  const T pbot = a.planck_hl[hl + a.ng];
  lw_no_scattering_trans(od, ptop, pbot, trans_c, s_up_c, s_dn_c);
  if (a.mask[(size_t)col * a.nlev + l]) {
    const size_t lb = ((size_t)col * a.nlev + l) * a.nband + band;
    const T odc = a.od_scaling[lg] * a.odc_b[lb];
    T od_t, ssa_t, g_t;
    merge_lw(od, odc, a.ssac_b[lb], a.gc_b[lb], od_t, ssa_t, g_t);
    lw_ref_trans(od_t, ssa_t, g_t, ptop, pbot, refl, trans, s_up, s_dn);
  } else {
    refl = T(0);
    trans = trans_c;
    s_up = s_up_c;
    s_dn = s_dn_c;
  }
}

template <typename T>
__global__ void lw_fused_kernel(LwArgs<T> a) {
  __shared__ T red[2 * 32];
  const int col = blockIdx.x;
  const int g = threadIdx.x;
  const bool on = g < a.ng;
  const int band = on ? a.band_of_g[g] : 0;
  const int nlev = a.nlev;
  const size_t cg = (size_t)col * a.ng + g;
  const size_t cl0 = (size_t)col * nlev;
  T trans_c, s_up_c, s_dn_c, refl, trans, s_up, s_dn;

  // P1: clear-sky downward
  T fdn = T(0);
  for (int l = 0; l < nlev; ++l) {
    if (on) {
      const size_t hl = ((size_t)col * (nlev + 1) + l) * a.ng + g;
      lw_no_scattering_trans(a.od[(cl0 + l) * a.ng + g], a.planck_hl[hl],
                             a.planck_hl[hl + a.ng], trans_c, s_up_c,
                             s_dn_c);
      fdn = trans_c * fdn + s_dn_c;
    }
    T v[1] = {on ? fdn : T(0)};
    block_sum<T, 1>(v, red);
    if (threadIdx.x == 0) a.dn_bb_c[cl0 + l] = v[0];
  }
  const T emission = on ? a.emission[cg] : T(0);
  const T albedo = on ? a.albedo[cg] : T(0);
  const T fup_surf_c = emission + albedo * fdn;
  if (on) {
    a.fdn_surf_c[cg] = fdn;
    a.fup_surf_c[cg] = fup_surf_c;
  }

  // P2: clear up + total-sky Moebius up, surface -> TOA
  T fup = fup_surf_c, alb = albedo, src = emission;
  for (int l = nlev - 1; l >= 0; --l) {
    if (on) {
      lw_layer(a, col, l, g, band, trans_c, s_up_c, s_dn_c, refl, trans,
               s_up, s_dn);
      fup = trans_c * fup + s_up_c;
      const size_t lg = (cl0 + l) * a.ng + g;
      a.alb_below[lg] = alb;
      a.src_below[lg] = src;
      const T inv = T(1) / (T(1) - alb * refl);
      const T alb_new = refl + trans * trans * alb * inv;
      src = s_up + trans * (src + alb * s_dn) * inv;
      alb = alb_new;
    }
    T v[1] = {on ? fup : T(0)};
    block_sum<T, 1>(v, red);
    if (threadIdx.x == 0) a.up_bb_c[cl0 + l] = v[0];
  }
  if (on) {
    a.fup_toa_c[cg] = fup;
    a.src_top_t[cg] = src;
  }

  // P3: total-sky downward
  fdn = T(0);
  for (int l = 0; l < nlev; ++l) {
    T fupl = T(0);
    if (on) {
      lw_layer(a, col, l, g, band, trans_c, s_up_c, s_dn_c, refl, trans,
               s_up, s_dn);
      const size_t lg = (cl0 + l) * a.ng + g;
      const T alb_below = a.alb_below[lg];
      const T src_below = a.src_below[lg];
      const T inv = T(1) / (T(1) - alb_below * refl);
      fdn = (trans * fdn + refl * src_below + s_dn) * inv;
      fupl = alb_below * fdn + src_below;
    }
    T v[2] = {on ? fdn : T(0), fupl};
    block_sum<T, 2>(v, red);
    if (threadIdx.x == 0) {
      a.dn_bb_t[cl0 + l] = v[0];
      a.up_bb_t[cl0 + l] = v[1];
    }
  }
  const T fup_surf_t = albedo * fdn + emission;
  if (on) {
    a.fdn_surf_t[cg] = fdn;
    a.fup_surf_t[cg] = fup_surf_t;
  }
  if (a.deriv_c == nullptr) return;

  // D: LW derivatives, surface -> TOA
  __shared__ T tot[2];
  {
    T v[2] = {on ? fup_surf_c : T(0), on ? fup_surf_t : T(0)};
    block_sum<T, 2>(v, red);
    if (threadIdx.x == 0) {
      tot[0] = d_max(v[0], T(1e-30));
      tot[1] = d_max(v[1], T(1e-30));
    }
    __syncthreads();
  }
  T dc = fup_surf_c / tot[0];
  T dt = fup_surf_t / tot[1];
  for (int l = nlev - 1; l >= 0; --l) {
    if (on) {
      lw_layer(a, col, l, g, band, trans_c, s_up_c, s_dn_c, refl, trans,
               s_up, s_dn);
      dc = dc * trans_c;
      dt = dt * trans;
    }
    T v[2] = {on ? dc : T(0), on ? dt : T(0)};
    block_sum<T, 2>(v, red);
    if (threadIdx.x == 0) {
      a.deriv_c[cl0 + l] = v[0];
      a.deriv_t[cl0 + l] = v[1];
    }
  }
}

template <typename T>
int launch(void *const *p, int ncol, int nlev, int ng, int nband,
           void *stream) {
  LwArgs<T> a;
  a.od = (const T *)p[0];
  a.odc_b = (const T *)p[1];
  a.ssac_b = (const T *)p[2];
  a.gc_b = (const T *)p[3];
  a.od_scaling = (const T *)p[4];
  a.mask = (const unsigned char *)p[5];
  a.planck_hl = (const T *)p[6];
  a.emission = (const T *)p[7];
  a.albedo = (const T *)p[8];
  a.band_of_g = (const int *)p[9];
  a.dn_bb_c = (T *)p[10];
  a.fdn_surf_c = (T *)p[11];
  a.up_bb_c = (T *)p[12];
  a.fup_toa_c = (T *)p[13];
  a.fup_surf_c = (T *)p[14];
  a.src_top_t = (T *)p[15];
  a.dn_bb_t = (T *)p[16];
  a.up_bb_t = (T *)p[17];
  a.fdn_surf_t = (T *)p[18];
  a.fup_surf_t = (T *)p[19];
  a.deriv_c = (T *)p[20];
  a.deriv_t = (T *)p[21];
  a.alb_below = (T *)p[22];
  a.src_below = (T *)p[23];
  a.nlev = nlev;
  a.ng = ng;
  a.nband = nband;
  const int threads = ((ng + 31) / 32) * 32;
  lw_fused_kernel<T><<<ncol, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// p: the 24 tensor pointers in the order of LwArgs (deriv_c/deriv_t null
// when derivatives are off).
extern "C" int ecrad_lw_fused_f32(void *const *p, int ncol, int nlev,
                                  int ng, int nband, void *stream) {
  return launch<float>(p, ncol, nlev, ng, nband, stream);
}

extern "C" int ecrad_lw_fused_f64(void *const *p, int ncol, int nlev,
                                  int ng, int nband, void *stream) {
  return launch<double>(p, ncol, nlev, ng, nband, stream);
}
