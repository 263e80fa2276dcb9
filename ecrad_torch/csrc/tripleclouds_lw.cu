// Fused Tripleclouds longwave solver: per-region two-stream + region
// merge + overlap-coupled adding sweeps in one kernel.
//
// Replaces the TPU kernels of ecrad_tpu/solvers/pallas_tripleclouds.py:
// lw_fused (pallas_mcica._lw_p1_kernel, _lw_up_kernel, _lw_dn_kernel,
// _lw_deriv_kernel: four pallas_calls).  Plain version and wrapper:
// ecrad_torch/solvers/cuda_tripleclouds.py (lw_fused_plain, lw_fused).
//
// Per column and g-point, each layer has three regions: region 0 is the
// clear sky (no-scattering transmittance, sources scaled by its fraction),
// regions 1 and 2 the cloud with the two od scalings, merged with the gas
// (absorption only) and passed through lw_ref_trans, sources scaled by
// region fraction; in a clear layer they take refl 0, trans 1, sources 0.
// Sweeps, in order:
//   P1 clear down (unscaled sources); fup_surf_c = emission + albedo*fdn;
//   P2 surface -> TOA: clear up, and the 3-region Moebius up sweep of
//      albedo and source, storing both below each layer; the carries mix
//      at the interface ABOVE the layer (albedo with v, source with u);
//   P3 3-region down, mixing with v at the interface BELOW the layer;
//   D  surface -> TOA region-coupled derivative: dg = (u dg) * trans with
//      u at the interface BELOW the layer, from d0 = fup_surf /
//      max(sum_g fup_surf, 1e-30) in region 0.
// A mix is skipped where the layer and its neighbour across the interface
// are both clear (layers above TOA and below the surface count as clear).
// Per-level broadband sums are deterministic block reductions.
//
// What bounds it on the H100: arithmetic.  Each layer costs three
// exponentials per region and g-point in each of the three sweeps that
// need the coefficients (recomputed, not stored, as on the TPU), and the
// level recurrence serialises the column.  One block per column with one
// thread per g-point keeps the six carries in registers and the loads of a
// level contiguous over g; the per-column overlap data of a level (18
// matrix entries, 3 fractions, 2 scalings, the clear flags) is staged once
// in shared memory by a few threads.  The P2 -> P3 link (albedo and
// source below each layer, per region) goes through scratch planes that
// the wrapper allocates.  One block per column covers any ncol.
#include "common.cuh"

namespace {

using namespace ecrad;

template <typename T> struct TcLwArgs {
  const T *od, *odc_b, *ssac_b, *gc_b, *scal2;
  const unsigned char *clear;
  const T *rf3, *u9, *v9, *planck_hl, *emission, *albedo, *src0;
  const int *band_of_g;
  T *dn_bb_c, *fdn_surf_c, *fup_surf_c, *up_bb_c, *fup_toa_c, *src_top_t;
  T *dn_bb_t, *up_bb_t, *fdn_surf_t, *fup_surf_t;
  T *deriv_t;           // null when derivatives are off
  T *albb, *srcb;       // scratch (ncol, nlev, 3, ng)
  int nlev, ng, nband;
};

// The clear no-scattering coefficients and the three regions' (refl,
// trans, src_up, src_dn) of one (column, layer, g-point).
template <typename T>
__device__ __forceinline__ void lw_regions(
    const TcLwArgs<T> &a, const TcLevel<T> &s, int col, int l, int g,
    int band, T &trans_c, T &su_c, T &sd_c, T (&refl)[3], T (&trans)[3],
    T (&su)[3], T (&sd)[3]) {
  const size_t lg = ((size_t)col * a.nlev + l) * a.ng + g;
  const size_t hl = ((size_t)col * (a.nlev + 1) + l) * a.ng + g;
  const T od = a.od[lg];
  const T ptop = a.planck_hl[hl];
  const T pbot = a.planck_hl[hl + a.ng];
  lw_no_scattering_trans(od, ptop, pbot, trans_c, su_c, sd_c);
  refl[0] = T(0);
  trans[0] = trans_c;
  su[0] = su_c * s.rf[0];
  sd[0] = sd_c * s.rf[0];
  if (s.clear) {
#pragma unroll
    for (int r = 1; r < 3; ++r) {
      refl[r] = T(0);
      trans[r] = T(1);
      su[r] = sd[r] = T(0);
    }
    return;
  }
  const size_t lb = ((size_t)col * a.nlev + l) * a.nband + band;
  const T odcb = a.odc_b[lb], ssacb = a.ssac_b[lb], gcb = a.gc_b[lb];
#pragma unroll
  for (int r = 1; r < 3; ++r) {
    // tripleclouds._merge_regions with ssa = g = 0 for the gas; the 1e-300
    // floors behind a test of the divisor (0 in float)
    const T odc = s.scal[r - 1] * odcb;
    const T od_t = od + odc;
    const T scat = ssacb * odc;
    const T ssa_t =
        od_t > T(0) ? scat / d_max(od_t, Limits<T>::tiny()) : T(0);
    const T g_t =
        scat > T(0) ? (gcb * scat) / d_max(scat, Limits<T>::tiny()) : T(0);
    lw_ref_trans(od_t, ssa_t, g_t, ptop, pbot, refl[r], trans[r], su[r],
                 sd[r]);
    su[r] *= s.rf[r];
    sd[r] *= s.rf[r];
  }
}

template <typename T>
__global__ void tripleclouds_lw_kernel(TcLwArgs<T> a) {
  __shared__ T red[2 * 32];
  __shared__ T total;
  __shared__ TcLevel<T> s;
  const int col = blockIdx.x;
  const int g = threadIdx.x;
  const bool on = g < a.ng;
  const int band = on ? a.band_of_g[g] : 0;
  const int nlev = a.nlev, ng = a.ng;
  const size_t cg = (size_t)col * ng + g;
  const size_t cl0 = (size_t)col * nlev;
  // per-region index of (column, layer l, region r, g) and (column, r, g)
  auto lgr = [&](int l, int r) {
    return ((cl0 + l) * 3 + r) * (size_t)ng + g;
  };
  auto cgr = [&](int r) { return ((size_t)col * 3 + r) * ng + g; };
  T trans_c, su_c, sd_c, refl[3], trans[3], su[3], sd[3];

  // P1: clear-sky downward
  T fdn = T(0);
  for (int l = 0; l < nlev; ++l) {
    if (on) {
      const size_t hl = ((size_t)col * (nlev + 1) + l) * ng + g;
      lw_no_scattering_trans(a.od[(cl0 + l) * ng + g], a.planck_hl[hl],
                             a.planck_hl[hl + ng], trans_c, su_c, sd_c);
      fdn = trans_c * fdn + sd_c;
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

  // P2: clear up + 3-region Moebius up, surface -> TOA
  T fup = fup_surf_c;
  T alb[3] = {albedo, albedo, albedo};
  T src[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) src[r] = on ? a.src0[cgr(r)] : T(0);
  for (int l = nlev - 1; l >= 0; --l) {
    tc_stage(s, a.u9, a.v9, a.rf3, a.scal2, a.clear, col, nlev, l, l, l - 1);
    if (on) {
      lw_regions(a, s, col, l, g, band, trans_c, su_c, sd_c, refl, trans,
                 su, sd);
      fup = trans_c * fup + su_c;
      T an[3], sn[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        a.albb[lgr(l, r)] = alb[r];
        a.srcb[lgr(l, r)] = src[r];
        const T inv = T(1) / (T(1) - alb[r] * refl[r]);
        an[r] = refl[r] + trans[r] * trans[r] * alb[r] * inv;
        sn[r] = su[r] + trans[r] * (src[r] + alb[r] * sd[r]) * inv;
      }
      if (s.skip) {
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          alb[r] = an[r];
          src[r] = sn[r];
        }
      } else {
        mix_cols(s.v, an, alb);
        mix_rows(s.u, sn, src);
      }
    }
    T v[1] = {on ? fup : T(0)};
    block_sum<T, 1>(v, red);
    if (threadIdx.x == 0) a.up_bb_c[cl0 + l] = v[0];
  }
  if (on) {
    a.fup_toa_c[cg] = fup;
#pragma unroll
    for (int r = 0; r < 3; ++r) a.src_top_t[cgr(r)] = src[r];
  }

  // P3: 3-region downward
  T fd[3] = {T(0), T(0), T(0)};
  T dn_g = T(0), up_g = T(0);
  for (int l = 0; l < nlev; ++l) {
    tc_stage(s, a.u9, a.v9, a.rf3, a.scal2, a.clear, col, nlev, l, l + 1,
             l + 1);
    if (on) {
      lw_regions(a, s, col, l, g, band, trans_c, su_c, sd_c, refl, trans,
                 su, sd);
      T f[3], u[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const T ab = a.albb[lgr(l, r)];
        const T sb = a.srcb[lgr(l, r)];
        f[r] = (trans[r] * fd[r] + refl[r] * sb + sd[r]) /
               (T(1) - refl[r] * ab);
        u[r] = sb + f[r] * ab;
      }
      if (s.clear) f[1] = f[2] = u[1] = u[2] = T(0);
      dn_g = f[0] + f[1] + f[2];
      up_g = u[0] + u[1] + u[2];
      if (s.skip) {
#pragma unroll
        for (int r = 0; r < 3; ++r) fd[r] = f[r];
      } else {
        mix_rows(s.v, f, fd);
      }
    }
    T v[2] = {dn_g, up_g};
    block_sum<T, 2>(v, red);
    if (threadIdx.x == 0) {
      a.dn_bb_t[cl0 + l] = v[0];
      a.up_bb_t[cl0 + l] = v[1];
    }
  }
  if (on) {
    a.fdn_surf_t[cg] = dn_g;
    a.fup_surf_t[cg] = up_g;
  }
  if (a.deriv_t == nullptr) return;

  // D: region-coupled derivatives, surface -> TOA
  {
    T v[1] = {up_g};
    block_sum<T, 1>(v, red);
    if (threadIdx.x == 0) total = d_max(v[0], T(1e-30));
    __syncthreads();
  }
  T dg[3] = {up_g / total, T(0), T(0)};
  for (int l = nlev - 1; l >= 0; --l) {
    tc_stage(s, a.u9, a.v9, a.rf3, a.scal2, a.clear, col, nlev, l, l + 1,
             l + 1);
    T dsum = T(0);
    if (on) {
      lw_regions(a, s, col, l, g, band, trans_c, su_c, sd_c, refl, trans,
                 su, sd);
      T m[3];
      mix_rows(s.u, dg, m);
#pragma unroll
      for (int r = 0; r < 3; ++r) dg[r] = m[r] * trans[r];
      dsum = dg[0] + dg[1] + dg[2];
    }
    T v[1] = {dsum};
    block_sum<T, 1>(v, red);
    if (threadIdx.x == 0) a.deriv_t[cl0 + l] = v[0];
  }
}

template <typename T>
int launch(void *const *p, int ncol, int nlev, int ng, int nband,
           void *stream) {
  TcLwArgs<T> a;
  a.od = (const T *)p[0];
  a.odc_b = (const T *)p[1];
  a.ssac_b = (const T *)p[2];
  a.gc_b = (const T *)p[3];
  a.scal2 = (const T *)p[4];
  a.clear = (const unsigned char *)p[5];
  a.rf3 = (const T *)p[6];
  a.u9 = (const T *)p[7];
  a.v9 = (const T *)p[8];
  a.planck_hl = (const T *)p[9];
  a.emission = (const T *)p[10];
  a.albedo = (const T *)p[11];
  a.src0 = (const T *)p[12];
  a.band_of_g = (const int *)p[13];
  a.dn_bb_c = (T *)p[14];
  a.fdn_surf_c = (T *)p[15];
  a.fup_surf_c = (T *)p[16];
  a.up_bb_c = (T *)p[17];
  a.fup_toa_c = (T *)p[18];
  a.src_top_t = (T *)p[19];
  a.dn_bb_t = (T *)p[20];
  a.up_bb_t = (T *)p[21];
  a.fdn_surf_t = (T *)p[22];
  a.fup_surf_t = (T *)p[23];
  a.deriv_t = (T *)p[24];
  a.albb = (T *)p[25];
  a.srcb = (T *)p[26];
  a.nlev = nlev;
  a.ng = ng;
  a.nband = nband;
  // at least one warp: tc_stage loads with threads 0..14
  const int threads = ((ng + 31) / 32) * 32;
  tripleclouds_lw_kernel<T><<<ncol, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// p: the 27 tensor pointers in the order of TcLwArgs (deriv_t null when
// derivatives are off).
extern "C" int ecrad_tripleclouds_lw_f32(void *const *p, int ncol, int nlev,
                                         int ng, int nband, void *stream) {
  return launch<float>(p, ncol, nlev, ng, nband, stream);
}

extern "C" int ecrad_tripleclouds_lw_f64(void *const *p, int ncol, int nlev,
                                         int ng, int nband, void *stream) {
  return launch<double>(p, ncol, nlev, ng, nband, stream);
}
