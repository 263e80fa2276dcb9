// Fused McICA shortwave solver: cloud merge + delta-Eddington +
// Meador-Weaver + adding sweeps for the clear and total scenes in one
// kernel.
//
// Replaces the TPU kernels of ecrad_tpu/solvers/pallas_mcica.py:sw_fused
// (_sw_s1_kernel, _sw_s2_kernel, _sw_s3_kernel: three pallas_calls).
// Plain version and wrapper: ecrad_torch/solvers/cuda_mcica.py
// (sw_fused_plain, sw_fused).
//
// Per column and g-point, both scenes advance together:
//   S1 direct beam down, storing the direct flux at each layer top;
//   S2 surface -> TOA Moebius up (radiation_adding_ica_sw.F90:24-153),
//      storing the albedo and source below each layer;
//   S3 diffuse down, emitting per-level broadband sums.
// Each sweep recomputes the layer coefficients: the _merge_sw cloud
// merge for cloudy layers, the optional delta-Eddington scaling and
// sw_ref_trans (with expm1; the TPU's cubic series is not needed).  S1
// only needs the direct transmittance and computes nothing else.  mu0
// arrives clamped to 1e-10; night columns are zeroed by the caller.
//
// What bounds it on the H100: arithmetic (two Meador-Weaver evaluations
// per cloudy layer and sweep, with exp, expm1, sqrt and divisions) and
// the level recurrence.  One block per column with one thread per
// g-point keeps the six carries in registers and the loads of a level
// contiguous over g; the S1->S2->S3 links (direct flux at layer top,
// albedo and source below) go through scratch planes that the wrapper
// allocates.  Broadband sums are deterministic block reductions.  The
// grid is one block per column, so no column is ever skipped.
#include "common.cuh"

namespace {

using namespace ecrad;

template <typename T> struct SwArgs {
  const T *od, *ssa, *g, *od_scaling, *odc_b, *ssac_b, *gc_b;
  const unsigned char *mask;
  const T *mu0, *incoming, *alb_dif, *alb_dir_mu0;
  const int *band_of_g;
  T *dir_bb_c, *dir_bb_t, *fdir_surf_c, *fdir_surf_t, *src_top_c,
      *src_top_t, *dn_bb_c, *up_bb_c, *dn_bb_t, *up_bb_t, *fdn_surf_c,
      *fdn_surf_t;
  T *ftc, *ftt, *albb_c, *srcb_c, *albb_t, *srcb_t;  // scratch planes
  int nlev, ng, nband, delta_gases;
};

// Clear and total-sky optical properties of one (column, layer, g); the
// total scene equals the clear one outside cloudy layers.
template <typename T>
__device__ __forceinline__ bool sw_props(const SwArgs<T> &a, int col, int l,
                                         int g, int band, T &od, T &ssa,
                                         T &asy, T &od_t, T &ssa_t,
                                         T &g_t) {
  const size_t lg = ((size_t)col * a.nlev + l) * a.ng + g;
  od = a.od[lg];
  ssa = a.ssa[lg];
  asy = a.g[lg];
  const bool cloudy = a.mask[(size_t)col * a.nlev + l] != 0;
  if (cloudy) {
    const size_t lb = ((size_t)col * a.nlev + l) * a.nband + band;
    const T odc = a.od_scaling[lg] * a.odc_b[lb];
    merge_sw(od, ssa, asy, odc, a.ssac_b[lb], a.gc_b[lb], od_t, ssa_t, g_t);
    if (a.delta_gases) delta_eddington(od_t, ssa_t, g_t);
  }
  if (a.delta_gases) delta_eddington(od, ssa, asy);
  if (!cloudy) {
    od_t = od;
    ssa_t = ssa;
    g_t = asy;
  }
  return cloudy;
}

template <typename T> struct Coef {
  T refl, trans, rdir, tdif, tdd;
};

template <typename T>
__device__ __forceinline__ void sw_layer(const SwArgs<T> &a, int col, int l,
                                         int g, int band, T mu0, Coef<T> &c,
                                         Coef<T> &t) {
  T od, ssa, asy, od_t, ssa_t, g_t;
  const bool cloudy = sw_props(a, col, l, g, band, od, ssa, asy, od_t,
                               ssa_t, g_t);
  sw_ref_trans(mu0, od, ssa, asy, c.refl, c.trans, c.rdir, c.tdif, c.tdd);
  if (cloudy)
    sw_ref_trans(mu0, od_t, ssa_t, g_t, t.refl, t.trans, t.rdir, t.tdif,
                 t.tdd);
  else
    t = c;
}

template <typename T>
__global__ void sw_fused_kernel(SwArgs<T> a) {
  __shared__ T red[4 * 32];
  const int col = blockIdx.x;
  const int g = threadIdx.x;
  const bool on = g < a.ng;
  const int band = on ? a.band_of_g[g] : 0;
  const int nlev = a.nlev;
  const size_t cg = (size_t)col * a.ng + g;
  const size_t cl0 = (size_t)col * nlev;
  const T mu0 = a.mu0[col];

  // S1: direct beam down, both scenes
  const T incoming = on ? a.incoming[cg] : T(0);
  T fc = incoming, ft = incoming;
  for (int l = 0; l < nlev; ++l) {
    if (on) {
      T od, ssa, asy, od_t, ssa_t, g_t;
      sw_props(a, col, l, g, band, od, ssa, asy, od_t, ssa_t, g_t);
      const size_t lg = (cl0 + l) * a.ng + g;
      a.ftc[lg] = fc;
      a.ftt[lg] = ft;
      fc = sw_direct_trans(mu0, od) * fc;
      ft = sw_direct_trans(mu0, od_t) * ft;
    }
    T v[2] = {on ? fc : T(0), on ? ft : T(0)};
    block_sum<T, 2>(v, red);
    if (threadIdx.x == 0) {
      a.dir_bb_c[cl0 + l] = v[0];
      a.dir_bb_t[cl0 + l] = v[1];
    }
  }
  if (on) {
    a.fdir_surf_c[cg] = fc;
    a.fdir_surf_t[cg] = ft;
  }

  // S2: Moebius up, both scenes, surface -> TOA
  if (on) {
    const T alb0 = a.alb_dif[cg];
    const T adm = a.alb_dir_mu0[cg];
    T alb_c = alb0, alb_t = alb0;
    T src_c = adm * fc, src_t = adm * ft;
    for (int l = nlev - 1; l >= 0; --l) {
      Coef<T> c, t;
      sw_layer(a, col, l, g, band, mu0, c, t);
      const size_t lg = (cl0 + l) * a.ng + g;
      {
        const T ftop = a.ftc[lg];
        a.albb_c[lg] = alb_c;
        a.srcb_c[lg] = src_c;
        const T s_up = c.rdir * ftop;
        const T s_dn = c.tdif * ftop;
        const T inv = T(1) / (T(1) - alb_c * c.refl);
        const T alb_new = c.refl + c.trans * c.trans * alb_c * inv;
        src_c = s_up + c.trans * (src_c + alb_c * s_dn) * inv;
        alb_c = alb_new;
      }
      {
        const T ftop = a.ftt[lg];
        a.albb_t[lg] = alb_t;
        a.srcb_t[lg] = src_t;
        const T s_up = t.rdir * ftop;
        const T s_dn = t.tdif * ftop;
        const T inv = T(1) / (T(1) - alb_t * t.refl);
        const T alb_new = t.refl + t.trans * t.trans * alb_t * inv;
        src_t = s_up + t.trans * (src_t + alb_t * s_dn) * inv;
        alb_t = alb_new;
      }
    }
    a.src_top_c[cg] = src_c;
    a.src_top_t[cg] = src_t;
  }

  // S3: diffuse down, both scenes
  T dc = T(0), dt = T(0);
  for (int l = 0; l < nlev; ++l) {
    T uc = T(0), ut = T(0);
    if (on) {
      Coef<T> c, t;
      sw_layer(a, col, l, g, band, mu0, c, t);
      const size_t lg = (cl0 + l) * a.ng + g;
      {
        const T alb_below = a.albb_c[lg];
        const T src_below = a.srcb_c[lg];
        const T inv = T(1) / (T(1) - alb_below * c.refl);
        dc = (c.trans * dc + c.refl * src_below + c.tdif * a.ftc[lg]) * inv;
        uc = alb_below * dc + src_below;
      }
      {
        const T alb_below = a.albb_t[lg];
        const T src_below = a.srcb_t[lg];
        const T inv = T(1) / (T(1) - alb_below * t.refl);
        dt = (t.trans * dt + t.refl * src_below + t.tdif * a.ftt[lg]) * inv;
        ut = alb_below * dt + src_below;
      }
    }
    T v[4] = {on ? dc : T(0), uc, on ? dt : T(0), ut};
    block_sum<T, 4>(v, red);
    if (threadIdx.x == 0) {
      a.dn_bb_c[cl0 + l] = v[0];
      a.up_bb_c[cl0 + l] = v[1];
      a.dn_bb_t[cl0 + l] = v[2];
      a.up_bb_t[cl0 + l] = v[3];
    }
  }
  if (on) {
    a.fdn_surf_c[cg] = dc;
    a.fdn_surf_t[cg] = dt;
  }
}

template <typename T>
int launch(void *const *p, int ncol, int nlev, int ng, int nband,
           int delta_gases, void *stream) {
  SwArgs<T> a;
  a.od = (const T *)p[0];
  a.ssa = (const T *)p[1];
  a.g = (const T *)p[2];
  a.od_scaling = (const T *)p[3];
  a.odc_b = (const T *)p[4];
  a.ssac_b = (const T *)p[5];
  a.gc_b = (const T *)p[6];
  a.mask = (const unsigned char *)p[7];
  a.mu0 = (const T *)p[8];
  a.incoming = (const T *)p[9];
  a.alb_dif = (const T *)p[10];
  a.alb_dir_mu0 = (const T *)p[11];
  a.band_of_g = (const int *)p[12];
  a.dir_bb_c = (T *)p[13];
  a.dir_bb_t = (T *)p[14];
  a.fdir_surf_c = (T *)p[15];
  a.fdir_surf_t = (T *)p[16];
  a.src_top_c = (T *)p[17];
  a.src_top_t = (T *)p[18];
  a.dn_bb_c = (T *)p[19];
  a.up_bb_c = (T *)p[20];
  a.dn_bb_t = (T *)p[21];
  a.up_bb_t = (T *)p[22];
  a.fdn_surf_c = (T *)p[23];
  a.fdn_surf_t = (T *)p[24];
  a.ftc = (T *)p[25];
  a.ftt = (T *)p[26];
  a.albb_c = (T *)p[27];
  a.srcb_c = (T *)p[28];
  a.albb_t = (T *)p[29];
  a.srcb_t = (T *)p[30];
  a.nlev = nlev;
  a.ng = ng;
  a.nband = nband;
  a.delta_gases = delta_gases;
  const int threads = ((ng + 31) / 32) * 32;
  sw_fused_kernel<T><<<ncol, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// p: the 31 tensor pointers in the order of SwArgs.
extern "C" int ecrad_sw_fused_f32(void *const *p, int ncol, int nlev,
                                  int ng, int nband, int delta_gases,
                                  void *stream) {
  return launch<float>(p, ncol, nlev, ng, nband, delta_gases, stream);
}

extern "C" int ecrad_sw_fused_f64(void *const *p, int ncol, int nlev,
                                  int ng, int nband, int delta_gases,
                                  void *stream) {
  return launch<double>(p, ncol, nlev, ng, nband, delta_gases, stream);
}
