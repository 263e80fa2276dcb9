// Fused Tripleclouds shortwave solver: per-region merge + delta-Eddington
// + Meador-Weaver + overlap-coupled adding sweeps for the clear scene and
// the three-region scene in one kernel.
//
// Replaces the TPU kernels of ecrad_tpu/solvers/pallas_tripleclouds.py:
// sw_fused (_sw_dir_kernel, _sw_up_kernel, _sw_dn_kernel: three
// pallas_calls).  Plain version and wrapper: ecrad_torch/solvers/
// cuda_tripleclouds.py (sw_fused_plain, sw_fused).
//
// Per column and g-point, each layer has the clear-sky coefficients
// (region 0, no delta scaling) and two cloudy regions: gas merged with the
// cloud at the region's od scaling, optionally delta-Eddington scaled,
// then sw_ref_trans (expm1 form; the TPU's cubic series is not needed);
// in a clear layer the cloudy regions' coefficients are zero.  Sweeps:
//   S1 direct beam down for the clear scene (full incoming flux) and the
//      3 regions (region-weighted), storing the direct flux at each layer
//      top; the regions mix with v at the interface BELOW the layer;
//   S2 surface -> TOA: diffuse and direct albedos of the clear scene and
//      the 3 regions, storing both below each layer; the regions mix with
//      v at the interface ABOVE the layer;
//   S3 diffuse down, both scenes, mixing at the interface BELOW.
// A mix is skipped where the layer and its neighbour across the interface
// are both clear (layers above TOA and below the surface count as clear).
// mu0 arrives clamped to 1e-10; the surface planes (the regions' with the
// unclamped cos_sza and the lowest-layer mask) are prepared by the caller,
// which also zeroes night columns.  Per-level broadband sums are
// deterministic block reductions.
//
// What bounds it on the H100: arithmetic (three Meador-Weaver evaluations
// per cloudy layer, g-point and sweep in S2 and S3, each with exp, expm1,
// sqrt and divisions) and the level recurrence.  One block per column with
// one thread per g-point keeps the eight albedo carries in registers and
// the loads of a level contiguous over g; the per-column overlap data of a
// level is staged once in shared memory.  The S1 -> S2 -> S3 links (direct
// flux at layer top, albedos below, 12 planes of (ncol, nlev, ng)) go
// through scratch that the wrapper allocates.  One block per column covers
// any ncol.
#include "common.cuh"

namespace {

using namespace ecrad;

template <typename T> struct TcSwArgs {
  const T *od, *ssa, *g, *odc_b, *ssac_b, *gc_b, *scal2;
  const unsigned char *clear;
  const T *v9, *mu0, *incoming, *fdir0, *alb0_c, *albd0_c, *alb0_t,
      *albd0_t;
  const int *band_of_g;
  T *albd_top, *albd_top_c, *dir_bb_c, *dir_bb_t, *fdir_surf_c,
      *fdir_surf_t, *dn_bb_c, *up_bb_c, *dn_bb_t, *up_bb_t, *fdn_surf_c,
      *fdn_surf_t;
  // scratch: direct flux at each layer top (clear (ncol, nlev, ng), regions
  // (ncol, nlev, 3, ng)); diffuse and direct albedo below each layer
  T *ftc, *ftt, *albb_c, *albdb_c, *albb_t, *albdb_t;
  int nlev, ng, nband, delta_gases;
};

template <typename T> struct Coef {
  T refl, trans, rdir, tdd, tdir;  // tdd: direct->diffuse, tdir: direct
};

// Optical properties of the three regions at one (column, layer, g-point):
// region 0 the gas as given, regions 1 and 2 merged with the cloud
// (tripleclouds._merge_regions; the 1e-300 floors behind a test of the
// divisor, 0 in float) and optionally delta-Eddington scaled.  Returns
// false for a clear layer, where only region 0 is set.
template <typename T>
__device__ __forceinline__ bool sw_region_props(
    const TcSwArgs<T> &a, const TcLevel<T> &s, int col, int l, int g,
    int band, T (&od)[3], T (&ssa)[3], T (&asy)[3]) {
  const size_t lg = ((size_t)col * a.nlev + l) * a.ng + g;
  od[0] = a.od[lg];
  ssa[0] = a.ssa[lg];
  asy[0] = a.g[lg];
  if (s.clear) return false;
  const size_t lb = ((size_t)col * a.nlev + l) * a.nband + band;
  const T odcb = a.odc_b[lb], ssacb = a.ssac_b[lb], gcb = a.gc_b[lb];
  const T scat_clear = ssa[0] * od[0];
#pragma unroll
  for (int r = 1; r < 3; ++r) {
    const T odc = s.scal[r - 1] * odcb;
    const T scat_cloud = ssacb * odc;
    const T od_t = od[0] + odc;
    const T scat = scat_clear + scat_cloud;
    od[r] = od_t;
    ssa[r] = od_t > T(0) ? scat / d_max(od_t, Limits<T>::tiny()) : T(0);
    asy[r] = scat > T(0) ? (asy[0] * scat_clear + gcb * scat_cloud) /
                               d_max(scat, Limits<T>::tiny())
                         : T(0);
    if (a.delta_gases) delta_eddington(od[r], ssa[r], asy[r]);
  }
  return true;
}

template <typename T>
__device__ __forceinline__ void sw_regions(const TcSwArgs<T> &a,
                                           const TcLevel<T> &s, int col,
                                           int l, int g, int band, T mu0,
                                           Coef<T> (&c)[3]) {
  T od[3], ssa[3], asy[3];
  const bool cloudy = sw_region_props(a, s, col, l, g, band, od, ssa, asy);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    if (r == 0 || cloudy) {
      sw_ref_trans(mu0, od[r], ssa[r], asy[r], c[r].refl, c[r].trans,
                   c[r].rdir, c[r].tdd, c[r].tdir);
    } else {
      c[r].refl = c[r].trans = c[r].rdir = c[r].tdd = c[r].tdir = T(0);
    }
  }
}

// One layer of the up sweep: the albedos of the atmosphere from this
// layer's top down, from those below it.
template <typename T>
__device__ __forceinline__ void albedo_up(const Coef<T> &c, T alb, T albd,
                                          T &alb_new, T &albd_new) {
  const T inv = T(1) / (T(1) - alb * c.refl);
  alb_new = c.refl + c.trans * c.trans * alb * inv;
  albd_new = c.rdir + (c.tdir * albd + c.tdd * alb) * c.trans * inv;
}

// One layer of the diffuse down sweep: the diffuse flux at the layer base
// and the up flux there.
template <typename T>
__device__ __forceinline__ void diffuse_down(const Coef<T> &c, T fdir_top,
                                             T fdn, T alb, T albd,
                                             T &fdn_new, T &fup) {
  fdn_new = (c.trans * fdn + fdir_top * (c.tdir * albd * c.refl + c.tdd)) /
            (T(1) - c.refl * alb);
  fup = c.tdir * fdir_top * albd + fdn_new * alb;
}

template <typename T>
__global__ void tripleclouds_sw_kernel(TcSwArgs<T> a) {
  __shared__ T red[4 * 32];
  __shared__ TcLevel<T> s;
  const int col = blockIdx.x;
  const int g = threadIdx.x;
  const bool on = g < a.ng;
  const int band = on ? a.band_of_g[g] : 0;
  const int nlev = a.nlev, ng = a.ng;
  const size_t cg = (size_t)col * ng + g;
  const size_t cl0 = (size_t)col * nlev;
  const T mu0 = a.mu0[col];
  auto lg = [&](int l) { return (cl0 + l) * (size_t)ng + g; };
  auto lgr = [&](int l, int r) {
    return ((cl0 + l) * 3 + r) * (size_t)ng + g;
  };
  auto cgr = [&](int r) { return ((size_t)col * 3 + r) * ng + g; };

  // S1: direct beam down, clear scene and 3 regions
  T fc = on ? a.incoming[cg] : T(0);
  T ft[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) ft[r] = on ? a.fdir0[cgr(r)] : T(0);
  T dir_g = T(0);
  for (int l = 0; l < nlev; ++l) {
    tc_stage<T>(s, nullptr, a.v9, nullptr, a.scal2, a.clear, col, nlev, l,
                l + 1, l + 1);
    if (on) {
      T od[3], ssa[3], asy[3];
      const bool cloudy =
          sw_region_props(a, s, col, l, g, band, od, ssa, asy);
      a.ftc[lg(l)] = fc;
#pragma unroll
      for (int r = 0; r < 3; ++r) a.ftt[lgr(l, r)] = ft[r];
      fc = sw_direct_trans(mu0, od[0]) * fc;
      T f[3] = {sw_direct_trans(mu0, od[0]) * ft[0], T(0), T(0)};
      if (cloudy) {
        f[1] = sw_direct_trans(mu0, od[1]) * ft[1];
        f[2] = sw_direct_trans(mu0, od[2]) * ft[2];
      }
      dir_g = f[0] + f[1] + f[2];
      if (s.skip) {
#pragma unroll
        for (int r = 0; r < 3; ++r) ft[r] = f[r];
      } else {
        mix_rows(s.v, f, ft);
      }
    }
    T v[2] = {on ? fc : T(0), dir_g};
    block_sum<T, 2>(v, red);
    if (threadIdx.x == 0) {
      a.dir_bb_c[cl0 + l] = v[0];
      a.dir_bb_t[cl0 + l] = v[1];
    }
  }
  if (on) {
    a.fdir_surf_c[cg] = fc;
    a.fdir_surf_t[cg] = dir_g;
  }

  // S2: diffuse and direct albedos up, both scenes, surface -> TOA
  T ac = on ? a.alb0_c[cg] : T(0), adc = on ? a.albd0_c[cg] : T(0);
  T at[3], adt[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    at[r] = on ? a.alb0_t[cgr(r)] : T(0);
    adt[r] = on ? a.albd0_t[cgr(r)] : T(0);
  }
  for (int l = nlev - 1; l >= 0; --l) {
    tc_stage<T>(s, nullptr, a.v9, nullptr, a.scal2, a.clear, col, nlev, l, l,
                l - 1);
    if (on) {
      Coef<T> c[3];
      sw_regions(a, s, col, l, g, band, mu0, c);
      a.albb_c[lg(l)] = ac;
      a.albdb_c[lg(l)] = adc;
      albedo_up(c[0], ac, adc, ac, adc);
      T an[3], adn[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        a.albb_t[lgr(l, r)] = at[r];
        a.albdb_t[lgr(l, r)] = adt[r];
        albedo_up(c[r], at[r], adt[r], an[r], adn[r]);
      }
      if (s.clear) an[1] = an[2] = adn[1] = adn[2] = T(0);
      if (s.skip) {
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          at[r] = an[r];
          adt[r] = adn[r];
        }
      } else {
        mix_cols(s.v, an, at);
        mix_cols(s.v, adn, adt);
      }
    }
    __syncthreads();  // every thread has read `s` before the next stage
  }
  if (on) {
    a.albd_top_c[cg] = adc;
#pragma unroll
    for (int r = 0; r < 3; ++r) a.albd_top[cgr(r)] = adt[r];
  }

  // S3: diffuse down, both scenes
  T dc = T(0), dt[3] = {T(0), T(0), T(0)};
  T dn_t = T(0);
  for (int l = 0; l < nlev; ++l) {
    tc_stage<T>(s, nullptr, a.v9, nullptr, a.scal2, a.clear, col, nlev, l,
                l + 1, l + 1);
    T uc = T(0), up_t = T(0);
    if (on) {
      Coef<T> c[3];
      sw_regions(a, s, col, l, g, band, mu0, c);
      diffuse_down(c[0], a.ftc[lg(l)], dc, a.albb_c[lg(l)],
                   a.albdb_c[lg(l)], dc, uc);
      T f[3], u[3];
#pragma unroll
      for (int r = 0; r < 3; ++r)
        diffuse_down(c[r], a.ftt[lgr(l, r)], dt[r], a.albb_t[lgr(l, r)],
                     a.albdb_t[lgr(l, r)], f[r], u[r]);
      if (s.clear) f[1] = f[2] = u[1] = u[2] = T(0);
      dn_t = f[0] + f[1] + f[2];
      up_t = u[0] + u[1] + u[2];
      if (s.skip) {
#pragma unroll
        for (int r = 0; r < 3; ++r) dt[r] = f[r];
      } else {
        mix_rows(s.v, f, dt);
      }
    }
    T v[4] = {on ? dc : T(0), uc, dn_t, up_t};
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
    a.fdn_surf_t[cg] = dn_t;
  }
}

template <typename T>
int launch(void *const *p, int ncol, int nlev, int ng, int nband,
           int delta_gases, void *stream) {
  TcSwArgs<T> a;
  a.od = (const T *)p[0];
  a.ssa = (const T *)p[1];
  a.g = (const T *)p[2];
  a.odc_b = (const T *)p[3];
  a.ssac_b = (const T *)p[4];
  a.gc_b = (const T *)p[5];
  a.scal2 = (const T *)p[6];
  a.clear = (const unsigned char *)p[7];
  a.v9 = (const T *)p[8];
  a.mu0 = (const T *)p[9];
  a.incoming = (const T *)p[10];
  a.fdir0 = (const T *)p[11];
  a.alb0_c = (const T *)p[12];
  a.albd0_c = (const T *)p[13];
  a.alb0_t = (const T *)p[14];
  a.albd0_t = (const T *)p[15];
  a.band_of_g = (const int *)p[16];
  a.albd_top = (T *)p[17];
  a.albd_top_c = (T *)p[18];
  a.dir_bb_c = (T *)p[19];
  a.dir_bb_t = (T *)p[20];
  a.fdir_surf_c = (T *)p[21];
  a.fdir_surf_t = (T *)p[22];
  a.dn_bb_c = (T *)p[23];
  a.up_bb_c = (T *)p[24];
  a.dn_bb_t = (T *)p[25];
  a.up_bb_t = (T *)p[26];
  a.fdn_surf_c = (T *)p[27];
  a.fdn_surf_t = (T *)p[28];
  a.ftc = (T *)p[29];
  a.ftt = (T *)p[30];
  a.albb_c = (T *)p[31];
  a.albdb_c = (T *)p[32];
  a.albb_t = (T *)p[33];
  a.albdb_t = (T *)p[34];
  a.nlev = nlev;
  a.ng = ng;
  a.nband = nband;
  a.delta_gases = delta_gases;
  // at least one warp: tc_stage loads with threads 0..14
  const int threads = ((ng + 31) / 32) * 32;
  tripleclouds_sw_kernel<T><<<ncol, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// p: the 35 tensor pointers in the order of TcSwArgs.
extern "C" int ecrad_tripleclouds_sw_f32(void *const *p, int ncol, int nlev,
                                         int ng, int nband, int delta_gases,
                                         void *stream) {
  return launch<float>(p, ncol, nlev, ng, nband, delta_gases, stream);
}

extern "C" int ecrad_tripleclouds_sw_f64(void *const *p, int ncol, int nlev,
                                         int ng, int nband, int delta_gases,
                                         void *stream) {
  return launch<double>(p, ncol, nlev, ng, nband, delta_gases, stream);
}
