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
// in a clear layer the cloudy regions' coefficients are zero.  Two passes:
//   up   surface -> TOA: the coefficients of each layer, stored, and the
//        diffuse and direct albedos of the clear scene and the 3 regions,
//        stored below each layer; the regions mix with v at the interface
//        ABOVE;
//   down TOA -> surface: from the stored coefficients, the direct beam
//        (transmitted by trans_dir_dir, which is sw_direct_trans bit for
//        bit) and the diffuse flux of both scenes together, mixing at the
//        interface BELOW; the per-level broadband sums of both.
// The TPU's separate direct-beam pass is not needed: nothing of the up
// pass depends on it.  A mix is skipped where the layer and its neighbour
// across the interface are both clear (layers above TOA and below the
// surface count as clear).  mu0 arrives clamped to 1e-10; the surface
// planes (the regions' with the unclamped cos_sza and the lowest-layer
// mask) are prepared by the caller, which also zeroes night columns.
//
// What bounds it on the H100: the latency of the level recurrence and the
// arithmetic (one Meador-Weaver evaluation per region, with exp, expm1,
// sqrt and divisions); the bytes are a few planes.  One
// block per column with one thread per g-point keeps the carries in
// registers and each load contiguous over g.  A column's overlap matrices,
// od scalings and clear flags are staged in shared memory once, so the
// level loops hold no barrier: each warp leaves its shuffle-tree partial
// of the six per-level sums in shared memory, and the partials are added
// in warp order after the down pass (deterministic, the order of a block
// reduction).  The loads every level makes are issued one level ahead;
// the cloudy regions' scratch of a cloudy next level is prefetched into
// L2.  The albedos and the coefficients (refl, trans, tdd, tdir) go from
// the up to the down pass through scratch that the wrapper allocates, only
// the clear scene's and region 0's in a clear layer, whose cloudy regions
// the down pass zeroes.  Reading the coefficients back measured faster
// than computing them again, on the meridian-based inputs and with every
// layer cloudy (PERF.md).  One block per column covers any ncol.
//
// Spectral flux output: the build with kPlanes also stores each thread's
// fluxes at every half-level of the down pass, where it already holds them
// (the regions summed) before the warp partials, into six planes (ncol,
// nlev+1, ng): per scene the up flux, the diffuse down flux and the direct
// flux (normal to the beam, as dir_bb), rows 0 and nlev the TOA and
// surface values.  Stores are contiguous over g, with no atomics and no
// barrier; the caller projects the planes onto bands and applies mu0.  The
// build without kPlanes is the kernel above, unchanged.
#include "common.cuh"

namespace {

using namespace ecrad;

constexpr int kSums = 6;  // dir_c, dir_t, dn_c, up_c, dn_t, up_t

template <typename T> struct TcSwArgs {
  const T *od, *ssa, *g, *odc_b, *ssac_b, *gc_b, *scal2;
  const unsigned char *clear;
  const T *v9, *mu0, *incoming, *fdir0, *alb0_c, *albd0_c, *alb0_t,
      *albd0_t;
  const int *band_of_g;
  T *albd_top, *albd_top_c, *dir_bb_c, *dir_bb_t, *fdir_surf_c,
      *fdir_surf_t, *dn_bb_c, *up_bb_c, *dn_bb_t, *up_bb_t, *fdn_surf_c,
      *fdn_surf_t;
  // scratch: diffuse and direct albedo below each layer (clear (ncol,
  // nlev, ng), regions (ncol, nlev, 3, ng)); the layer coefficients
  // (ncol, nlev, 3, 4, ng)
  T *albb_c, *albdb_c, *albb_t, *albdb_t, *coef;
  // per-g planes (ncol, nlev+1, ng), written by the kPlanes build only
  T *up_g_c, *dn_g_c, *dir_g_c, *up_g_t, *dn_g_t, *dir_g_t;
  int nlev, ng, nband, delta_gases;
};

// The gas optics of one (column, layer, g-point).
template <typename T> struct Gas {
  T od, ssa, g;
};

template <typename T>
__device__ __forceinline__ Gas<T> load_gas(const TcSwArgs<T> &a, size_t i) {
  return {a.od[i], a.ssa[i], a.g[i]};
}

// The coefficients of the three regions at one (column, layer, g-point):
// region 0 the gas as given, regions 1 and 2 merged with the cloud
// (tripleclouds._merge_regions; the 1e-300 floors behind a test of the
// divisor, 0 in float) and optionally delta-Eddington scaled; in a clear
// layer the cloudy regions' coefficients are zero.
template <typename T>
__device__ __forceinline__ void sw_regions(const TcSwArgs<T> &a,
                                           const Gas<T> &gas, bool cloudy,
                                           const T *scal, size_t lb, T mu0,
                                           SwCoef<T> (&c)[3]) {
  sw_ref_trans(mu0, gas.od, gas.ssa, gas.g, c[0].refl, c[0].trans,
               c[0].rdir, c[0].tdd, c[0].tdir);
  if (!cloudy) {
#pragma unroll
    for (int r = 1; r < 3; ++r)
      c[r].refl = c[r].trans = c[r].rdir = c[r].tdd = c[r].tdir = T(0);
    return;
  }
  const T odcb = a.odc_b[lb], ssacb = a.ssac_b[lb], gcb = a.gc_b[lb];
  const T scat_clear = gas.ssa * gas.od;
#pragma unroll
  for (int r = 1; r < 3; ++r) {
    const T odc = scal[r - 1] * odcb;
    const T scat_cloud = ssacb * odc;
    T od = gas.od + odc;
    const T scat = scat_clear + scat_cloud;
    T ssa = od > T(0) ? scat / d_max(od, Limits<T>::tiny()) : T(0);
    T asy = scat > T(0) ? (gas.g * scat_clear + gcb * scat_cloud) /
                              d_max(scat, Limits<T>::tiny())
                        : T(0);
    if (a.delta_gases) delta_eddington(od, ssa, asy);
    sw_ref_trans(mu0, od, ssa, asy, c[r].refl, c[r].trans, c[r].rdir,
                 c[r].tdd, c[r].tdir);
  }
}

// What the down pass reads at every level: region 0's coefficients and
// the clear scene's and region 0's albedos.
template <typename T> struct DnNext {
  T c0[4];
  T ac, adc, at0, adt0;
};

template <typename T>
__device__ __forceinline__ DnNext<T> load_dn(const TcSwArgs<T> &a,
                                             size_t i, size_t ir,
                                             size_t ic, size_t ng) {
  DnNext<T> n;
#pragma unroll
  for (int k = 0; k < 4; ++k) n.c0[k] = a.coef[ic + k * ng];
  n.ac = a.albb_c[i];
  n.adc = a.albdb_c[i];
  n.at0 = a.albb_t[ir];
  n.adt0 = a.albdb_t[ir];
  return n;
}

template <typename T, bool kPlanes>
__global__ void tripleclouds_sw_kernel(TcSwArgs<T> a) {
  extern __shared__ unsigned char smem_raw[];
  const int col = blockIdx.x;
  const int g = threadIdx.x;
  const bool on = g < a.ng;
  const int band = on ? a.band_of_g[g] : 0;
  const int nlev = a.nlev, ng = a.ng, nband = a.nband;
  const int nwarp = blockDim.x >> 5;
  // shared: the six per-level sums' warp partials, then the column's v
  // matrices, od scalings and clear flags
  T *part = reinterpret_cast<T *>(smem_raw);
  T *sv = part + (size_t)nlev * kSums * nwarp;
  T *ssc = sv + (nlev + 1) * 9;
  unsigned char *sclr = reinterpret_cast<unsigned char *>(ssc + nlev * 2);
  tc_stage_column(sv, ssc, sclr, a.v9, a.scal2, a.clear, col, nlev);

  const size_t cg = (size_t)col * ng + g;
  const size_t cl0 = (size_t)col * nlev;
  const T mu0 = a.mu0[col];
  auto lg = [&](int l) { return (cl0 + l) * (size_t)ng + g; };
  auto lgr = [&](int l, int r) {
    return ((cl0 + l) * 3 + r) * (size_t)ng + g;
  };
  auto lgc = [&](int l, int r, int k) {
    return (((cl0 + l) * 3 + r) * 4 + k) * (size_t)ng + g;
  };
  auto cgr = [&](int r) { return ((size_t)col * 3 + r) * ng + g; };
  auto lb = [&](int l) { return (cl0 + l) * (size_t)nband + band; };
  auto hl = [&](int l) { return ((size_t)col * (nlev + 1) + l) * ng + g; };

  // --- up pass: albedos of both scenes, surface -> TOA
  T ac = T(0), adc = T(0), at[3] = {T(0), T(0), T(0)},
    adt[3] = {T(0), T(0), T(0)};
  if (on) {
    ac = a.alb0_c[cg];
    adc = a.albd0_c[cg];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      at[r] = a.alb0_t[cgr(r)];
      adt[r] = a.albd0_t[cgr(r)];
    }
    Gas<T> nxt = load_gas(a, lg(nlev - 1));
    for (int l = nlev - 1; l >= 0; --l) {
      const Gas<T> gas = nxt;
      if (l > 0) nxt = load_gas(a, lg(l - 1));
      const bool cloudy = !sclr[l];
      const bool skip = !cloudy && (l == 0 || sclr[l - 1]);
      SwCoef<T> c[3];
      sw_regions(a, gas, cloudy, ssc + 2 * l, lb(l), mu0, c);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        if (r > 0 && !cloudy) break;
        a.coef[lgc(l, r, 0)] = c[r].refl;
        a.coef[lgc(l, r, 1)] = c[r].trans;
        a.coef[lgc(l, r, 2)] = c[r].tdd;
        a.coef[lgc(l, r, 3)] = c[r].tdir;
      }
      a.albb_c[lg(l)] = ac;
      a.albdb_c[lg(l)] = adc;
      albedo_up(c[0], ac, adc, ac, adc);
      T an[3] = {T(0), T(0), T(0)}, adn[3] = {T(0), T(0), T(0)};
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        if (r > 0 && !cloudy) break;
        a.albb_t[lgr(l, r)] = at[r];
        a.albdb_t[lgr(l, r)] = adt[r];
        albedo_up(c[r], at[r], adt[r], an[r], adn[r]);
      }
      if (skip) {
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          at[r] = an[r];
          adt[r] = adn[r];
        }
      } else {
        mix_cols(sv + 9 * l, an, at);
        mix_cols(sv + 9 * l, adn, adt);
      }
    }
    a.albd_top_c[cg] = adc;
#pragma unroll
    for (int r = 0; r < 3; ++r) a.albd_top[cgr(r)] = adt[r];
    if (kPlanes) {
      const T incoming = a.incoming[cg];
      T up_t = T(0), dir_t = T(0);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const T f0 = a.fdir0[cgr(r)];
        up_t += f0 * adt[r];
        dir_t += f0;
      }
      a.up_g_c[hl(0)] = incoming * adc;
      a.up_g_t[hl(0)] = up_t;
      a.dn_g_c[hl(0)] = a.dn_g_t[hl(0)] = T(0);
      a.dir_g_c[hl(0)] = incoming;
      a.dir_g_t[hl(0)] = dir_t;
    }
  }

  // --- down pass: direct beam and diffuse flux of both scenes
  T fc = T(0), ft[3] = {T(0), T(0), T(0)};
  T dc = T(0), dt[3] = {T(0), T(0), T(0)};
  T dir_t = T(0), dn_t = T(0);
  DnNext<T> nxt;
  if (on) {
    fc = a.incoming[cg];
#pragma unroll
    for (int r = 0; r < 3; ++r) ft[r] = a.fdir0[cgr(r)];
    nxt = load_dn(a, lg(0), lgr(0, 0), lgc(0, 0, 0), ng);
  }
  for (int l = 0; l < nlev; ++l) {
    T uc = T(0), up_t = T(0);
    if (on) {
      const DnNext<T> s = nxt;
      const bool cloudy = !sclr[l];
      const bool skip = !cloudy && (l + 1 >= nlev || sclr[l + 1]);
      if (l + 1 < nlev) {
        nxt = load_dn(a, lg(l + 1), lgr(l + 1, 0), lgc(l + 1, 0, 0), ng);
        if (!sclr[l + 1]) {     // the next level is cloudy
#pragma unroll
          for (int r = 1; r < 3; ++r) {
            prefetch_l2(a.albb_t + lgr(l + 1, r));
            prefetch_l2(a.albdb_t + lgr(l + 1, r));
#pragma unroll
            for (int k = 0; k < 4; ++k)
              prefetch_l2(a.coef + lgc(l + 1, r, k));
          }
        }
      }
      // the coefficients the up pass stored (rdir is not needed here)
      SwCoef<T> c[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        c[r].refl = r == 0 ? s.c0[0] : cloudy ? a.coef[lgc(l, r, 0)] : T(0);
        c[r].trans = r == 0 ? s.c0[1] : cloudy ? a.coef[lgc(l, r, 1)] : T(0);
        c[r].tdd = r == 0 ? s.c0[2] : cloudy ? a.coef[lgc(l, r, 2)] : T(0);
        c[r].tdir = r == 0 ? s.c0[3] : cloudy ? a.coef[lgc(l, r, 3)] : T(0);
      }
      // the direct beam at the layer top, and through the layer
      const T fc_top = fc;
      const T ft_top[3] = {ft[0], ft[1], ft[2]};
      fc = c[0].tdir * fc_top;
      T f[3] = {c[0].tdir * ft_top[0], T(0), T(0)};
      if (cloudy) {
        f[1] = c[1].tdir * ft_top[1];
        f[2] = c[2].tdir * ft_top[2];
      }
      dir_t = f[0] + f[1] + f[2];
      // the diffuse flux, from the albedos below the layer
      diffuse_down(c[0], fc_top, dc, s.ac, s.adc, dc, uc);
      T fr[3] = {T(0), T(0), T(0)}, ur[3] = {T(0), T(0), T(0)};
      diffuse_down(c[0], ft_top[0], dt[0], s.at0, s.adt0, fr[0], ur[0]);
      if (cloudy) {
#pragma unroll
        for (int r = 1; r < 3; ++r)
          diffuse_down(c[r], ft_top[r], dt[r], a.albb_t[lgr(l, r)],
                       a.albdb_t[lgr(l, r)], fr[r], ur[r]);
      }
      dn_t = fr[0] + fr[1] + fr[2];
      up_t = ur[0] + ur[1] + ur[2];
      if (kPlanes) {
        const size_t h = hl(l + 1);
        a.dir_g_c[h] = fc;
        a.dir_g_t[h] = dir_t;
        a.dn_g_c[h] = dc;
        a.up_g_c[h] = uc;
        a.dn_g_t[h] = dn_t;
        a.up_g_t[h] = up_t;
      }
      if (skip) {
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          ft[r] = f[r];
          dt[r] = fr[r];
        }
      } else {
        mix_rows(sv + 9 * (l + 1), f, ft);
        mix_rows(sv + 9 * (l + 1), fr, dt);
      }
    }
    const T v[kSums] = {on ? fc : T(0), dir_t, on ? dc : T(0), uc, dn_t,
                        up_t};
#pragma unroll
    for (int i = 0; i < kSums; ++i)
      warp_partial(v[i], part, l * kSums + i, nwarp);
  }
  if (on) {
    a.fdir_surf_c[cg] = fc;
    a.fdir_surf_t[cg] = dir_t;
    a.fdn_surf_c[cg] = dc;
    a.fdn_surf_t[cg] = dn_t;
  }
  T *const outs[kSums] = {a.dir_bb_c + cl0, a.dir_bb_t + cl0,
                          a.dn_bb_c + cl0,  a.up_bb_c + cl0,
                          a.dn_bb_t + cl0,  a.up_bb_t + cl0};
  store_level_sums(part, outs, nlev, nwarp);
}

// Launch the build with or without planes.
template <typename T, bool kPlanes>
int launch_as(const TcSwArgs<T> &a, int ncol, int threads, size_t smem,
              void *stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tripleclouds_sw_kernel<T, kPlanes>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  tripleclouds_sw_kernel<T, kPlanes>
      <<<ncol, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(void *const *p, int ncol, int nlev, int ng, int nband,
           int delta_gases, int planes, void *stream) {
  TcSwArgs<T> a;
  const T **in[] = {&a.od, &a.ssa, &a.g, &a.odc_b, &a.ssac_b, &a.gc_b,
                    &a.scal2};
  const T **in2[] = {&a.v9, &a.mu0, &a.incoming, &a.fdir0, &a.alb0_c,
                     &a.albd0_c, &a.alb0_t, &a.albd0_t};
  T **out[] = {&a.albd_top, &a.albd_top_c, &a.dir_bb_c, &a.dir_bb_t,
               &a.fdir_surf_c, &a.fdir_surf_t, &a.dn_bb_c, &a.up_bb_c,
               &a.dn_bb_t, &a.up_bb_t, &a.fdn_surf_c, &a.fdn_surf_t,
               &a.albb_c, &a.albdb_c, &a.albb_t, &a.albdb_t, &a.coef,
               &a.up_g_c, &a.dn_g_c, &a.dir_g_c, &a.up_g_t, &a.dn_g_t,
               &a.dir_g_t};
  int k = 0;
  for (const T **q : in) *q = (const T *)p[k++];
  a.clear = (const unsigned char *)p[k++];
  for (const T **q : in2) *q = (const T *)p[k++];
  a.band_of_g = (const int *)p[k++];
  for (T **q : out) *q = (T *)p[k++];
  a.nlev = nlev;
  a.ng = ng;
  a.nband = nband;
  a.delta_gases = delta_gases;
  const int threads = ((ng + 31) / 32) * 32;
  const size_t smem =
      sizeof(T) * ((size_t)nlev * kSums * (threads / 32) +
                   (size_t)(nlev + 1) * 9 + (size_t)nlev * 2) +
      nlev;
  return planes ? launch_as<T, true>(a, ncol, threads, smem, stream)
                : launch_as<T, false>(a, ncol, threads, smem, stream);
}

}  // namespace

// p: the 40 tensor pointers in the order of TcSwArgs (the six planes null
// unless planes).
extern "C" int ecrad_tripleclouds_sw_f32(void *const *p, int ncol, int nlev,
                                         int ng, int nband, int delta_gases,
                                         int planes, void *stream) {
  return launch<float>(p, ncol, nlev, ng, nband, delta_gases, planes,
                       stream);
}

extern "C" int ecrad_tripleclouds_sw_f64(void *const *p, int ncol, int nlev,
                                         int ng, int nband, int delta_gases,
                                         int planes, void *stream) {
  return launch<double>(p, ncol, nlev, ng, nband, delta_gases, planes,
                        stream);
}
