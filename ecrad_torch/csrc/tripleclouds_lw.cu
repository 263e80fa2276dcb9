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
// Passes, in order:
//   clear down: fdn_surf_c, and fup_surf_c = emission + albedo * fdn;
//   up (surface -> TOA): the clear up flux, the 3-region Moebius sweep of
//      albedo and source, storing both below each layer (the carries mix
//      at the interface ABOVE the layer: albedo with v, source with u), and
//      the derivative weights below;
//   down: the 3 regions, mixing with v at the interface BELOW the layer;
//   derivatives: a sum over g at each level, with no level chain.
// The region-coupled derivative of the TPU kernels, dg = (u dg) * trans
// from the surface up with u at the interface BELOW the layer, is linear
// in its start [d0, 0, 0], d0 = fup_surf / max(sum_g fup_surf, 1e-30): so
// deriv_t[l] = sum_g d0_g W[l, g], where W = sum_r w[r] and w is the same
// recurrence from [1, 0, 0].  W needs nothing of the down pass, so the up
// pass carries w and stores W; once the down pass has given d0, each level
// is one sum over g.  That is the function of the TPU's derivative pass in
// another rounding order.  A mix is skipped where the layer and its
// neighbour across the interface are both clear (layers above TOA and
// below the surface count as clear).
//
// What bounds it on the H100: the latency of the level recurrences, not
// the bytes (~13 plane passes, a third of the memory rate at the
// measured time) or the arithmetic.  Tensor cores do not
// apply: each g-point's work is a scalar recurrence with 3x3 mixes in
// registers, and no product has the shape of an MMA.  One block per
// column with one thread per g-point keeps the carries in registers and
// each load contiguous over g, and covers any ncol.  The column's overlap
// matrices, region fractions, od scalings and clear flags are staged in
// shared memory once, so the level loops hold no barrier: each warp leaves
// its shuffle-tree partial of the per-level sums in shared memory, and the
// partials are added in warp order after each pass (deterministic, the
// order of a block reduction).  The loads every level makes are issued one
// level ahead; a cloudy next level's other loads are prefetched into L2.
// The albedos and sources go from the up to the down pass through scratch
// the wrapper allocates, regions 1 and 2 only in cloudy layers, where the
// down pass reads them.  The down pass evaluates the cloudy regions'
// lw_ref_trans again (twice per cloudy layer in all): storing the
// coefficients in the up pass and reading them back measured as fast on
// the meridian-based inputs and slower with
// every layer cloudy (PERF.md); region 0's no-scattering transmittance
// (one exp) is evaluated by each level chain.  The f32 build is held to 64
// registers without spilling (6 blocks of 160 threads per SM); 48 (8
// blocks) spills and no cap runs 4 blocks, both measured slower on the
// meridian-based inputs (PERF.md).
//
// Spectral flux output: the build with kPlanes also stores each thread's
// fluxes at every half-level, where it already holds them (the regions
// summed) before the warp partial, into four planes (ncol, nlev+1, ng):
// the clear and 3-region up and down fluxes, rows 0 and nlev the TOA and
// surface values.  Stores are contiguous over g, with no atomics and no
// barrier; the caller projects the planes onto bands.  The build without
// kPlanes is the kernel above, unchanged.
#include "common.cuh"

namespace {

using namespace ecrad;

// Blocks of up to 256 threads (g-points); the f32 build's register cap (the
// f64 build is not capped).
constexpr int kMaxThreads = 256;
constexpr int kF32Regs = 64;

template <typename T> struct TcLwArgs {
  const T *od, *odc_b, *ssac_b, *gc_b, *scal2;
  const unsigned char *clear;
  const T *rf3, *u9, *v9, *planck_hl, *emission, *albedo, *src0;
  const int *band_of_g;
  T *dn_bb_c, *fdn_surf_c, *fup_surf_c, *up_bb_c, *fup_toa_c, *src_top_t;
  T *dn_bb_t, *up_bb_t, *fdn_surf_t, *fup_surf_t;
  T *deriv_t;  // null when derivatives are off
  // scratch: the albedo and source below each layer (ncol, nlev, 3, ng),
  // regions 1 and 2 only in cloudy layers; the derivative weights W (ncol,
  // nlev, ng), null when derivatives are off
  T *albb, *srcb, *wsum;
  // per-g planes (ncol, nlev+1, ng), written by the kPlanes build only
  T *up_g_c, *dn_g_c, *up_g_t, *dn_g_t;
  int nlev, ng, nband;
};

// Regions 1 and 2 of a cloudy layer: the gas (absorption only) merged with
// the cloud at the region's od scaling (tripleclouds._merge_regions with
// ssa = g = 0 for the gas; the 1e-300 floors behind a test of the divisor,
// 0 in float), then lw_ref_trans, the sources scaled by the region
// fraction.
template <typename T>
__device__ __forceinline__ void cloudy_regions(
    T od, T odcb, T ssacb, T gcb, const T *scal, const T *rf, T ptop,
    T pbot, T (&refl)[3], T (&trans)[3], T (&su)[3], T (&sd)[3]) {
#pragma unroll
  for (int r = 1; r < 3; ++r) {
    const T odc = scal[r - 1] * odcb;
    const T od_t = od + odc;
    const T scat = ssacb * odc;
    const T ssa_t =
        od_t > T(0) ? scat / d_max(od_t, Limits<T>::tiny()) : T(0);
    const T g_t =
        scat > T(0) ? (gcb * scat) / d_max(scat, Limits<T>::tiny()) : T(0);
    lw_ref_trans(od_t, ssa_t, g_t, ptop, pbot, refl[r], trans[r], su[r],
                 sd[r]);
    su[r] *= rf[r];
    sd[r] *= rf[r];
  }
}

// What the up pass loads at a level: od, the Planck function at the layer
// top (the base's comes from the level below) and, in a cloudy layer, the
// cloud's band properties.
template <typename T> struct UpLevel {
  T od, ptop, odcb, ssacb, gcb;
};

// What the down pass loads ahead at every level: od, the Planck function
// at the layer base, region 0's albedo and source below the layer.  A
// cloudy layer's other loads are only prefetched into L2 a level ahead.
template <typename T> struct DnLevel {
  T od, pbot, ab0, sb0;
};

template <typename T, bool kPlanes>
__global__ void __launch_bounds__(
    kMaxThreads, sizeof(T) == 4 ? 65536 / (kMaxThreads * kF32Regs) : 1)
    tripleclouds_lw_kernel(TcLwArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int col = blockIdx.x;
  const int g = threadIdx.x;
  const bool on = g < a.ng;
  const int band = on ? a.band_of_g[g] : 0;
  const int nlev = a.nlev, ng = a.ng, nband = a.nband;
  const int nwarp = blockDim.x >> 5;
  const bool derivs = a.deriv_t != nullptr;
  // shared: the warp partials of up to two per-level sums (at least 32
  // entries, block_sum's scratch), then the column's u and v matrices,
  // region fractions, od scalings and clear flags
  T *part = reinterpret_cast<T *>(smem_raw);
  T *su = part + d_max(2 * nlev * nwarp, 32);
  T *sv = su + (nlev + 1) * 9;
  T *srf = sv + (nlev + 1) * 9;
  T *ssc = srf + nlev * 3;
  unsigned char *sclr = reinterpret_cast<unsigned char *>(ssc + nlev * 2);
  tc_stage_column(su, srf, sv, ssc, sclr, a.u9, a.rf3, a.v9, a.scal2,
                  a.clear, col, nlev);

  const size_t cg = (size_t)col * ng + g;
  const size_t cl0 = (size_t)col * nlev;
  auto lg = [&](int l) { return (cl0 + l) * (size_t)ng + g; };
  auto lgr = [&](int l, int r) {
    return ((cl0 + l) * 3 + r) * (size_t)ng + g;
  };
  auto hl = [&](int l) { return ((size_t)col * (nlev + 1) + l) * ng + g; };
  auto lb = [&](int l) { return (cl0 + l) * (size_t)nband + band; };

  // --- clear sky down
  T fdn = T(0);
  {
    T ptop = T(0), od_n = T(0), pbot_n = T(0);
    if (on) {
      ptop = a.planck_hl[hl(0)];
      od_n = a.od[lg(0)];
      pbot_n = a.planck_hl[hl(1)];
      if (kPlanes) a.dn_g_c[hl(0)] = T(0);
    }
    for (int l = 0; l < nlev; ++l) {
      if (on) {
        const T od = od_n, pbot = pbot_n;
        if (l + 1 < nlev) {
          od_n = a.od[lg(l + 1)];
          pbot_n = a.planck_hl[hl(l + 2)];
        }
        T trans_c, su_c, sd_c;
        lw_no_scattering_trans(od, ptop, pbot, trans_c, su_c, sd_c);
        fdn = trans_c * fdn + sd_c;
        if (kPlanes) a.dn_g_c[hl(l + 1)] = fdn;
        ptop = pbot;
      }
      warp_partial(fdn, part, l, nwarp);
    }
  }
  const T emission = on ? a.emission[cg] : T(0);
  const T albedo = on ? a.albedo[cg] : T(0);
  const T fup_surf_c = emission + albedo * fdn;
  if (on) {
    a.fdn_surf_c[cg] = fdn;
    a.fup_surf_c[cg] = fup_surf_c;
  }
  {
    T *const outs[1] = {a.dn_bb_c + cl0};
    store_level_sums(part, outs, nlev, nwarp);
  }

  // --- up: clear up, 3-region Moebius and derivative weights
  T fup = fup_surf_c;
  {
    T alb[3] = {albedo, albedo, albedo};
    T src[3] = {T(0), T(0), T(0)};
    T w[3] = {T(1), T(0), T(0)};
    T pbot = T(0);
    UpLevel<T> nxt;
    auto load_up = [&](int l) {
      UpLevel<T> n;
      n.od = a.od[lg(l)];
      n.ptop = a.planck_hl[hl(l)];
      if (!sclr[l]) {
        n.odcb = a.odc_b[lb(l)];
        n.ssacb = a.ssac_b[lb(l)];
        n.gcb = a.gc_b[lb(l)];
      }
      return n;
    };
    if (on) {
#pragma unroll
      for (int r = 0; r < 3; ++r)
        src[r] = a.src0[((size_t)col * 3 + r) * ng + g];
      pbot = a.planck_hl[hl(nlev)];
      nxt = load_up(nlev - 1);
      if (kPlanes) a.up_g_c[hl(nlev)] = fup;
    }
    for (int l = nlev - 1; l >= 0; --l) {
      if (on) {
        const UpLevel<T> s = nxt;
        const bool cloudy = !sclr[l];
        if (l > 0) nxt = load_up(l - 1);
        const T *rf = srf + 3 * l;
        T trans_c, su_c, sd_c;
        lw_no_scattering_trans(s.od, s.ptop, pbot, trans_c, su_c, sd_c);
        fup = trans_c * fup + su_c;
        if (kPlanes) a.up_g_c[hl(l)] = fup;
        T refl[3] = {T(0), T(0), T(0)}, trans[3] = {trans_c, T(1), T(1)};
        T su_r[3] = {su_c * rf[0], T(0), T(0)};
        T sd_r[3] = {sd_c * rf[0], T(0), T(0)};
        if (cloudy)
          cloudy_regions(s.od, s.odcb, s.ssacb, s.gcb, ssc + 2 * l, rf,
                         s.ptop, pbot, refl, trans, su_r, sd_r);
        a.albb[lgr(l, 0)] = alb[0];
        a.srcb[lgr(l, 0)] = src[0];
        // region 0 does not reflect, so its Moebius denominator is 1; in a
        // clear layer regions 1 and 2 pass albedo and source through
        T an[3] = {trans[0] * trans[0] * alb[0], alb[1], alb[2]};
        T sn[3] = {su_r[0] + trans[0] * (src[0] + alb[0] * sd_r[0]), src[1],
                   src[2]};
        if (cloudy) {
#pragma unroll
          for (int r = 1; r < 3; ++r) {
            a.albb[lgr(l, r)] = alb[r];
            a.srcb[lgr(l, r)] = src[r];
            const T inv = T(1) / (T(1) - alb[r] * refl[r]);
            an[r] = refl[r] + trans[r] * trans[r] * alb[r] * inv;
            sn[r] = su_r[r] + trans[r] * (src[r] + alb[r] * sd_r[r]) * inv;
          }
        }
        if (!cloudy && (l == 0 || sclr[l - 1])) {
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            alb[r] = an[r];
            src[r] = sn[r];
          }
        } else {
          mix_cols(sv + 9 * l, an, alb);
          mix_rows(su + 9 * l, sn, src);
        }
        if (derivs) {
          T m[3];
          mix_rows(su + 9 * (l + 1), w, m);
#pragma unroll
          for (int r = 0; r < 3; ++r) w[r] = m[r] * trans[r];
          a.wsum[lg(l)] = w[0] + w[1] + w[2];
        }
        pbot = s.ptop;
      }
      warp_partial(fup, part, l, nwarp);
    }
    if (on) {
      a.fup_toa_c[cg] = fup;
#pragma unroll
      for (int r = 0; r < 3; ++r)
        a.src_top_t[((size_t)col * 3 + r) * ng + g] = src[r];
      if (kPlanes) {
        a.up_g_t[hl(0)] = src[0] + src[1] + src[2];
        a.dn_g_t[hl(0)] = T(0);
      }
    }
  }
  {
    T *const outs[1] = {a.up_bb_c + cl0};
    store_level_sums(part, outs, nlev, nwarp);
  }

  // --- down: the 3 regions, TOA -> surface
  T dn_g = T(0), up_g = T(0);
  {
    T fd[3] = {T(0), T(0), T(0)};
    T ptop = T(0);
    DnLevel<T> nxt;
    auto load_dn = [&](int l) {
      if (!sclr[l]) {
#pragma unroll
        for (int r = 1; r < 3; ++r) {
          prefetch_l2(a.albb + lgr(l, r));
          prefetch_l2(a.srcb + lgr(l, r));
        }
      }
      return DnLevel<T>{a.od[lg(l)], a.planck_hl[hl(l + 1)],
                        a.albb[lgr(l, 0)], a.srcb[lgr(l, 0)]};
    };
    if (on) {
      ptop = a.planck_hl[hl(0)];
      nxt = load_dn(0);
    }
    for (int l = 0; l < nlev; ++l) {
      if (on) {
        const DnLevel<T> s = nxt;
        const bool cloudy = !sclr[l];
        if (l + 1 < nlev) nxt = load_dn(l + 1);
        const T *rf = srf + 3 * l;
        T trans_c, su_c, sd_c;
        lw_no_scattering_trans(s.od, ptop, s.pbot, trans_c, su_c, sd_c);
        // region 0 does not reflect; regions 1 and 2 are zero in a clear
        // layer
        T f[3] = {trans_c * fd[0] + sd_c * rf[0], T(0), T(0)};
        T u[3] = {s.sb0 + f[0] * s.ab0, T(0), T(0)};
        if (cloudy) {
          // the cloudy regions' coefficients again (faster than
          // storing them in the up pass and reading them back: PERF.md)
          T refl[3], trans[3], su_r[3], sd_r[3];
          cloudy_regions(s.od, a.odc_b[lb(l)], a.ssac_b[lb(l)],
                         a.gc_b[lb(l)], ssc + 2 * l, rf, ptop, s.pbot, refl,
                         trans, su_r, sd_r);
#pragma unroll
          for (int r = 1; r < 3; ++r) {
            const T ab = a.albb[lgr(l, r)], sb = a.srcb[lgr(l, r)];
            f[r] = (trans[r] * fd[r] + refl[r] * sb + sd_r[r]) /
                   (T(1) - refl[r] * ab);
            u[r] = sb + f[r] * ab;
          }
        }
        dn_g = f[0] + f[1] + f[2];
        up_g = u[0] + u[1] + u[2];
        if (kPlanes) {
          a.dn_g_t[hl(l + 1)] = dn_g;
          a.up_g_t[hl(l + 1)] = up_g;
        }
        if (!cloudy && (l + 1 >= nlev || sclr[l + 1])) {
#pragma unroll
          for (int r = 0; r < 3; ++r) fd[r] = f[r];
        } else {
          mix_rows(sv + 9 * (l + 1), f, fd);
        }
        ptop = s.pbot;
      }
      warp_partial(dn_g, part, 2 * l, nwarp);
      warp_partial(up_g, part, 2 * l + 1, nwarp);
    }
  }
  if (on) {
    a.fdn_surf_t[cg] = dn_g;
    a.fup_surf_t[cg] = up_g;
  }
  {
    T *const outs[2] = {a.dn_bb_t + cl0, a.up_bb_t + cl0};
    store_level_sums(part, outs, nlev, nwarp);
  }
  if (!derivs) return;

  // --- derivatives: deriv_t[l] = sum_g d0_g W[l, g]
  {
    T v[1] = {up_g};
    block_sum<T, 1>(v, part);
    if (threadIdx.x == 0) part[0] = d_max(v[0], T(1e-30));
    __syncthreads();
  }
  const T d0 = on ? up_g / part[0] : T(0);
  __syncthreads();
#pragma unroll 4
  for (int l = 0; l < nlev; ++l)
    warp_partial(on ? d0 * a.wsum[lg(l)] : T(0), part, l, nwarp);
  T *const outs[1] = {a.deriv_t + cl0};
  store_level_sums(part, outs, nlev, nwarp);
}

// Launch the build with or without planes.
template <typename T, bool kPlanes>
int launch_as(const TcLwArgs<T> &a, int ncol, int threads, size_t smem,
              void *stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tripleclouds_lw_kernel<T, kPlanes>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  tripleclouds_lw_kernel<T, kPlanes>
      <<<ncol, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(void *const *p, int ncol, int nlev, int ng, int nband, int planes,
           void *stream) {
  TcLwArgs<T> a;
  const T **in[] = {&a.od, &a.odc_b, &a.ssac_b, &a.gc_b, &a.scal2};
  const T **in2[] = {&a.rf3, &a.u9, &a.v9, &a.planck_hl, &a.emission,
                     &a.albedo, &a.src0};
  T **out[] = {&a.dn_bb_c, &a.fdn_surf_c, &a.fup_surf_c, &a.up_bb_c,
               &a.fup_toa_c, &a.src_top_t, &a.dn_bb_t, &a.up_bb_t,
               &a.fdn_surf_t, &a.fup_surf_t, &a.deriv_t, &a.albb, &a.srcb,
               &a.wsum, &a.up_g_c, &a.dn_g_c, &a.up_g_t, &a.dn_g_t};
  int k = 0;
  for (const T **q : in) *q = (const T *)p[k++];
  a.clear = (const unsigned char *)p[k++];
  for (const T **q : in2) *q = (const T *)p[k++];
  a.band_of_g = (const int *)p[k++];
  for (T **q : out) *q = (T *)p[k++];
  a.nlev = nlev;
  a.ng = ng;
  a.nband = nband;
  const int threads = ((ng + 31) / 32) * 32;
  const int npart = 2 * nlev * (threads / 32);
  const size_t smem =
      sizeof(T) * ((size_t)(npart > 32 ? npart : 32) +
                   (size_t)(nlev + 1) * 18 + (size_t)nlev * 5) +
      nlev;
  return planes ? launch_as<T, true>(a, ncol, threads, smem, stream)
                : launch_as<T, false>(a, ncol, threads, smem, stream);
}

}  // namespace

// p: the 32 tensor pointers in the order of TcLwArgs (deriv_t and wsum
// null when derivatives are off, the four planes unless planes).
extern "C" int ecrad_tripleclouds_lw_f32(void *const *p, int ncol, int nlev,
                                         int ng, int nband, int planes,
                                         void *stream) {
  return launch<float>(p, ncol, nlev, ng, nband, planes, stream);
}

extern "C" int ecrad_tripleclouds_lw_f64(void *const *p, int ncol, int nlev,
                                         int ng, int nband, int planes,
                                         void *stream) {
  return launch<double>(p, ncol, nlev, ng, nband, planes, stream);
}
