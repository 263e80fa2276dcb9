// Fused McICA longwave solver: two-stream + cloud merge + adding sweeps
// in one kernel.
//
// Replaces the TPU kernels of ecrad_tpu/solvers/pallas_mcica.py:lw_fused
// (_lw_p1_kernel, _lw_p2_kernel, _lw_p3_kernel, _lw_deriv_kernel: four
// pallas_calls).  Plain version and wrapper: ecrad_torch/solvers/
// cuda_mcica.py (lw_fused_plain, lw_fused).
//
// Per column and g-point, each layer has the clear-sky no-scattering
// transmittance and sources and, in a cloudy layer, the total-sky ones:
// the band cloud properties expanded to the g-point (band_of_g lookup),
// merged with the gas (_merge_lw) and passed through lw_ref_trans; a clear
// layer's total-sky coefficients are the clear ones with no reflection.
// Three passes, each one level chain:
//   clear down: fdn_surf_c, and fup_surf_c = emission + albedo * fdn;
//   up (surface -> TOA): the clear up flux, the total-sky Moebius sweep of
//      albedo and source, storing both below each layer, and the two
//      Hogan-Bozzo derivative chains (below);
//   total-sky down: fup_surf_t = albedo * fdn_surf_t + emission.
// The derivatives d(flux_up)/d(flux_up_surf) are d0 times the product of
// the transmittances from the surface up, d0 = fup_surf / max(sum_g
// fup_surf, 1e-30) (radiation_lw_derivatives.F90:43-83).  The clear d0 is
// known after the clear down pass, so the up pass carries the clear chain
// itself.  The total d0 is known only after the down pass: the up pass
// carries the product w from 1 and stores it, and deriv_t[l] = sum_g d0_g
// w[l, g] is one sum over g per level after the down pass.  That is the
// function of the TPU's derivative pass in another rounding order.
//
// What bounds it on the H100: the latency of the level recurrences, not
// the bytes (~12 plane passes, under half the memory rate at the measured
// time) or the arithmetic.  One block per column with one thread per
// g-point keeps the carries in registers, makes every level's loads
// contiguous over g, puts the whole column's sums over g inside one block,
// and covers any ncol.  The column's cloud mask is staged in shared memory
// once, so the level loops hold no barrier: each warp leaves its
// shuffle-tree partial of the per-level sums in shared memory, and the
// partials are added in warp order after each pass (deterministic, the
// order of a block reduction, so repeated runs agree bit for bit).  A
// barrier per level to keep the warps together measured no faster
// (PERF.md).  The Planck function at a layer's base is carried to the next
// layer's top, so a pass loads it once per level, and the loads every
// level makes are issued one level ahead.  A clear layer costs one
// exponential per pass; a cloudy one evaluates lw_ref_trans in the up pass
// and again in the down pass.  The albedo and source go from the up to the
// down pass through scratch the wrapper allocates, and the total-sky
// derivative weights through one more plane.  The f32 build is held to 48
// registers without spilling, so 8 blocks of 160 threads fit on an SM and
// 2048 columns take 2 waves, not 3 (59-74 registers uncapped), which
// measured 10-22% faster (PERF.md).
//
// Spectral flux output: the build with kPlanes also stores each thread's
// flux at every half-level, where it already holds it before the warp
// partial, into four planes (ncol, nlev+1, ng): the clear and total-sky up
// and down fluxes, rows 0 and nlev the TOA and surface values.  Stores are
// contiguous over g, with no atomics and no barrier; the caller projects
// the planes onto bands.  The build without kPlanes is the kernel above,
// unchanged.
#include "common.cuh"

namespace {

using namespace ecrad;

// Blocks of up to 256 threads (g-points); the f32 build's register cap (the
// f64 build is not capped).
constexpr int kMaxThreads = 256;
constexpr int kF32Regs = 48;

template <typename T> struct LwArgs {
  const T *od, *odc_b, *ssac_b, *gc_b, *od_scaling, *planck_hl;
  const unsigned char *mask;
  const T *emission, *albedo;
  const int *band_of_g;
  T *dn_bb_c, *fdn_surf_c, *up_bb_c, *fup_toa_c, *fup_surf_c;
  T *src_top_t, *dn_bb_t, *up_bb_t, *fdn_surf_t, *fup_surf_t;
  T *deriv_c, *deriv_t;      // null when derivatives are off
  // scratch (ncol, nlev, ng): the albedo and source below each layer, and
  // the total-sky derivative weights (null when derivatives are off)
  T *alb_below, *src_below, *wsum;
  // per-g planes (ncol, nlev+1, ng), written by the kPlanes build only
  T *up_g_c, *dn_g_c, *up_g_t, *dn_g_t;
  int nlev, ng, nband;
};

// A cloudy layer's cloud at one g-point: the od scaling and the band's
// optical depth, single-scattering albedo and asymmetry.
template <typename T> struct Cloud {
  T scale, odcb, ssacb, gcb;
};

template <typename T>
__device__ __forceinline__ Cloud<T> load_cloud(const LwArgs<T> &a, size_t lg,
                                               size_t lb) {
  return {a.od_scaling[lg], a.odc_b[lb], a.ssac_b[lb], a.gc_b[lb]};
}

// Total-sky coefficients of a cloudy layer.
template <typename T>
__device__ __forceinline__ void cloudy_coefs(T od, const Cloud<T> &c,
                                             T ptop, T pbot, T &refl,
                                             T &trans, T &s_up, T &s_dn) {
  T od_t, ssa_t, g_t;
  merge_lw(od, c.scale * c.odcb, c.ssacb, c.gcb, od_t, ssa_t, g_t);
  lw_ref_trans(od_t, ssa_t, g_t, ptop, pbot, refl, trans, s_up, s_dn);
}

// What the up pass loads ahead at every level: od and the Planck function
// at the layer top (the base's comes from the level below).
template <typename T> struct UpLevel {
  T od, ptop;
};

// ... and the down pass: od, the Planck function at the layer base, the
// albedo and source below the layer.
template <typename T> struct DnLevel {
  T od, pbot, alb, src;
};

template <typename T, bool kPlanes>
__global__ void __launch_bounds__(
    kMaxThreads, sizeof(T) == 4 ? 65536 / (kMaxThreads * kF32Regs) : 1)
    lw_fused_kernel(LwArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int col = blockIdx.x;
  const int g = threadIdx.x;
  const bool on = g < a.ng;
  const int band = on ? a.band_of_g[g] : 0;
  const int nlev = a.nlev, ng = a.ng, nband = a.nband;
  const int nwarp = blockDim.x >> 5;
  const bool derivs = a.deriv_c != nullptr;
  // shared: the warp partials of up to two per-level sums (at least 32
  // entries, block_sum's scratch), then the column's cloud mask
  T *part = reinterpret_cast<T *>(smem_raw);
  unsigned char *smask =
      reinterpret_cast<unsigned char *>(part + d_max(2 * nlev * nwarp, 32));
  for (int i = threadIdx.x; i < nlev; i += blockDim.x)
    smask[i] = a.mask[(size_t)col * nlev + i] != 0;
  __syncthreads();

  const size_t cg = (size_t)col * ng + g;
  const size_t cl0 = (size_t)col * nlev;
  auto lg = [&](int l) { return (cl0 + l) * (size_t)ng + g; };
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
  // the clear derivative's start d0_c
  T dc = T(0);
  if (derivs) {
    T v[1] = {fup_surf_c};
    block_sum<T, 1>(v, part);
    if (threadIdx.x == 0) part[0] = d_max(v[0], T(1e-30));
    __syncthreads();
    dc = fup_surf_c / part[0];
    __syncthreads();
  }

  // --- up: clear up, total-sky Moebius, the derivative chains
  // (per-level sums: the clear up flux, and with derivatives deriv_c)
  const int nsum_up = derivs ? 2 : 1;
  {
    T fup = fup_surf_c, alb = albedo, src = emission, w = T(1);
    T pbot = T(0);
    UpLevel<T> nxt;
    auto load_up = [&](int l) {
      return UpLevel<T>{a.od[lg(l)], a.planck_hl[hl(l)]};
    };
    if (on) {
      pbot = a.planck_hl[hl(nlev)];
      nxt = load_up(nlev - 1);
      if (kPlanes) a.up_g_c[hl(nlev)] = fup;
    }
    for (int l = nlev - 1; l >= 0; --l) {
      if (on) {
        const UpLevel<T> s = nxt;
        const bool cloudy = smask[l];
        if (l > 0) nxt = load_up(l - 1);
        T trans_c, su_c, sd_c;
        lw_no_scattering_trans(s.od, s.ptop, pbot, trans_c, su_c, sd_c);
        fup = trans_c * fup + su_c;
        if (kPlanes) a.up_g_c[hl(l)] = fup;
        a.alb_below[lg(l)] = alb;
        a.src_below[lg(l)] = src;
        T trans = trans_c;
        if (cloudy) {
          T refl, s_up, s_dn;
          cloudy_coefs(s.od, load_cloud(a, lg(l), lb(l)), s.ptop, pbot, refl,
                       trans, s_up, s_dn);
          const T inv = T(1) / (T(1) - alb * refl);
          const T alb_new = refl + trans * trans * alb * inv;
          src = s_up + trans * (src + alb * s_dn) * inv;
          alb = alb_new;
        } else {
          // no reflection: the Moebius denominator is 1
          src = su_c + trans_c * (src + alb * sd_c);
          alb = trans_c * trans_c * alb;
        }
        if (derivs) {
          dc = dc * trans_c;
          w = w * trans;
          a.wsum[lg(l)] = w;
        }
        pbot = s.ptop;
      }
      warp_partial(fup, part, nsum_up * l, nwarp);
      if (derivs) warp_partial(dc, part, 2 * l + 1, nwarp);
    }
    if (on) {
      a.fup_toa_c[cg] = fup;
      a.src_top_t[cg] = src;
      if (kPlanes) {
        a.up_g_t[hl(0)] = src;
        a.dn_g_t[hl(0)] = T(0);
      }
    }
  }
  if (derivs) {
    T *const outs[2] = {a.up_bb_c + cl0, a.deriv_c + cl0};
    store_level_sums(part, outs, nlev, nwarp);
  } else {
    T *const outs[1] = {a.up_bb_c + cl0};
    store_level_sums(part, outs, nlev, nwarp);
  }

  // --- total sky down
  fdn = T(0);
  {
    T ptop = T(0);
    DnLevel<T> nxt;
    auto load_dn = [&](int l) {
      return DnLevel<T>{a.od[lg(l)], a.planck_hl[hl(l + 1)],
                        a.alb_below[lg(l)], a.src_below[lg(l)]};
    };
    if (on) {
      ptop = a.planck_hl[hl(0)];
      nxt = load_dn(0);
    }
    for (int l = 0; l < nlev; ++l) {
      T fupl = T(0);
      if (on) {
        const DnLevel<T> s = nxt;
        const bool cloudy = smask[l];
        if (l + 1 < nlev) nxt = load_dn(l + 1);
        if (cloudy) {
          T refl, trans, s_up, s_dn;
          cloudy_coefs(s.od, load_cloud(a, lg(l), lb(l)), ptop, s.pbot,
                       refl, trans, s_up, s_dn);
          const T inv = T(1) / (T(1) - s.alb * refl);
          fdn = (trans * fdn + refl * s.src + s_dn) * inv;
        } else {
          T trans_c, su_c, sd_c;
          lw_no_scattering_trans(s.od, ptop, s.pbot, trans_c, su_c, sd_c);
          fdn = trans_c * fdn + sd_c;
        }
        fupl = s.alb * fdn + s.src;
        if (kPlanes) {
          a.dn_g_t[hl(l + 1)] = fdn;
          a.up_g_t[hl(l + 1)] = fupl;
        }
        ptop = s.pbot;
      }
      warp_partial(fdn, part, 2 * l, nwarp);
      warp_partial(fupl, part, 2 * l + 1, nwarp);
    }
  }
  const T fup_surf_t = albedo * fdn + emission;
  if (on) {
    a.fdn_surf_t[cg] = fdn;
    a.fup_surf_t[cg] = fup_surf_t;
  }
  {
    T *const outs[2] = {a.dn_bb_t + cl0, a.up_bb_t + cl0};
    store_level_sums(part, outs, nlev, nwarp);
  }
  if (!derivs) return;

  // --- total-sky derivatives: deriv_t[l] = sum_g d0_g w[l, g]
  {
    T v[1] = {fup_surf_t};
    block_sum<T, 1>(v, part);
    if (threadIdx.x == 0) part[0] = d_max(v[0], T(1e-30));
    __syncthreads();
  }
  const T d0 = fup_surf_t / part[0];
  __syncthreads();
#pragma unroll 4
  for (int l = 0; l < nlev; ++l)
    warp_partial(on ? d0 * a.wsum[lg(l)] : T(0), part, l, nwarp);
  T *const outs[1] = {a.deriv_t + cl0};
  store_level_sums(part, outs, nlev, nwarp);
}

// Launch the build with or without planes.
template <typename T, bool kPlanes>
int launch_as(const LwArgs<T> &a, int ncol, int threads, size_t smem,
              void *stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lw_fused_kernel<T, kPlanes>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  lw_fused_kernel<T, kPlanes><<<ncol, threads, smem, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(void *const *p, int ncol, int nlev, int ng, int nband, int planes,
           void *stream) {
  LwArgs<T> a;
  const T **in[] = {&a.od, &a.odc_b, &a.ssac_b, &a.gc_b, &a.od_scaling};
  T **out[] = {&a.dn_bb_c,    &a.fdn_surf_c, &a.up_bb_c,    &a.fup_toa_c,
               &a.fup_surf_c, &a.src_top_t,  &a.dn_bb_t,    &a.up_bb_t,
               &a.fdn_surf_t, &a.fup_surf_t, &a.deriv_c,    &a.deriv_t,
               &a.alb_below,  &a.src_below,  &a.wsum,       &a.up_g_c,
               &a.dn_g_c,     &a.up_g_t,     &a.dn_g_t};
  int k = 0;
  for (const T **q : in) *q = (const T *)p[k++];
  a.mask = (const unsigned char *)p[k++];
  a.planck_hl = (const T *)p[k++];
  a.emission = (const T *)p[k++];
  a.albedo = (const T *)p[k++];
  a.band_of_g = (const int *)p[k++];
  for (T **q : out) *q = (T *)p[k++];
  a.nlev = nlev;
  a.ng = ng;
  a.nband = nband;
  const int threads = ((ng + 31) / 32) * 32;
  const int npart = 2 * nlev * (threads / 32);
  const size_t smem = sizeof(T) * (size_t)(npart > 32 ? npart : 32) + nlev;
  return planes ? launch_as<T, true>(a, ncol, threads, smem, stream)
                : launch_as<T, false>(a, ncol, threads, smem, stream);
}

}  // namespace

// p: the 29 tensor pointers in the order of LwArgs (deriv_c, deriv_t and
// wsum null when derivatives are off, the four planes unless planes).
extern "C" int ecrad_lw_fused_f32(void *const *p, int ncol, int nlev,
                                  int ng, int nband, int planes,
                                  void *stream) {
  return launch<float>(p, ncol, nlev, ng, nband, planes, stream);
}

extern "C" int ecrad_lw_fused_f64(void *const *p, int ncol, int nlev,
                                  int ng, int nband, int planes,
                                  void *stream) {
  return launch<double>(p, ncol, nlev, ng, nband, planes, stream);
}
