// Fused McICA shortwave solver: cloud merge + delta-Eddington +
// Meador-Weaver + adding sweeps for the clear and total scenes in one
// kernel.
//
// Replaces the TPU kernels of ecrad_tpu/solvers/pallas_mcica.py:sw_fused
// (_sw_s1_kernel, _sw_s2_kernel, _sw_s3_kernel: three pallas_calls).
// Plain version and wrapper: ecrad_torch/solvers/cuda_mcica.py
// (sw_fused_plain, sw_fused).
//
// Per column and g-point, both scenes advance together in two passes:
//   up   surface -> TOA: each layer's coefficients of each scene (the clear
//        scene always, the total scene only in a cloudy layer, where it
//        differs: the _merge_sw cloud merge, the optional delta-Eddington
//        scaling, sw_ref_trans with expm1; the TPU's cubic series is not
//        needed), and the diffuse and direct albedos of both scenes below
//        each layer (radiation_adding_ica_sw.F90:24-153);
//   down TOA -> surface: the same coefficients again, the direct beam
//        (trans_dir_dir, which is sw_direct_trans bit for bit) and the
//        diffuse flux of both scenes together, with the six per-level
//        broadband sums.
// The TPU's direct-beam pass is not needed because the up pass carries a
// direct albedo (the upward source per unit direct flux at an interface)
// in place of the source: with src = albd * tdir * f_top, the Moebius
// source step becomes albd_top = rdir + (tdir * albd + tdd * alb) * trans
// / (1 - alb * refl), from the surface's direct albedo times mu0, and the
// TOA source is albd_top * incoming.  That is the function of the three
// sweeps of cuda_adding.sw_sweeps_plain in another rounding order, not bit
// for bit.  mu0 arrives clamped to 1e-10; night columns are zeroed by the
// caller.
//
// What bounds it on the H100: the latency of the level recurrence, not
// the bytes (~14 plane passes, a third of the memory rate at the measured
// time) and not the arithmetic (two Meador-Weaver evaluations per scene
// and layer).  Tensor cores do not apply: each g-point's work is a scalar
// recurrence, and no product here has the shape of an MMA.  One block per
// column with one thread per g-point keeps the carries in registers and
// each load contiguous over g, and covers any ncol.  The column's cloud
// mask is staged in shared memory once, so the level loops hold no
// barrier: each warp leaves its shuffle-tree partial of the six per-level
// sums in shared memory, and the partials are added in warp order after
// the down pass (deterministic, the order of a block reduction).  The
// loads of the next level are issued one level ahead.  Only the albedos go
// from the up to the down pass, through scratch the wrapper allocates; the
// down pass computes the coefficients again, which measured as fast as
// storing and reading them back (PERF.md).  The f32 build is held to 64
// registers without spilling, so 8 blocks of 128 threads fit on an SM and
// 2048 columns take 2 waves, not 4; that measured as fast as no cap and
// faster than a cap of 80 (PERF.md).  The file is compiled without FMA
// contraction (kernels.SOURCE_FLAGS), so that the f64 coefficients round op
// for op as the plain torch version's do: near k * mu0 = 1 the Meador-Weaver
// direct-beam coefficients lose up to ~10 digits to cancellation, and FMA
// rounding alone moves the f64 fluxes by more than chip_smoke.py's f64
// tolerance.  The f32 build measured no slower without it (PERF.md).
//
// Spectral flux output: the build with kPlanes also stores each thread's
// fluxes at every half-level of the down pass, where it already holds them
// before the warp partials, into six planes (ncol, nlev+1, ng): per scene
// the up flux, the diffuse down flux and the direct flux (normal to the
// beam, as the broadband dir_bb sums), rows 0 and nlev the TOA and surface
// values.  Stores are contiguous over g, with no atomics and no barrier;
// the caller projects the planes onto bands and applies mu0.  The build
// without kPlanes is the kernel above, unchanged.
#include "common.cuh"

namespace {

using namespace ecrad;

// Blocks of up to 256 threads (g-points); the f32 build's register cap (the
// f64 build is not capped).
constexpr int kMaxThreads = 256;
constexpr int kF32Regs = 64;
constexpr int kSums = 6;  // dir_c, dir_t, dn_c, up_c, dn_t, up_t

template <typename T> struct SwArgs {
  const T *od, *ssa, *g, *od_scaling, *odc_b, *ssac_b, *gc_b;
  const unsigned char *mask;
  const T *mu0, *incoming, *alb_dif, *alb_dir_mu0;
  const int *band_of_g;
  T *dir_bb_c, *dir_bb_t, *fdir_surf_c, *fdir_surf_t, *src_top_c,
      *src_top_t, *dn_bb_c, *up_bb_c, *dn_bb_t, *up_bb_t, *fdn_surf_c,
      *fdn_surf_t;
  // scratch: the diffuse and direct albedos of both scenes below each
  // layer, (ncol, nlev, ng) each
  T *albb_c, *albdb_c, *albb_t, *albdb_t;
  // per-g planes (ncol, nlev+1, ng), written by the kPlanes build only
  T *up_g_c, *dn_g_c, *dir_g_c, *up_g_t, *dn_g_t, *dir_g_t;
  int nlev, ng, nband, delta_gases;
};

// The optical properties of one (column, layer, g-point) as loaded: the
// gas and, in a cloudy layer, the od scaling and the cloud's band
// properties.
template <typename T> struct Props {
  T od, ssa, g, scale, odcb, ssacb, gcb;
};

template <typename T>
__device__ __forceinline__ Props<T> load_props(const SwArgs<T> &a,
                                               size_t lg, size_t lb,
                                               bool cloudy) {
  Props<T> p;
  p.od = a.od[lg];
  p.ssa = a.ssa[lg];
  p.g = a.g[lg];
  if (cloudy) {
    p.scale = a.od_scaling[lg];
    p.odcb = a.odc_b[lb];
    p.ssacb = a.ssac_b[lb];
    p.gcb = a.gc_b[lb];
  }
  return p;
}

// Both scenes' coefficients of one layer: the clear scene's, and in a
// cloudy layer the total scene's (merged from the unscaled gas, then each
// scene optionally delta-Eddington scaled); t = c in a clear layer.
template <typename T>
__device__ __forceinline__ void layer_coefs(const Props<T> &p, bool cloudy,
                                            bool delta, T mu0, SwCoef<T> &c,
                                            SwCoef<T> &t) {
  T od = p.od, ssa = p.ssa, asy = p.g;
  if (cloudy) {
    T od_t, ssa_t, g_t;
    merge_sw(od, ssa, asy, p.scale * p.odcb, p.ssacb, p.gcb, od_t, ssa_t,
             g_t);
    if (delta) delta_eddington(od_t, ssa_t, g_t);
    sw_ref_trans(mu0, od_t, ssa_t, g_t, t.refl, t.trans, t.rdir, t.tdd,
                 t.tdir);
  }
  if (delta) delta_eddington(od, ssa, asy);
  sw_ref_trans(mu0, od, ssa, asy, c.refl, c.trans, c.rdir, c.tdd, c.tdir);
  if (!cloudy) t = c;
}

// What the down pass loads at a level: the layer's optical properties and
// both scenes' albedos below it.
template <typename T> struct DnLevel {
  Props<T> p;
  T ac, adc, at, adt;
};

template <typename T>
__device__ __forceinline__ DnLevel<T> load_dn(const SwArgs<T> &a, size_t lg,
                                              size_t lb, bool cloudy) {
  DnLevel<T> n;
  n.p = load_props(a, lg, lb, cloudy);
  n.ac = a.albb_c[lg];
  n.adc = a.albdb_c[lg];
  n.at = a.albb_t[lg];
  n.adt = a.albdb_t[lg];
  return n;
}

template <typename T, bool kPlanes>
__global__ void __launch_bounds__(
    kMaxThreads, sizeof(T) == 4 ? 65536 / (kMaxThreads * kF32Regs) : 1)
    sw_fused_kernel(SwArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int col = blockIdx.x;
  const int g = threadIdx.x;
  const bool on = g < a.ng;
  const int band = on ? a.band_of_g[g] : 0;
  const int nlev = a.nlev, ng = a.ng, nband = a.nband;
  const int nwarp = blockDim.x >> 5;
  // shared: the six per-level sums' warp partials, then the column's mask
  T *part = reinterpret_cast<T *>(smem_raw);
  unsigned char *smask =
      reinterpret_cast<unsigned char *>(part + (size_t)nlev * kSums * nwarp);
  for (int i = threadIdx.x; i < nlev; i += blockDim.x)
    smask[i] = a.mask[(size_t)col * nlev + i] != 0;
  __syncthreads();

  const size_t cg = (size_t)col * ng + g;
  const size_t cl0 = (size_t)col * nlev;
  const T mu0 = a.mu0[col];
  const bool delta = a.delta_gases != 0;
  auto lg = [&](int l) { return (cl0 + l) * (size_t)ng + g; };
  auto lb = [&](int l) { return (cl0 + l) * (size_t)nband + band; };
  auto hl = [&](int l) { return ((size_t)col * (nlev + 1) + l) * ng + g; };

  // --- up pass: the albedos of both scenes, surface -> TOA
  if (on) {
    T ac = a.alb_dif[cg], adc = a.alb_dir_mu0[cg];
    T at = ac, adt = adc;
    Props<T> nxt = load_props(a, lg(nlev - 1), lb(nlev - 1),
                              smask[nlev - 1]);
    for (int l = nlev - 1; l >= 0; --l) {
      const Props<T> p = nxt;
      const bool cloudy = smask[l];
      if (l > 0) nxt = load_props(a, lg(l - 1), lb(l - 1), smask[l - 1]);
      SwCoef<T> c, t;
      layer_coefs(p, cloudy, delta, mu0, c, t);
      a.albb_c[lg(l)] = ac;
      a.albdb_c[lg(l)] = adc;
      a.albb_t[lg(l)] = at;
      a.albdb_t[lg(l)] = adt;
      albedo_up(c, ac, adc, ac, adc);
      albedo_up(t, at, adt, at, adt);
    }
    const T incoming = a.incoming[cg];
    a.src_top_c[cg] = adc * incoming;
    a.src_top_t[cg] = adt * incoming;
    if (kPlanes) {
      a.up_g_c[hl(0)] = adc * incoming;
      a.up_g_t[hl(0)] = adt * incoming;
      a.dn_g_c[hl(0)] = a.dn_g_t[hl(0)] = T(0);
      a.dir_g_c[hl(0)] = a.dir_g_t[hl(0)] = incoming;
    }
  }

  // --- down pass: direct beam and diffuse flux of both scenes
  T fc = T(0), ft = T(0), dc = T(0), dt = T(0);
  DnLevel<T> nxt;
  if (on) {
    fc = ft = a.incoming[cg];
    nxt = load_dn(a, lg(0), lb(0), smask[0]);
  }
  for (int l = 0; l < nlev; ++l) {
    T uc = T(0), ut = T(0);
    if (on) {
      const DnLevel<T> s = nxt;
      const bool cloudy = smask[l];
      if (l + 1 < nlev) nxt = load_dn(a, lg(l + 1), lb(l + 1), smask[l + 1]);
      SwCoef<T> c, t;
      layer_coefs(s.p, cloudy, delta, mu0, c, t);
      const T fc_top = fc, ft_top = ft;
      fc = c.tdir * fc_top;
      ft = t.tdir * ft_top;
      diffuse_down(c, fc_top, dc, s.ac, s.adc, dc, uc);
      diffuse_down(t, ft_top, dt, s.at, s.adt, dt, ut);
      if (kPlanes) {
        const size_t h = hl(l + 1);
        a.dir_g_c[h] = fc;
        a.dir_g_t[h] = ft;
        a.dn_g_c[h] = dc;
        a.up_g_c[h] = uc;
        a.dn_g_t[h] = dt;
        a.up_g_t[h] = ut;
      }
    }
    const T v[kSums] = {fc, ft, dc, uc, dt, ut};
#pragma unroll
    for (int i = 0; i < kSums; ++i)
      warp_partial(v[i], part, l * kSums + i, nwarp);
  }
  if (on) {
    a.fdir_surf_c[cg] = fc;
    a.fdir_surf_t[cg] = ft;
    a.fdn_surf_c[cg] = dc;
    a.fdn_surf_t[cg] = dt;
  }
  T *const outs[kSums] = {a.dir_bb_c + cl0, a.dir_bb_t + cl0,
                          a.dn_bb_c + cl0,  a.up_bb_c + cl0,
                          a.dn_bb_t + cl0,  a.up_bb_t + cl0};
  store_level_sums(part, outs, nlev, nwarp);
}

// Launch the build with or without planes.
template <typename T, bool kPlanes>
int launch_as(const SwArgs<T> &a, int ncol, int threads, size_t smem,
              void *stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sw_fused_kernel<T, kPlanes>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sw_fused_kernel<T, kPlanes><<<ncol, threads, smem, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(void *const *p, int ncol, int nlev, int ng, int nband,
           int delta_gases, int planes, void *stream) {
  SwArgs<T> a;
  const T **in[] = {&a.od, &a.ssa, &a.g, &a.od_scaling, &a.odc_b,
                    &a.ssac_b, &a.gc_b};
  const T **in2[] = {&a.mu0, &a.incoming, &a.alb_dif, &a.alb_dir_mu0};
  T **out[] = {&a.dir_bb_c, &a.dir_bb_t, &a.fdir_surf_c, &a.fdir_surf_t,
               &a.src_top_c, &a.src_top_t, &a.dn_bb_c, &a.up_bb_c,
               &a.dn_bb_t, &a.up_bb_t, &a.fdn_surf_c, &a.fdn_surf_t,
               &a.albb_c, &a.albdb_c, &a.albb_t, &a.albdb_t, &a.up_g_c,
               &a.dn_g_c, &a.dir_g_c, &a.up_g_t, &a.dn_g_t, &a.dir_g_t};
  int k = 0;
  for (const T **q : in) *q = (const T *)p[k++];
  a.mask = (const unsigned char *)p[k++];
  for (const T **q : in2) *q = (const T *)p[k++];
  a.band_of_g = (const int *)p[k++];
  for (T **q : out) *q = (T *)p[k++];
  a.nlev = nlev;
  a.ng = ng;
  a.nband = nband;
  a.delta_gases = delta_gases;
  const int threads = ((ng + 31) / 32) * 32;
  const size_t smem =
      sizeof(T) * (size_t)nlev * kSums * (threads / 32) + nlev;
  return planes ? launch_as<T, true>(a, ncol, threads, smem, stream)
                : launch_as<T, false>(a, ncol, threads, smem, stream);
}

}  // namespace

// p: the 35 tensor pointers in the order of SwArgs (the six planes null
// unless planes).
extern "C" int ecrad_sw_fused_f32(void *const *p, int ncol, int nlev,
                                  int ng, int nband, int delta_gases,
                                  int planes, void *stream) {
  return launch<float>(p, ncol, nlev, ng, nband, delta_gases, planes,
                       stream);
}

extern "C" int ecrad_sw_fused_f64(void *const *p, int ncol, int nlev,
                                  int ng, int nband, int delta_gases,
                                  int planes, void *stream) {
  return launch<double>(p, ncol, nlev, ng, nband, delta_gases, planes,
                        stream);
}
