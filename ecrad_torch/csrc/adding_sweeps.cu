// The generic adding sweeps: LW without scattering, LW/SW scattering
// (Moebius up + affine down), and SW with the direct beam, one launch each.
//
// Replaces the TPU kernels of ecrad_tpu/solvers/pallas_adding.py:
//   lw_noscat_sweeps (_noscat_dn_kernel, _noscat_up_kernel: 2 pallas_calls)
//   scat_sweeps      (_scat_up_kernel, _scat_dn_kernel: 2 pallas_calls)
//   sw_sweeps        (_sw_dir_kernel, _sw_up_kernel, _sw_dn_kernel: 3)
// Plain versions and wrappers: ecrad_torch/solvers/cuda_adding.py.
//
// One block per column, one thread per g-point; each thread runs every
// sweep of its (column, g) in turn, with the level recurrence in
// registers, so every column is computed for any ncol.
//
// lw_noscat_sweeps: two affine sweeps, down (TOA -> surface) then up
// (surface -> TOA), with fup_surf = emission + albedo * fdn_surf between
// them.  Neither needs the other's per-level values, so nothing is handed
// over or recomputed.  Each pass walks chunks of kNoscatChunk = 4 levels
// (down from TOA; up from the surface chunk, which may be shorter) and
// loads a chunk's trans and source for all its levels before its
// recurrence runs; the up pass takes the surface chunk's trans from the
// down pass's registers.
//
// scat_sweeps and sw_sweeps: an up pass and a down pass with nothing
// handed between them per level.  The up pass (surface -> TOA) keeps only
// its carry at the base of every chunk of kChunk levels (chunks counted
// from TOA; the last, at the surface, may be shorter) in a small
// checkpoint buffer (ncol, nchunk, 2, ng) that the wrapper allocates.  The
// down pass walks the chunks from TOA: it loads a chunk's layer planes
// once (kChunk loads of each plane in flight), runs the up recurrence
// over the chunk again from the checkpoint below it, keeping the carries
// below each of its levels in registers, and then the down recurrence
// over the same values.  The recompute repeats the up pass's operations
// on the same values from the same start, so it gives the up pass's
// carries.  Each thread writes and reads back only its own (column, g) of
// the checkpoints, so no barrier is needed there.
//   scat_sweeps carries the albedo and source below each layer
//   (radiation_adding_ica_lw.F90:32-134); the down step reuses the
//   recompute's 1 / (1 - alb_below * refl), the value the plain version
//   computes again.
//   sw_sweeps carries the diffuse albedo and the direct albedo (the upward
//   source per unit direct flux at the interface; common.cuh albedo_up)
//   from (alb0_dif, alb0_dir_x_mu0), so src_top = albd * incoming, and the
//   down pass carries the direct beam (fdir = tdirdir * fdir, as the plain
//   version) with the diffuse flux, each level's step affine in the two
//   with coefficients from the recompute.  Two chains, not the plain
//   version's three: its function in another rounding order, as in
//   csrc/sw_fused.cu.  Night columns (incoming 0) give zeros.
// The per-level broadband sums of all three hold no barrier in the level
// loops: each warp leaves its shuffle-tree partial in shared memory
// (warp_partial), and the partials are added in warp order after the last
// pass (store_level_sums) in block_sum's order: deterministic, so a second
// launch is bit-equal, and the sums a block_sum per level would give.
//
// What bounds them on the H100: bytes.  Per (column, layer, g) the sweeps
// do a few multiply-adds and one or two divisions, against 3 (noscat), 4
// (scat) or 5 (SW) input planes, far below the card's ~20 operations per
// byte.  lw_noscat_sweeps reads trans in both passes and each source in
// one: 4 plane passes.  scat_sweeps and sw_sweeps read each plane twice
// (up pass, down pass) and write no plane: 8 and 10 plane passes, where
// handing the carries over through scratch planes took 11 and 15 (and
// measured ~1.7x slower, also with the hand-off packed per column and
// loads a level ahead).  A chunk's loads are all in flight at once.
// Against this design (PERF.md), scat_sweeps and sw_sweeps: chunks of 4,
// 6 or 16 levels, the chunk in shared memory (cp.async, two stages),
// register caps of 64 or 80 and one barrier per level measured no faster.
// lw_noscat_sweeps: chunks of 2, 3, 6, 8 or 16 levels (8: 48 registers in
// float, 8 blocks per SM, against 40 and 10 at 4), the next chunk's loads
// in flight during a chunk's recurrence (at 4 or 8 levels), __ldg loads,
// one barrier per level and, at 8 levels, register caps for 10 or 12
// blocks per SM (spills) and trans kept in shared memory for the up pass
// (3 plane passes, 2 blocks per SM) measured no faster.  A barrier per
// level inside the `if (k < ch.n)` guard made the up pass's sums wrong;
// after the guard it gave the right sums.
//
// Spectral flux output: each kernel is a template on kPlanes.  The build
// with planes also stores each thread's (g-point's) fluxes at every
// half-level into per-g planes (ncol, nlev+1, ng), TOA first, where the
// level loops already hold them: lw_noscat_sweeps the down flux in its down
// pass and the up flux in its up pass (row nlev fup_surf), scat_sweeps and
// sw_sweeps the down and up fluxes in the down pass, inside each chunk's
// recompute (row 0: 0 and src_top), sw_sweeps also the direct flux (normal
// to the beam; row 0 the incoming flux).  These are the values the plain
// versions return with planes=True.  The stores are contiguous over g (one
// row of a plane per level), with no atomics and no barrier; the build
// without planes is the kernel above, unchanged.
#include "common.cuh"

namespace {

using namespace ecrad;

// Levels per chunk of scat_sweeps' and sw_sweeps' down pass (and the up
// pass's checkpoint stride), and of both passes of lw_noscat_sweeps; chunk
// values live in registers, so these are compile-time constants.
constexpr int kChunk = 8;
constexpr int kNoscatChunk = 4;

template <typename T> struct NoscatArgs {
  const T *trans, *s_up, *s_dn;           // (ncol, nlev, ng)
  const T *emission, *albedo;             // (ncol, ng)
  T *dn_bb, *fdn_surf, *up_bb, *fup_toa, *fup_surf;
  T *dn_g, *up_g;                         // (ncol, nlev+1, ng), kPlanes
  int nlev, ng;
};

template <typename T> struct ScatArgs {
  const T *refl, *trans, *s_up, *s_dn;    // (ncol, nlev, ng)
  const T *alb0, *src0;                   // (ncol, ng)
  T *dn_bb, *up_bb, *src_top, *fdn_surf;
  T *ckpt;                                // (ncol, nchunk, 2, ng)
  T *dn_g, *up_g;                         // (ncol, nlev+1, ng), kPlanes
  int nlev, ng;
};

template <typename T> struct SwArgs {
  const T *refl, *trans, *rdir, *tdd, *tdirdir;       // (ncol, nlev, ng)
  const T *incoming, *alb0_dif, *alb0_dir_x_mu0;      // (ncol, ng)
  T *dir_bb, *dn_bb, *up_bb, *fdir_surf, *fdn_surf, *src_top;
  T *ckpt;                                            // (ncol, nchunk, 2, ng)
  T *dir_g, *dn_g, *up_g;                  // (ncol, nlev+1, ng), kPlanes
  int nlev, ng;
};

// One layer of the Moebius up sweep: the albedo and source of the
// atmosphere from the layer's top down, from those below it.  Returns
// 1 / (1 - alb_below * refl), which the down step needs too.
template <typename T>
__device__ __forceinline__ T moebius_up(T r, T t, T s_up, T s_dn, T &alb,
                                        T &src) {
  const T inv = T(1) / (T(1) - alb * r);
  const T alb_new = r + t * t * alb * inv;
  src = s_up + t * (src + alb * s_dn) * inv;
  alb = alb_new;
  return inv;
}

// Levels [lo, lo + n) of a column's chunk c of K levels; n < K only at the
// surface.
struct Chunk {
  int lo, n;
};

template <int K = kChunk>
__device__ __forceinline__ Chunk chunk_at(int c, int nlev) {
  return {c * K, min(K, nlev - c * K)};
}

// The index of this thread's entry at half-level l of a per-g plane
// (ncol, nlev+1, ng).
__device__ __forceinline__ size_t half_level(int l, int nlev, int ng) {
  return ((size_t)blockIdx.x * (nlev + 1) + l) * ng + threadIdx.x;
}

template <typename T, bool kPlanes>
__global__ void lw_noscat_kernel(NoscatArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T *part = reinterpret_cast<T *>(smem_raw);
  const int g = threadIdx.x;
  const bool on = g < a.ng;
  const int nlev = a.nlev, ng = a.ng, nwarp = blockDim.x >> 5;
  const int nchunk = (nlev + kNoscatChunk - 1) / kNoscatChunk;
  const size_t cl0 = (size_t)blockIdx.x * nlev;
  const size_t cg = (size_t)blockIdx.x * ng + g;
  auto lg = [&](int l) { return (cl0 + l) * (size_t)ng + g; };
  auto hl = [&](int l) { return half_level(l, nlev, ng); };

  // --- down pass, TOA -> surface
  T t[kNoscatChunk], s[kNoscatChunk];
  T fdn = T(0);
  if (kPlanes && on) a.dn_g[hl(0)] = T(0);
  for (int c = 0; c < nchunk; ++c) {
    const Chunk ch = chunk_at<kNoscatChunk>(c, nlev);
    if (on) {
#pragma unroll
      for (int k = 0; k < kNoscatChunk; ++k) {
        if (k < ch.n) {
          const size_t i = lg(ch.lo + k);
          t[k] = a.trans[i];
          s[k] = a.s_dn[i];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kNoscatChunk; ++k) {
      if (k < ch.n) {
        if (on) {
          fdn = t[k] * fdn + s[k];
          if (kPlanes) a.dn_g[hl(ch.lo + k + 1)] = fdn;
        }
        warp_partial(on ? fdn : T(0), part, 2 * (ch.lo + k), nwarp);
      }
    }
  }
  T fup = T(0);
  if (on) {
    fup = a.emission[cg] + a.albedo[cg] * fdn;
    a.fdn_surf[cg] = fdn;
    a.fup_surf[cg] = fup;
    if (kPlanes) a.up_g[hl(nlev)] = fup;
  }
  // --- up pass, surface -> TOA; t still holds the surface chunk's trans
  for (int c = nchunk - 1; c >= 0; --c) {
    const Chunk ch = chunk_at<kNoscatChunk>(c, nlev);
    if (on) {
#pragma unroll
      for (int k = 0; k < kNoscatChunk; ++k) {
        if (k < ch.n) {
          const size_t i = lg(ch.lo + k);
          if (c < nchunk - 1) t[k] = a.trans[i];
          s[k] = a.s_up[i];
        }
      }
    }
#pragma unroll
    for (int k = kNoscatChunk - 1; k >= 0; --k) {
      if (k < ch.n) {
        if (on) {
          fup = t[k] * fup + s[k];
          if (kPlanes) a.up_g[hl(ch.lo + k)] = fup;
        }
        warp_partial(on ? fup : T(0), part, 2 * (ch.lo + k) + 1, nwarp);
      }
    }
  }
  if (on) a.fup_toa[cg] = fup;
  T *const outs[2] = {a.dn_bb + cl0, a.up_bb + cl0};
  store_level_sums(part, outs, nlev, nwarp);
}

template <typename T, bool kPlanes>
__global__ void scat_kernel(ScatArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T *part = reinterpret_cast<T *>(smem_raw);
  const int g = threadIdx.x;
  const bool on = g < a.ng;
  const int nlev = a.nlev, ng = a.ng, nwarp = blockDim.x >> 5;
  const int nchunk = (nlev + kChunk - 1) / kChunk;
  const size_t cl0 = (size_t)blockIdx.x * nlev;
  const size_t cg = (size_t)blockIdx.x * ng + g;
  // this thread's checkpoints: (alb, src) of chunk c at ck[2c ng], +ng
  T *ck = a.ckpt + (size_t)blockIdx.x * nchunk * 2 * ng + g;
  auto lg = [&](int l) { return (cl0 + l) * (size_t)ng + g; };
  auto hl = [&](int l) { return half_level(l, nlev, ng); };

  // --- up pass, surface -> TOA: only the checkpoints are stored
  if (on) {
    T alb = a.alb0[cg], src = a.src0[cg];
    for (int c = nchunk - 1; c >= 0; --c) {
      const Chunk ch = chunk_at(c, nlev);
      ck[(size_t)c * 2 * ng] = alb;
      ck[(size_t)c * 2 * ng + ng] = src;
      T r[kChunk], t[kChunk], su[kChunk], sd[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (k < ch.n) {
          const size_t i = lg(ch.lo + k);
          r[k] = a.refl[i];
          t[k] = a.trans[i];
          su[k] = a.s_up[i];
          sd[k] = a.s_dn[i];
        }
      }
#pragma unroll
      for (int k = kChunk - 1; k >= 0; --k)
        if (k < ch.n) moebius_up(r[k], t[k], su[k], sd[k], alb, src);
    }
    a.src_top[cg] = src;
    if (kPlanes) {
      a.dn_g[hl(0)] = T(0);
      a.up_g[hl(0)] = src;
    }
  }

  // --- down pass, TOA -> surface, chunk by chunk
  T fdn = T(0);
  for (int c = 0; c < nchunk; ++c) {
    const Chunk ch = chunk_at(c, nlev);
    T r[kChunk], t[kChunk], sd[kChunk], ab[kChunk], sb[kChunk], inv[kChunk];
    if (on) {
      T su[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (k < ch.n) {
          const size_t i = lg(ch.lo + k);
          r[k] = a.refl[i];
          t[k] = a.trans[i];
          su[k] = a.s_up[i];
          sd[k] = a.s_dn[i];
        }
      }
      // the up pass again from the checkpoint below the chunk
      T alb = ck[(size_t)c * 2 * ng], src = ck[(size_t)c * 2 * ng + ng];
#pragma unroll
      for (int k = kChunk - 1; k >= 0; --k) {
        if (k < ch.n) {
          ab[k] = alb;
          sb[k] = src;
          inv[k] = moebius_up(r[k], t[k], su[k], sd[k], alb, src);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k < ch.n) {
        T fup = T(0);
        if (on) {
          fdn = (t[k] * fdn + r[k] * sb[k] + sd[k]) * inv[k];
          fup = ab[k] * fdn + sb[k];
          if (kPlanes) {
            a.dn_g[hl(ch.lo + k + 1)] = fdn;
            a.up_g[hl(ch.lo + k + 1)] = fup;
          }
        }
        const int l = ch.lo + k;
        warp_partial(on ? fdn : T(0), part, 2 * l, nwarp);
        warp_partial(fup, part, 2 * l + 1, nwarp);
      }
    }
  }
  if (on) a.fdn_surf[cg] = fdn;
  T *const outs[2] = {a.dn_bb + cl0, a.up_bb + cl0};
  store_level_sums(part, outs, nlev, nwarp);
}

template <typename T>
__device__ __forceinline__ void load_coef(const SwArgs<T> &a, size_t i,
                                          SwCoef<T> &c) {
  c.refl = a.refl[i];
  c.trans = a.trans[i];
  c.rdir = a.rdir[i];
  c.tdd = a.tdd[i];
  c.tdir = a.tdirdir[i];
}

template <typename T, bool kPlanes>
__global__ void sw_kernel(SwArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T *part = reinterpret_cast<T *>(smem_raw);
  const int g = threadIdx.x;
  const bool on = g < a.ng;
  const int nlev = a.nlev, ng = a.ng, nwarp = blockDim.x >> 5;
  const int nchunk = (nlev + kChunk - 1) / kChunk;
  const size_t cl0 = (size_t)blockIdx.x * nlev;
  const size_t cg = (size_t)blockIdx.x * ng + g;
  // this thread's checkpoints: (alb, albd) of chunk c at ck[2c ng], +ng
  T *ck = a.ckpt + (size_t)blockIdx.x * nchunk * 2 * ng + g;
  auto lg = [&](int l) { return (cl0 + l) * (size_t)ng + g; };
  auto hl = [&](int l) { return half_level(l, nlev, ng); };

  // --- up pass, surface -> TOA: the diffuse and direct albedos
  if (on) {
    T alb = a.alb0_dif[cg], albd = a.alb0_dir_x_mu0[cg];
    for (int c = nchunk - 1; c >= 0; --c) {
      const Chunk ch = chunk_at(c, nlev);
      ck[(size_t)c * 2 * ng] = alb;
      ck[(size_t)c * 2 * ng + ng] = albd;
      SwCoef<T> cf[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        if (k < ch.n) load_coef(a, lg(ch.lo + k), cf[k]);
#pragma unroll
      for (int k = kChunk - 1; k >= 0; --k)
        if (k < ch.n) albedo_up(cf[k], alb, albd, alb, albd);
    }
    a.src_top[cg] = albd * a.incoming[cg];
    if (kPlanes) {
      const T incoming = a.incoming[cg];
      a.dir_g[hl(0)] = incoming;
      a.dn_g[hl(0)] = T(0);
      a.up_g[hl(0)] = albd * incoming;
    }
  }

  // --- down pass, TOA -> surface: the direct beam and the diffuse flux.
  // A level's step is affine in the fluxes at its top: fdn' = A fdn + B
  // fdir and fup = Y fdir + alb fdn', with d = 1 - alb refl, A = trans / d,
  // B = (tdir albd refl + tdd) / d and Y = tdir albd from the recompute
  // (diffuse_down in another rounding order), so the level chain holds no
  // division; that measured ~12% faster than diffuse_down (PERF.md).
  T fdir = on ? a.incoming[cg] : T(0), fdn = T(0);
  for (int c = 0; c < nchunk; ++c) {
    const Chunk ch = chunk_at(c, nlev);
    T A[kChunk], B[kChunk], Y[kChunk], ab[kChunk], td[kChunk];
    if (on) {
      SwCoef<T> cf[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        if (k < ch.n) load_coef(a, lg(ch.lo + k), cf[k]);
      T alb = ck[(size_t)c * 2 * ng], albd = ck[(size_t)c * 2 * ng + ng];
#pragma unroll
      for (int k = kChunk - 1; k >= 0; --k) {
        if (k < ch.n) {
          const SwCoef<T> &q = cf[k];
          const T inv = T(1) / (T(1) - alb * q.refl);
          ab[k] = alb;
          td[k] = q.tdir;
          Y[k] = q.tdir * albd;
          A[k] = q.trans * inv;
          B[k] = (Y[k] * q.refl + q.tdd) * inv;
          albedo_up(q, alb, albd, alb, albd);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k < ch.n) {
        T fup = T(0);
        if (on) {
          const T fdir_top = fdir;
          fdir = td[k] * fdir_top;
          fdn = A[k] * fdn + B[k] * fdir_top;
          fup = Y[k] * fdir_top + fdn * ab[k];
          if (kPlanes) {
            const size_t h = hl(ch.lo + k + 1);
            a.dir_g[h] = fdir;
            a.dn_g[h] = fdn;
            a.up_g[h] = fup;
          }
        }
        const int l = ch.lo + k;
        warp_partial(on ? fdir : T(0), part, 3 * l, nwarp);
        warp_partial(on ? fdn : T(0), part, 3 * l + 1, nwarp);
        warp_partial(fup, part, 3 * l + 2, nwarp);
      }
    }
  }
  if (on) {
    a.fdir_surf[cg] = fdir;
    a.fdn_surf[cg] = fdn;
  }
  T *const outs[3] = {a.dir_bb + cl0, a.dn_bb + cl0, a.up_bb + cl0};
  store_level_sums(part, outs, nlev, nwarp);
}

inline int threads_for(int ng) { return ((ng + 31) / 32) * 32; }

// Launch a kernel whose dynamic shared memory holds the warp partials of
// nsums per-level sums; a column too deep for shared memory fails here.
template <typename Kernel, typename Args>
int launch_chunked(Kernel kernel, const Args &a, int ncol, int nsums,
                   size_t elem, void *stream) {
  const int threads = threads_for(a.ng);
  const size_t smem = elem * (size_t)a.nlev * nsums * (threads / 32);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<ncol, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_noscat(void *const *p, int ncol, int nlev, int ng, int planes,
                  void *stream) {
  NoscatArgs<T> a;
  a.trans = (const T *)p[0];
  a.s_up = (const T *)p[1];
  a.s_dn = (const T *)p[2];
  a.emission = (const T *)p[3];
  a.albedo = (const T *)p[4];
  a.dn_bb = (T *)p[5];
  a.fdn_surf = (T *)p[6];
  a.up_bb = (T *)p[7];
  a.fup_toa = (T *)p[8];
  a.fup_surf = (T *)p[9];
  a.dn_g = (T *)p[10];
  a.up_g = (T *)p[11];
  a.nlev = nlev;
  a.ng = ng;
  return planes ? launch_chunked(lw_noscat_kernel<T, true>, a, ncol, 2,
                                 sizeof(T), stream)
                : launch_chunked(lw_noscat_kernel<T, false>, a, ncol, 2,
                                 sizeof(T), stream);
}

template <typename T>
int launch_scat(void *const *p, int ncol, int nlev, int ng, int planes,
                void *stream) {
  ScatArgs<T> a;
  a.refl = (const T *)p[0];
  a.trans = (const T *)p[1];
  a.s_up = (const T *)p[2];
  a.s_dn = (const T *)p[3];
  a.alb0 = (const T *)p[4];
  a.src0 = (const T *)p[5];
  a.dn_bb = (T *)p[6];
  a.up_bb = (T *)p[7];
  a.src_top = (T *)p[8];
  a.fdn_surf = (T *)p[9];
  a.ckpt = (T *)p[10];
  a.dn_g = (T *)p[11];
  a.up_g = (T *)p[12];
  a.nlev = nlev;
  a.ng = ng;
  return planes ? launch_chunked(scat_kernel<T, true>, a, ncol, 2, sizeof(T),
                                 stream)
                : launch_chunked(scat_kernel<T, false>, a, ncol, 2,
                                 sizeof(T), stream);
}

template <typename T>
int launch_sw(void *const *p, int ncol, int nlev, int ng, int planes,
              void *stream) {
  SwArgs<T> a;
  a.refl = (const T *)p[0];
  a.trans = (const T *)p[1];
  a.rdir = (const T *)p[2];
  a.tdd = (const T *)p[3];
  a.tdirdir = (const T *)p[4];
  a.incoming = (const T *)p[5];
  a.alb0_dif = (const T *)p[6];
  a.alb0_dir_x_mu0 = (const T *)p[7];
  a.dir_bb = (T *)p[8];
  a.dn_bb = (T *)p[9];
  a.up_bb = (T *)p[10];
  a.fdir_surf = (T *)p[11];
  a.fdn_surf = (T *)p[12];
  a.src_top = (T *)p[13];
  a.ckpt = (T *)p[14];
  a.dir_g = (T *)p[15];
  a.dn_g = (T *)p[16];
  a.up_g = (T *)p[17];
  a.nlev = nlev;
  a.ng = ng;
  return planes ? launch_chunked(sw_kernel<T, true>, a, ncol, 3, sizeof(T),
                                 stream)
                : launch_chunked(sw_kernel<T, false>, a, ncol, 3, sizeof(T),
                                 stream);
}

}  // namespace

// p: the tensor pointers in the order of the Args struct (inputs, outputs,
// checkpoints, then the per-g planes, null unless planes), as
// solvers/cuda_adding.py passes them; planes selects the build that writes
// them.
extern "C" int ecrad_lw_noscat_sweeps_f32(void *const *p, int ncol, int nlev,
                                          int ng, int planes, void *stream) {
  return launch_noscat<float>(p, ncol, nlev, ng, planes, stream);
}
extern "C" int ecrad_lw_noscat_sweeps_f64(void *const *p, int ncol, int nlev,
                                          int ng, int planes, void *stream) {
  return launch_noscat<double>(p, ncol, nlev, ng, planes, stream);
}
extern "C" int ecrad_scat_sweeps_f32(void *const *p, int ncol, int nlev,
                                     int ng, int planes, void *stream) {
  return launch_scat<float>(p, ncol, nlev, ng, planes, stream);
}
extern "C" int ecrad_scat_sweeps_f64(void *const *p, int ncol, int nlev,
                                     int ng, int planes, void *stream) {
  return launch_scat<double>(p, ncol, nlev, ng, planes, stream);
}
extern "C" int ecrad_sw_sweeps_f32(void *const *p, int ncol, int nlev,
                                   int ng, int planes, void *stream) {
  return launch_sw<float>(p, ncol, nlev, ng, planes, stream);
}
extern "C" int ecrad_sw_sweeps_f64(void *const *p, int ncol, int nlev,
                                   int ng, int planes, void *stream) {
  return launch_sw<double>(p, ncol, nlev, ng, planes, stream);
}
// The levels per checkpoint of scat_sweeps and sw_sweeps: the wrapper
// allocates (ncol, ceil(nlev / chunk), 2, ng) checkpoints.
extern "C" int ecrad_adding_chunk_levels(void) { return kChunk; }
