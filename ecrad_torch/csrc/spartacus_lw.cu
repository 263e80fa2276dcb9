// SPARTACUS longwave adding sweeps: the upward albedo/source sweep with
// the overlap mixing, then the downward flux sweep, in one kernel.
//
// Replaces the TPU kernels of ecrad_tpu/solvers/pallas_spartacus.py:
// lw_sweeps (_lw_up_kernel, _lw_dn_kernel: two pallas_calls).  Plain
// version and wrapper: ecrad_torch/solvers/cuda_spartacus.py
// (lw_sweeps_plain, lw_sweeps); the step math is that of
// ecrad_torch/solvers/spartacus.py _lw_up_core and _lw_dn_core.
//
// Inputs in the TPU functions' layout: the region matrices R, T (nlev, 9,
// ncol, ng) with entry k = 3*i + j, the region sources SU, SD (nlev, 3,
// ncol, ng), the four clear-sky planes (nlev, ncol, ng), per column and
// level u and v at the interface above the layer and v at the one below
// (nlev, ncol, 9), and 0/1 masks (nlev, ncol, 2): (clear, clear above) up,
// (clear, clear below) down.  Up (surface -> TOA): clear-sky scalar
// adding; 3x3 matrix adding with a 3x3 solve for albedo and source, or in
// a clear layer the region-0 scalar form; the source mixed with u, the
// albedo with u X v (multilayer 3D) or with the diagonal mixed by v.
// Down (TOA -> surface): the region fluxes through each layer from the
// albedo and source below it, emitting the region sums of fup and fdn and
// their clear-sky values at each layer base.
//
// What bounds it on the H100: the memory system.  Every level reads layer
// planes and hands the up sweep's entry carry to the down sweep through
// scratch, a column's share of a plane is one row of ng values, and the
// 3x3 algebra of a cloudy level waits on all of its loads.  So the design
// moves fewer bytes, in longer runs:
// * Most layers are clear (86% of the (column, layer) pairs of the bundled
//   meridian slice), and a clear layer's result depends on few entries
//   (_lw_up_core and _lw_dn_core):
//   - Up: the region-0 scalar form reads R[0][0], T[0][0], SU[0], SD[0] and
//     the carry's alb[0][0] and src[0]; the mixing reads X and S, which are
//     zero off [0][0] and [0].
//   - Down: the scalar form reads T[0][0], R[0][0], SD[0], the carry's
//     alb[0][0] and src[0] and fdn[0], and the fluxes above it are zero in
//     regions 1 and 2.
//   So a clear layer loads 4 matrix entries (cuda_spartacus.
//   LW_CLEAR_ENTRIES) instead of 24 up and 21 down, and hands 4 scalars
//   (alb[0][0], src[0] and the clear-sky pair) instead of 14 to the down
//   sweep.  What the up sweep stores follows the down sweep's clear mask,
//   which decides what is read back.  The entries skipped are 0 in clear
//   layers as the layer matrices are built (solvers/spartacus.
//   _lw_layer_mats).  The masks are per (level, column) and a block is one
//   column, so the branches never diverge.
// * The hand-off scratch (the wrapper allocates it) is (ncol, nlev, 14,
//   ng): a column's entries of one level are adjacent rows of g, the 4 a
//   clear level uses first.  That measured ~5% faster than 14 planes laid
//   out like the layer matrices (PERF.md).
// * One block per column with one thread per g-point keeps the carry (the
//   albedo matrix, the source vector, the clear-sky pair) in registers and
//   each load contiguous over g, and covers any ncol.  The column's u, v
//   and masks are staged in shared memory once, before the up sweep.  The
//   scalars every level reads are copied kAhead levels ahead into a ring
//   in shared memory (cp.async), which costs no registers; a cloudy level
//   loads its other entries when it starts.
// * One barrier per level keeps the block's warps on the same level, so
//   that their loads of a level's rows go out together.  Without it the
//   kernel measured 31-35% slower on the meridian-based inputs and 39-44%
//   slower with every layer cloudy, and prefetching a cloudy next level
//   into L2 slower still (PERF.md).
#include "common.cuh"
#include "matrix3.cuh"

namespace {

using namespace ecrad;

// per-level values staged in shared memory: u[9], v above [9], v below
// [9], the up masks [2] and the down masks [2]
constexpr int kLev = 31;
constexpr int kV = 9, kVBot = 18, kMskUp = 27, kMskDn = 29;
// the scalars every level reads (UpScalars, DnScalars), copied kAhead
// levels ahead into a ring of kSlots slots of shared memory
constexpr int kUpK = 8, kDnK = 10, kAhead = 2, kSlots = kAhead + 1;
// the hand-off of one (column, level), kHand rows of ng values: alb_c,
// src_c, alb[0][0], src[0], then alb's entry k = 1..8 at row kAlbRest + k
// and src's entry k = 1..2 at row kSrcRest + k
constexpr int kHand = 14, kAlbC = 0, kSrcC = 1, kAlb0 = 2, kSrc0 = 3;
constexpr int kAlbRest = kSrc0, kSrcRest = kAlbRest + 8;

template <typename T> struct SpLwArgs {
  const T *R, *Tm, *SU, *SD;
  const T *rcl, *tcl, *sucl, *sdcl;
  const T *u9, *v9top, *v9bot, *msk_up, *msk_dn;
  const T *alb0, *src0, *albc0, *srcc0;
  T *src_f, *src_c_f, *fup, *fdn, *fup_c, *fdn_c;
  // scratch (ncol, nlev, kHand, ng): the up sweep's entry carry at each
  // level (alb[0][0] and src[0] only of the matrices where the down sweep
  // sees a clear layer)
  T *hand;
  int ncol, nlev, ng, multilayer;
};

// What every level of the up sweep reads: R, T [0][0], SU, SD [0] and the
// four clear-sky planes.
template <typename T> struct UpScalars {
  T R, Tm, SU, SD, rcl, tcl, sucl, sdcl;
};
// ... and of the down sweep: R, T [0][0], SD [0], three clear-sky planes
// and the entry carry's scalars.
template <typename T> struct DnScalars {
  T R, Tm, SD, rcl, tcl, sdcl, alb, src, alb_c, src_c;
};

template <typename T>
__device__ __forceinline__ Vec3<T> v3_load(const T *p, size_t stride) {
  Vec3<T> x;
#pragma unroll
  for (int r = 0; r < 3; ++r) x.a[r] = p[r * stride];
  return x;
}

template <typename T>
__device__ __forceinline__ void v3_store(const Vec3<T> &x, T *p,
                                         size_t stride) {
#pragma unroll
  for (int r = 0; r < 3; ++r) p[r * stride] = x.a[r];
}

// A vector of the stacked layout whose [0] is already in a register.
template <typename T>
__device__ __forceinline__ Vec3<T> v3_load_rest(T a0, const T *p,
                                                size_t stride) {
  return {{a0, p[stride], p[2 * stride]}};
}

// Offsets of level l's entries for the thread of (column, g) cg.
struct Offsets {
  size_t m, v3, v;   // entry 0 of a 9-, a 3-entry matrix, a plane
};
__device__ __forceinline__ Offsets offsets(int l, size_t cg, size_t plane) {
  return {(size_t)l * 9 * plane + cg, (size_t)l * 3 * plane + cg,
          (size_t)l * plane + cg};
}

// Copy level l's scalars into the ring as one group of cp.async (an empty
// group for a level outside the column).
template <typename T>
__device__ __forceinline__ void issue_up(const SpLwArgs<T> &a, T *ring,
                                         int l, size_t cg, size_t plane) {
  if (l >= 0) {
    const Offsets o = offsets(l, cg, plane);
    const T *src[kUpK] = {a.R + o.m,   a.Tm + o.m,  a.SU + o.v3,
                          a.SD + o.v3, a.rcl + o.v, a.tcl + o.v,
                          a.sucl + o.v, a.sdcl + o.v};
#pragma unroll
    for (int k = 0; k < kUpK; ++k)
      cp_async(ring_at<kUpK, kSlots>(ring, l, k), src[k]);
  }
  cp_async_commit();
}

// ... of the down sweep, whose hand-off of level l begins at h.
template <typename T>
__device__ __forceinline__ void issue_dn(const SpLwArgs<T> &a, T *ring,
                                         int l, size_t cg, size_t plane,
                                         const T *h) {
  if (l < a.nlev) {
    const Offsets o = offsets(l, cg, plane);
    const size_t ng = a.ng;
    const T *src[kDnK] = {a.R + o.m,        a.Tm + o.m,       a.SD + o.v3,
                          a.rcl + o.v,      a.tcl + o.v,      a.sdcl + o.v,
                          h + kAlb0 * ng,   h + kSrc0 * ng,   h + kAlbC * ng,
                          h + kSrcC * ng};
#pragma unroll
    for (int k = 0; k < kDnK; ++k)
      cp_async(ring_at<kDnK, kSlots>(ring, l, k), src[k]);
  }
  cp_async_commit();
}

template <typename T>
__global__ void spartacus_lw_kernel(SpLwArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T *st = reinterpret_cast<T *>(smem_raw);
  T *ring = st + (size_t)a.nlev * kLev;
  const int col = blockIdx.x;
  const int g = threadIdx.x;
  const int ncol = a.ncol, nlev = a.nlev, ng = a.ng;
  const T *const cols[5] = {a.u9, a.v9top, a.v9bot, a.msk_up, a.msk_dn};
  const int widths[5] = {9, 9, 9, 2, 2};
  stage<T, 5>(st, cols, widths, kLev, col, ncol, nlev);
  const bool on = g < ng;

  const size_t cg = (size_t)col * ng + g;
  const size_t plane = (size_t)ncol * ng;   // stride between entries k
  auto clear_up = [&](int l) { return st[l * kLev + kMskUp] != T(0); };
  auto clear_dn = [&](int l) { return st[l * kLev + kMskDn] != T(0); };
  // level l's hand-off
  auto hand = [&](int l) {
    return a.hand + ((size_t)col * nlev + l) * kHand * ng + g;
  };

  // --- up sweep, surface -> TOA
  Mat3<T> alb;
  Vec3<T> src;
  T alb_c = T(0), src_c = T(0);
  if (on) {
    alb = m3_load(a.alb0 + cg, plane);
    src = v3_load(a.src0 + cg, plane);
    alb_c = a.albc0[cg];
    src_c = a.srcc0[cg];
    for (int d = 0; d < kAhead; ++d)
      issue_up(a, ring, nlev - 1 - d, cg, plane);
  }
  for (int l = nlev - 1; l >= 0; --l) {
    // keeps the block's warps on one level, so that their loads of a
    // plane go out together
    __syncthreads();
    if (!on) continue;
    cp_async_wait<kAhead - 1>();   // level l's copies have landed
    T x[kUpK];
#pragma unroll
    for (int k = 0; k < kUpK; ++k) x[k] = *ring_at<kUpK, kSlots>(ring, l, k);
    issue_up(a, ring, l - kAhead, cg, plane);   // into level l + 1's slot
    const UpScalars<T> s = {x[0], x[1], x[2], x[3], x[4], x[5], x[6], x[7]};
    const Offsets o = offsets(l, cg, plane);
    const T *sl = st + l * kLev;
    const bool cm = clear_up(l);
    const bool both_clear = cm && sl[kMskUp + 1] != T(0);

    // the entry carry, as the down sweep reads it back
    T *h = hand(l);
    h[kAlbC * ng] = alb_c;
    h[kSrcC * ng] = src_c;
    h[kAlb0 * ng] = alb.a[0][0];
    h[kSrc0 * ng] = src.a[0];
    if (!clear_dn(l)) {
#pragma unroll
      for (int k = 1; k < 9; ++k)
        h[(kAlbRest + k) * ng] = alb.a[k / 3][k % 3];
      h[(kSrcRest + 1) * ng] = src.a[1];
      h[(kSrcRest + 2) * ng] = src.a[2];
    }

    // clear-sky scalar adding
    const T inv_d = T(1) / (T(1) - alb_c * s.rcl);
    const T alb_c_new = s.rcl + s.tcl * s.tcl * alb_c * inv_d;
    src_c = s.sucl + s.tcl * (src_c + alb_c * s.sdcl) * inv_d;
    alb_c = alb_c_new;

    Mat3<T> X;
    Vec3<T> S;
    if (cm) {
      // a clear layer: the region-0 scalar form
      const T a00 = alb.a[0][0];
      const T inv_s = T(1) / (T(1) - a00 * s.R);
      X = m3_embed00(s.R + s.Tm * s.Tm * a00 * inv_s);
      S = {{s.SU + s.Tm * (src.a[0] + a00 * s.SD) * inv_s, T(0), T(0)}};
    } else {
      const Mat3<T> R = m3_load_rest(s.R, a.R + o.m, plane);
      const Mat3<T> Tm = m3_load_rest(s.Tm, a.Tm + o.m, plane);
      const Vec3<T> SU = v3_load_rest(s.SU, a.SU + o.v3, plane);
      const Vec3<T> SD = v3_load_rest(s.SD, a.SD + o.v3, plane);
      const Mat3<T> LU = m3_lu(m3_eye_minus(m3_mul(alb, R)));
      X = m3_add(R, m3_mul(Tm, m3_lu_solve(LU, m3_mul(alb, Tm))));
      const Vec3<T> rhs = v3_add(src, m3_vec(alb, SD));
      S = v3_add(SU, m3_vec(Tm, m3_lu_sub(LU, rhs)));
    }

    // overlap mixing (radiation_spartacus_lw.F90:485-508)
    if (both_clear) {
      alb = m3_embed00(X.a[0][0]);
      src = {{S.a[0], T(0), T(0)}};
    } else {
      const Mat3<T> u = m3_shared(sl), v = m3_shared(sl + kV);
      src = m3_vec(u, S);
      if (a.multilayer) {
        alb = m3_mul(m3_mul(u, X), v);
      } else {
        alb = m3_zero<T>();
#pragma unroll
        for (int i = 0; i < 3; ++i)
          alb.a[i][i] = X.a[0][0] * v.a[0][i] + X.a[1][1] * v.a[1][i] +
                        X.a[2][2] * v.a[2][i];
      }
    }
  }
  if (on) {
    v3_store(src, a.src_f + cg, plane);
    a.src_c_f[cg] = src_c;
    cp_async_wait<0>();
    __threadfence_block();   // the up sweep's scratch, read by cp.async
    for (int d = 0; d < kAhead; ++d)
      issue_dn(a, ring, d, cg, plane, hand(d));
  }

  // --- down sweep, TOA -> surface
  Vec3<T> fdn = {{T(0), T(0), T(0)}};
  T fdn_c = T(0);
  for (int l = 0; l < nlev; ++l) {
    __syncthreads();   // the block's warps on one level, as up
    if (!on) continue;
    cp_async_wait<kAhead - 1>();
    T x[kDnK];
#pragma unroll
    for (int k = 0; k < kDnK; ++k) x[k] = *ring_at<kDnK, kSlots>(ring, l, k);
    issue_dn(a, ring, l + kAhead, cg, plane, hand(l + kAhead));
    const DnScalars<T> s = {x[0], x[1], x[2], x[3], x[4],
                            x[5], x[6], x[7], x[8], x[9]};
    const Offsets o = offsets(l, cg, plane);
    const T *sl = st + l * kLev;
    const bool cm = clear_dn(l);
    const bool clr_below = sl[kMskDn + 1] != T(0);

    const T fdn_c2 = (s.tcl * fdn_c + s.rcl * s.src_c + s.sdcl) /
                     (T(1) - s.rcl * s.alb_c);
    const T fup_c = s.src_c + s.alb_c * fdn_c2;
    Vec3<T> fdn_above, fup_above;
    if (cm) {
      // a clear layer: the region-0 scalar form
      const T f0 = (s.Tm * fdn.a[0] + s.R * s.src + s.SD) /
                   (T(1) - s.R * s.alb);
      fdn_above = {{f0, T(0), T(0)}};
      fup_above = {{s.src + s.alb * f0, T(0), T(0)}};
    } else {
      const Mat3<T> R = m3_load_rest(s.R, a.R + o.m, plane);
      const Mat3<T> Tm = m3_load_rest(s.Tm, a.Tm + o.m, plane);
      const Vec3<T> SD = v3_load_rest(s.SD, a.SD + o.v3, plane);
      const T *h = hand(l);
      const Mat3<T> alb_n =
          m3_load_rest(s.alb, h + kAlbRest * ng, (size_t)ng);
      const Vec3<T> src_n =
          v3_load_rest(s.src, h + kSrcRest * ng, (size_t)ng);
      const Mat3<T> LU = m3_lu(m3_eye_minus(m3_mul(R, alb_n)));
      const Vec3<T> rhs =
          v3_add(v3_add(m3_vec(Tm, fdn), m3_vec(R, src_n)), SD);
      fdn_above = m3_lu_sub(LU, rhs);
      fup_above = v3_add(m3_vec(alb_n, fdn_above), src_n);
    }
    a.fup[o.v] = sum3(fup_above);
    a.fdn[o.v] = sum3(fdn_above);
    a.fup_c[o.v] = fup_c;
    a.fdn_c[o.v] = fdn_c2;
    fdn = (cm && clr_below) ? fdn_above
                            : m3_vec(m3_shared(sl + kVBot), fdn_above);
    fdn_c = fdn_c2;
  }
}

template <typename T>
int launch(void *const *p, int ncol, int nlev, int ng, int multilayer,
           void *stream) {
  SpLwArgs<T> a;
  const T **in[] = {&a.R, &a.Tm, &a.SU, &a.SD, &a.rcl, &a.tcl, &a.sucl,
                    &a.sdcl, &a.u9, &a.v9top, &a.v9bot, &a.msk_up,
                    &a.msk_dn, &a.alb0, &a.src0, &a.albc0, &a.srcc0};
  T **out[] = {&a.src_f, &a.src_c_f, &a.fup, &a.fdn, &a.fup_c, &a.fdn_c,
               &a.hand};
  int k = 0;
  for (const T **q : in) *q = (const T *)p[k++];
  for (T **q : out) *q = (T *)p[k++];
  a.ncol = ncol;
  a.nlev = nlev;
  a.ng = ng;
  a.multilayer = multilayer;
  const int threads = ((ng + 31) / 32) * 32;
  // the whole column's per-level data and the ring (137 levels and 140
  // g-points: 36 KB in float, 72 KB in double)
  const size_t smem =
      ((size_t)nlev * kLev + (size_t)kSlots * kDnK * threads) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spartacus_lw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  spartacus_lw_kernel<T><<<ncol, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// p: the 24 tensor pointers in the order of SpLwArgs.
extern "C" int ecrad_spartacus_lw_f32(void *const *p, int ncol, int nlev,
                                      int ng, int multilayer, void *stream) {
  return launch<float>(p, ncol, nlev, ng, multilayer, stream);
}

extern "C" int ecrad_spartacus_lw_f64(void *const *p, int ncol, int nlev,
                                      int ng, int multilayer, void *stream) {
  return launch<double>(p, ncol, nlev, ng, multilayer, stream);
}
