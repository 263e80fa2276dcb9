// SPARTACUS shortwave adding sweeps: the upward albedo sweep with
// overlap and entrapment mixing, then the downward flux sweep, in one
// kernel.
//
// Replaces the TPU kernels of ecrad_tpu/solvers/pallas_spartacus.py:
// sw_sweeps (_sw_up_kernel, _sw_dn_kernel: two pallas_calls).  Plain
// version and wrapper: ecrad_torch/solvers/cuda_spartacus.py
// (sw_sweeps_plain, sw_sweeps); the step math is that of
// ecrad_torch/solvers/spartacus.py _sw_up_core and _sw_dn_core.
//
// Inputs in the TPU functions' layout: the five region matrices R, T, Rd,
// Tdd, Tdir (nlev, 9, ncol, ng) with entry k = 3*i + j, the five
// clear-sky planes (nlev, ncol, ng), per column and level the overlap
// matrices u and v at the interface above the layer and v at the one
// below (nlev, ncol, 9), 0/1 masks (nlev, ncol, 4) up (clear, clear above,
// migrate, not top) and (nlev, ncol, 2) down (clear, clear below), and the
// 13 entrapment scalars (nlev, ncol, 13): region fractions, edge lengths
// and region fractions of the layer above, its inverse cloud size, the
// overlap parameter to it, and the diffuse and direct migration
// distances.  Up (surface -> TOA): clear-sky scalar adding; 3x3 matrix
// adding with a 3x3 solve, or in a clear layer the region-0 scalar form;
// for Explicit entrapment the migration distances (step_migrations); then
// the mixing of the entrapment mode (Maximum: u X v; Zero: column sums;
// Edge-only, or 3D off: off-diagonal u X v plus the diagonal mixed by v;
// Explicit: that plus two fast_expm_exchange_3 per region), and the
// migration distances carried through v.  Down (TOA -> surface): the
// diffuse and direct fluxes of the three regions through each layer from
// the albedos below it, emitting the region sums of fup, fdn and fdir and
// their clear-sky values at each layer base.
//
// What bounds it on the H100: latency.  A clear layer does little
// arithmetic and waits on its loads; a cloudy one waits on its 3x3 algebra
// and, in Explicit entrapment, its exponentials (PERF.md).  The first is
// cut by moving fewer bytes: most layers are clear (86% of the (column,
// layer) pairs of the bundled meridian slice), and a clear layer's result
// depends on few entries:
// * Up: the scalar form reads R, T, Rd, Tdd, Tdir [0][0] and the carry's
//   [0][0]; step_migrations reads the other diagonal entries only for
//   regions 1 and 2, whose results a select drops there (region 0 fills a
//   clear layer, so its cloud fraction is 0); the mixing reads X, which is
//   zero off [0][0], so Explicit entrapment needs region 0's exponentials
//   only.
// * Down: the scalar form reads R, T [0][0], the carry's [0][0] and
//   ddn_above = Tdir ddn, whose region sum is an output.  ddn enters a
//   clear layer with regions 1 and 2 at 0 (the overlap matrices give them
//   nothing, up to their roundoff of ~1e-16 of the flux), so Tdd [0][1..2]
//   and Tdir [i][1..2] enter only times that 0, but Tdir [1][0] and
//   [2][0] multiply ddn[0] and stay read.
// So a clear layer reads 5 matrix entries up and 6 down instead of 45 and
// 36, and hands 4 scalars (the [0][0] albedos and the clear-sky pair)
// instead of 20 planes from the up sweep to the down sweep, through
// scratch that the wrapper allocates (each thread reads back only its own
// (column, g)).  The entries the kernel skips are 0 in clear layers as the
// layer matrices are built (solvers/spartacus._sw_layer_mats).  The clear
// test is a per-(level, column) mask and a block is one column, so the
// branch never diverges.
// Latency: one block per column with one thread per g-point (at most 128:
// RRTMG's SW has 112) keeps the carry (two albedo matrices, the clear-sky
// pair and six migration distances) in registers and each load contiguous
// over g; in float, 128 registers let 4 blocks share an SM.  The
// per-column data of every level is staged in shared memory before each
// sweep.  The scalars every level reads are copied kAhead levels ahead
// into a ring in shared memory (cp.async), which costs no registers; a
// cloudy level loads the rest of its entries when it starts.  One barrier
// per level keeps the block's warps on the same level, so that their loads
// of a plane go out together: the kernel measured faster with it than
// without (PERF.md).  One block per column covers any ncol.
#include "common.cuh"
#include "matrix3.cuh"

namespace {

using namespace ecrad;

// Entrapment modes (ecrad_torch/config.py Entrapment)
constexpr int kZero = 0, kEdgeOnly = 1, kExplicit = 2, kNonFractal = 3,
              kMaximum = 4;
// per-level values staged in shared memory: up u[9] v[9] msk[4] ent[13],
// down v[9] msk[2]
constexpr int kUp = 35, kDn = 11;
constexpr int kMaxThreads = 128, kMinBlocks = 4;
// the scalars every level reads (UpScalars, DnScalars), copied kAhead
// levels ahead into a ring of kSlots slots of shared memory
constexpr int kUpK = 10, kDnK = 14, kAhead = 3, kSlots = kAhead + 1;

template <typename T> struct SpSwArgs {
  const T *R, *Tm, *Rd, *Tdd, *Tdir;
  const T *rcl, *tcl, *rdcl, *tddcl, *tdircl;
  const T *u9, *v9top, *v9bot, *msk_up, *msk_dn, *ent13;
  const T *alb0, *albd0, *albc0, *albdc0, *ddn0, *incoming;
  T *albd_f, *alb_c_f, *albd_c_f;
  T *fup, *fdn, *fdir, *fup_c, *fdn_c, *fdir_c;
  // scratch: the up sweep's entry carry at each level (only [0][0] of the
  // matrices in a clear layer)
  T *albb, *albdb, *albcb, *albdcb;
  int ncol, nlev, ng, mode, do3d;
  T overhang, cft, max_od;
};

// What every level of the up sweep reads: the [0][0] entries of the five
// layer matrices and the five clear-sky planes.
template <typename T> struct UpScalars {
  T R, Tm, Rd, Tdd, Tdir, rcl, tcl, rdcl, tddcl, tdircl;
};
// ... and of the down sweep: R, T, Tdd [0][0], Tdir [0..2][0], four
// clear-sky planes and the entry carry's scalars.
template <typename T> struct DnScalars {
  T R, Tm, Tdd, Tdir0, Tdir1, Tdir2, rcl, tcl, tddcl, tdircl;
  T alb, albd, alb_c, albd_c;
};

// out[i] = sum_j x[j] v[j][i]
template <typename T>
__device__ __forceinline__ Vec3<T> vmix(const Vec3<T> &x, const Mat3<T> &v) {
  Vec3<T> o;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    o.a[i] = x.a[0] * v.a[0][i] + x.a[1] * v.a[1][i] + x.a[2] * v.a[2][i];
  return o;
}

template <typename T>
__device__ __forceinline__ Mat3<T> diag_embed(const Vec3<T> &d) {
  Mat3<T> m = m3_zero<T>();
#pragma unroll
  for (int r = 0; r < 3; ++r) m.a[r][r] = d.a[r];
  return m;
}

template <typename T>
__device__ __forceinline__ Vec3<T> diag_of(const Mat3<T> &A) {
  Vec3<T> d;
#pragma unroll
  for (int r = 0; r < 3; ++r) d.a[r] = A.a[r][r];
  return d;
}

// x[j] and row j of A for a j only known at run time, by selects, which
// keep x and A in registers.
template <typename T>
__device__ __forceinline__ T pick(const Vec3<T> &x, int j) {
  return j == 0 ? x.a[0] : j == 1 ? x.a[1] : x.a[2];
}

template <typename T>
__device__ __forceinline__ Vec3<T> pick_row(const Mat3<T> &A, int j) {
  Vec3<T> r;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    r.a[k] = j == 0 ? A.a[0][k] : j == 1 ? A.a[1][k] : A.a[2][k];
  return r;
}

// step_migrations (radiation_spartacus_sw.F90:966-1046) of one region
// from its diagonal entries; act false gives 0 (a select).
template <typename T>
__device__ __forceinline__ void step_migration(bool act, T Rdg, T Tdg,
                                               T Rddg, T Tddg, T Tdirg,
                                               T Adg, T Addg, T xld, T xldir,
                                               T &xdif, T &xdir) {
  const T base = T(1) - Rdg * Adg;
  const T ms = Tdg / base;
  const T xe = T(1) / (base * d_sqrt(base));   // base^-1.5
  const T top_alb_dir =
      d_max(Rddg + ms * (Tddg * Adg + Tdirg * Addg), T(1.0e-8));
  const T xdir_new =
      d_max(xldir + ((Tddg * Adg * xe + Tdirg * Addg * (xe - T(1))) *
                         (xdif + xld) +
                     Tdirg * Addg * (xdir + xldir)) *
                        Tdg / top_alb_dir,
            T(0));
  const T top_alb = d_max(Rdg + ms * Tdg * Adg, T(1.0e-8));
  const T xdif_new = xld + xe * Adg * Tdg * Tdg * (xdif + xld) / top_alb;
  xdir = act ? xdir_new : T(0);
  xdif = act ? xdif_new : T(0);
}

// Explicit entrapment of one source region j2 (spartacus._sw_up_core):
// the exchange exponential of the migration distance xj.
template <typename T>
__device__ __forceinline__ Mat3<T> entrap(const SpSwArgs<T> &a, T tr01,
                                          T tr10, T tr12, T tr21, T xj,
                                          T invszp) {
  const T ff = a.mode == kExplicit
                   ? T(1) / d_sqrt(d_max(T(2.5) * xj * invszp, T(1)))
                   : T(1);
  const T e10 = tr01 * xj * ff;
  const T e01 = tr10 * xj * ff;
  const T e21 = tr12 * xj * ff;
  const T e12 = tr21 * xj * ff;
  const T max_entr = -d_min(-e10, -e01 - e21);
  // the reference floors the divisor at 1e-300 (0 in float): a branch
  const T scale = max_entr > a.max_od ? a.max_od / max_entr : T(1);
  return fast_expm_exchange_3(e10 * scale, e01 * scale, e21 * scale,
                              e12 * scale);
}

// Where value k of UpScalars (DnScalars) lies for the level at matrix
// offset m and plane offset v; k is a constant after unrolling.
template <typename T>
__device__ __forceinline__ const T *up_src(const SpSwArgs<T> &a, size_t m,
                                           size_t v, int k) {
  switch (k) {
    case 0: return a.R + m;
    case 1: return a.Tm + m;
    case 2: return a.Rd + m;
    case 3: return a.Tdd + m;
    case 4: return a.Tdir + m;
    case 5: return a.rcl + v;
    case 6: return a.tcl + v;
    case 7: return a.rdcl + v;
    case 8: return a.tddcl + v;
    default: return a.tdircl + v;
  }
}

template <typename T>
__device__ __forceinline__ const T *dn_src(const SpSwArgs<T> &a, size_t m,
                                           size_t v, size_t plane, int k) {
  switch (k) {
    case 0: return a.R + m;
    case 1: return a.Tm + m;
    case 2: return a.Tdd + m;
    case 3: return a.Tdir + m;
    case 4: return a.Tdir + m + 3 * plane;
    case 5: return a.Tdir + m + 6 * plane;
    case 6: return a.rcl + v;
    case 7: return a.tcl + v;
    case 8: return a.tddcl + v;
    case 9: return a.tdircl + v;
    case 10: return a.albb + m;
    case 11: return a.albdb + m;
    case 12: return a.albcb + v;
    default: return a.albdcb + v;
  }
}

// Copy the level's scalars into the ring (none for a level outside the
// column), as one group of cp.async.
template <typename T>
__device__ __forceinline__ void issue_up(const SpSwArgs<T> &a, T *ring,
                                         int l, size_t cg, size_t plane) {
  if (l >= 0) {
    const size_t m = (size_t)l * 9 * plane + cg, v = (size_t)l * plane + cg;
#pragma unroll
    for (int k = 0; k < kUpK; ++k)
      cp_async(ring_at<kUpK, kSlots>(ring, l, k), up_src(a, m, v, k));
  }
  cp_async_commit();
}

template <typename T>
__device__ __forceinline__ void issue_dn(const SpSwArgs<T> &a, T *ring,
                                         int l, size_t cg, size_t plane) {
  if (l < a.nlev) {
    const size_t m = (size_t)l * 9 * plane + cg, v = (size_t)l * plane + cg;
#pragma unroll
    for (int k = 0; k < kDnK; ++k)
      cp_async(ring_at<kDnK, kSlots>(ring, l, k), dn_src(a, m, v, plane, k));
  }
  cp_async_commit();
}

// in float, held to 128 registers so that 4 blocks fit on an SM
template <typename T>
__global__ void __launch_bounds__(kMaxThreads,
                                  sizeof(T) == 4 ? kMinBlocks : 1)
    spartacus_sw_kernel(SpSwArgs<T> a) {
  extern __shared__ unsigned char smem_raw[];
  T *st = reinterpret_cast<T *>(smem_raw);
  T *ring = st + (size_t)a.nlev * kUp;
  const int col = blockIdx.x;
  const int g = threadIdx.x;
  const bool on = g < a.ng;
  const int ncol = a.ncol, nlev = a.nlev, ng = a.ng;
  const size_t cg = (size_t)col * ng + g;
  const size_t plane = (size_t)ncol * ng;      // stride between entries k
  auto lev = [&](int l) { return (size_t)l * plane + cg; };
  auto mat = [&](int l) { return (size_t)l * 9 * plane + cg; };
  const bool explicit_mode = a.mode == kExplicit || a.mode == kNonFractal;

  // --- up sweep, surface -> TOA
  Mat3<T> alb, albd;
  Vec3<T> xdif = {{T(0), T(0), T(0)}}, xdir = {{T(0), T(0), T(0)}};
  T alb_c = T(0), albd_c = T(0);
  if (on) {
    alb = m3_load(a.alb0 + cg, plane);
    albd = m3_load(a.albd0 + cg, plane);
    alb_c = a.albc0[cg];
    albd_c = a.albdc0[cg];
    for (int d = 0; d < kAhead; ++d)
      issue_up(a, ring, nlev - 1 - d, cg, plane);
  }
  const T *const up_cols[4] = {a.u9, a.v9top, a.msk_up, a.ent13};
  const int up_w[4] = {9, 9, 4, 13};
  stage<T, 4>(st, up_cols, up_w, kUp, col, ncol, nlev);
  for (int l = nlev - 1; l >= 0; --l) {
    // keeps the block's warps on one level, so that their loads of a
    // plane arrive together
    __syncthreads();
    if (!on) continue;
    const T *su = st + l * kUp;
    const T *msk = su + 18, *e = su + 22;
    T x[kUpK];
    cp_async_wait<kAhead - 1>();   // level l's copies have landed
#pragma unroll
    for (int k = 0; k < kUpK; ++k) x[k] = *ring_at<kUpK, kSlots>(ring, l, k);
    // into the slot level l + 1 used
    issue_up(a, ring, l - kAhead, cg, plane);
    const UpScalars<T> s = {x[0], x[1], x[2], x[3], x[4],
                            x[5], x[6], x[7], x[8], x[9]};
    const bool cm = msk[0] != T(0);
    const bool above_clear = msk[1] != T(0);
    const bool mm = msk[2] != T(0);
    const bool ntop = msk[3] != T(0);
    const Mat3<T> u = m3_shared(su), v = m3_shared(su + 9);

    // clear-sky scalar adding
    const T inv_d = T(1) / (T(1) - alb_c * s.rcl);
    const T alb_c_new = s.rcl + s.tcl * s.tcl * alb_c * inv_d;
    const T albd_c_new = s.rdcl + (s.tdircl * albd_c + s.tddcl * alb_c) *
                                      s.tcl * inv_d;

    // entry carry: the albedos of the atmosphere below this layer
    a.albcb[lev(l)] = alb_c;
    a.albdcb[lev(l)] = albd_c;
    Mat3<T> X, Xd;
    if (cm) {
      // a clear layer: the region-0 scalar form
      a.albb[mat(l)] = alb.a[0][0];
      a.albdb[mat(l)] = albd.a[0][0];
      const T a00 = alb.a[0][0], ad00 = albd.a[0][0];
      const T inv_s = T(1) / (T(1) - a00 * s.R);
      X = m3_embed00(s.R + s.Tm * s.Tm * a00 * inv_s);
      Xd = m3_embed00(s.Rd + (s.Tdir * ad00 + s.Tdd * a00) * s.Tm * inv_s);
      if (explicit_mode && mm) {
        const T cf = T(1) - e[0];
        step_migration(cf < T(1), s.R, s.Tm, s.Rd, s.Tdd, s.Tdir,
                       alb.a[0][0], albd.a[0][0], e[11], e[12], xdif.a[0],
                       xdir.a[0]);
        // regions 1 and 2, with their zero layer entries: a select
        // drops them, as cf is 0 in a clear layer
#pragma unroll
        for (int r = 1; r < 3; ++r) {
          if (cf > T(0)) {
            step_migration(true, T(0), T(0), T(0), T(0), T(0),
                           alb.a[r][r], albd.a[r][r], e[11], e[12],
                           xdif.a[r], xdir.a[r]);
          } else {
            xdif.a[r] = xdir.a[r] = T(0);
          }
        }
      }
    } else {
      m3_store(alb, a.albb + mat(l), plane);
      m3_store(albd, a.albdb + mat(l), plane);
      const Mat3<T> R = m3_load_rest(s.R, a.R + mat(l), plane);
      const Mat3<T> Tm = m3_load_rest(s.Tm, a.Tm + mat(l), plane);
      const Mat3<T> Rd = m3_load_rest(s.Rd, a.Rd + mat(l), plane);
      const Mat3<T> Tdd = m3_load_rest(s.Tdd, a.Tdd + mat(l), plane);
      const Mat3<T> Tdir = m3_load_rest(s.Tdir, a.Tdir + mat(l), plane);
      const Mat3<T> LU = m3_lu(m3_eye_minus(m3_mul(alb, R)));
      X = m3_add(R, m3_mul(Tm, m3_lu_solve(LU, m3_mul(alb, Tm))));
      const Mat3<T> srcm = m3_add(m3_mul(albd, Tdir), m3_mul(alb, Tdd));
      Xd = m3_add(Rd, m3_mul(Tm, m3_lu_solve(LU, srcm)));
      if (explicit_mode && mm) {
        const T cf = T(1) - e[0];
#pragma unroll
        for (int r = 0; r < 3; ++r)
          step_migration(r == 0 ? cf < T(1) : cf > T(0), R.a[r][r],
                         Tm.a[r][r], Rd.a[r][r], Tdd.a[r][r],
                         Tdir.a[r][r], alb.a[r][r], albd.a[r][r], e[11],
                         e[12], xdif.a[r], xdir.a[r]);
      }
    }

    // overlap / entrapment mixing (radiation_spartacus_sw.F90:510-760)
    Mat3<T> alb_new, albd_new;
    if (cm && above_clear) {
      alb_new = m3_embed00(X.a[0][0]);
      albd_new = m3_embed00(Xd.a[0][0]);
    } else if (a.mode == kMaximum || above_clear) {
      alb_new = m3_mul(m3_mul(u, X), v);
      albd_new = m3_mul(m3_mul(u, Xd), v);
    } else if (a.mode == kZero) {
      Vec3<T> cs, csd;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        cs.a[j] = X.a[0][j] + X.a[1][j] + X.a[2][j];
        csd.a[j] = Xd.a[0][j] + Xd.a[1][j] + Xd.a[2][j];
      }
      alb_new = diag_embed(vmix(cs, v));
      albd_new = diag_embed(vmix(csd, v));
    } else {
      Mat3<T> Xo = X, Xdo = Xd;
#pragma unroll
      for (int r = 0; r < 3; ++r) Xo.a[r][r] = Xdo.a[r][r] = T(0);
      alb_new = m3_mul(m3_mul(u, Xo), v);
      albd_new = m3_mul(m3_mul(u, Xdo), v);
      if (a.mode == kEdgeOnly || !a.do3d) {
        const Vec3<T> d = vmix(diag_of(X), v), dd = vmix(diag_of(Xd), v);
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          alb_new.a[r][r] = alb_new.a[r][r] + d.a[r];
          albd_new.a[r][r] = albd_new.a[r][r] + dd.a[r];
        }
      } else {
        // Explicit entrapment (radiation_spartacus_sw.F90:586-760); in
        // a clear layer X is zero off [0][0], so only region 0 adds
        Mat3<T> acc = m3_zero<T>(), accd = m3_zero<T>();
        const T opp = e[10], invszp = e[9];
        const int nj2 = cm ? 1 : 3;
#pragma unroll 1
        for (int j2 = 0; j2 < nj2; ++j2) {
          T ts = T(1) - (T(1) - a.overhang) * opp * d_min(e[j2], e[6 + j2]) /
                            d_max(e[j2], a.cft);
          if (!ntop) ts = T(0);
          const T tr01 = ts * e[3] / d_max(su[j2], T(1.0e-5));
          const T tr10 = ts * e[3] / d_max(su[3 + j2], T(1.0e-5));
          const T tr12 = ts * e[4] / d_max(su[3 + j2], T(1.0e-5));
          const T tr21 = ts * e[4] / d_max(su[6 + j2], T(1.0e-5));
          const Mat3<T> Pm =
              entrap(a, tr01, tr10, tr12, tr21, pick(xdif, j2), invszp);
          const Mat3<T> Pmd =
              entrap(a, tr01, tr10, tr12, tr21, pick(xdir, j2), invszp);
          const Vec3<T> vrow = pick_row(v, j2);
          const T xjj = pick(diag_of(X), j2), xdjj = pick(diag_of(Xd), j2);
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              acc.a[i][j] = acc.a[i][j] + Pm.a[i][j] * vrow.a[j] * xjj;
              accd.a[i][j] = accd.a[i][j] + Pmd.a[i][j] * vrow.a[j] * xdjj;
            }
        }
        alb_new = m3_add(alb_new, acc);
        albd_new = m3_add(albd_new, accd);
      }
    }

    // migrate the distances through the interface (L758-777)
    if (explicit_mode && !(cm && above_clear)) {
      Vec3<T> xa = xdif, xb = xdir;
      if (cm) xa.a[1] = xa.a[2] = xb.a[1] = xb.a[2] = T(0);
      xdif = vmix(xa, v);
      xdir = vmix(xb, v);
    }
    alb = alb_new;
    albd = albd_new;
    alb_c = alb_c_new;
    albd_c = albd_c_new;
  }
  if (on) {
    m3_store(albd, a.albd_f + cg, plane);
    a.alb_c_f[cg] = alb_c;
    a.albd_c_f[cg] = albd_c;
  }

  // --- down sweep, TOA -> surface
  Vec3<T> fdn = {{T(0), T(0), T(0)}}, ddn = {{T(0), T(0), T(0)}};
  T fdn_c = T(0), ddn_c = T(0);
  if (on) {
#pragma unroll
    for (int r = 0; r < 3; ++r) ddn.a[r] = a.ddn0[r * plane + cg];
    ddn_c = a.incoming[cg];
    cp_async_wait<0>();
    __threadfence_block();   // the up sweep's scratch, read by cp.async
    for (int d = 0; d < kAhead; ++d) issue_dn(a, ring, d, cg, plane);
  }
  const T *const dn_cols[2] = {a.v9bot, a.msk_dn};
  const int dn_w[2] = {9, 2};
  __syncthreads();  // every thread is done with the up sweep's staged data
  stage<T, 2>(st, dn_cols, dn_w, kDn, col, ncol, nlev);
  for (int l = 0; l < nlev; ++l) {
    __syncthreads();   // the block's warps on one level, as up
    if (!on) continue;
    const T *sd = st + l * kDn;
    T x[kDnK];
    cp_async_wait<kAhead - 1>();
#pragma unroll
    for (int k = 0; k < kDnK; ++k) x[k] = *ring_at<kDnK, kSlots>(ring, l, k);
    issue_dn(a, ring, l + kAhead, cg, plane);
    const DnScalars<T> s = {x[0], x[1], x[2],  x[3],  x[4],  x[5],  x[6],
                            x[7], x[8], x[9], x[10], x[11], x[12], x[13]};
    const bool cm = sd[9] != T(0);
    const bool clr_below = sd[10] != T(0);

    // clear-sky scalars
    const T src_c = s.tddcl * ddn_c;
    const T ddn_c2 = s.tdircl * ddn_c;
    const T fdn_c2 = (s.tcl * fdn_c + s.rcl * s.albd_c * ddn_c2 + src_c) /
                     (T(1) - s.rcl * s.alb_c);
    const T fup_c = s.albd_c * ddn_c2 + s.alb_c * fdn_c2;
    Vec3<T> fdn_above, fup_above, ddn_above;
    if (cm) {
      // a clear layer: ddn's regions 1 and 2 are 0 here, so only column
      // 0 of Tdir and Tdd[0][0] act on it
      const T src0 = s.Tdd * ddn.a[0];
      ddn_above = {{s.Tdir0 * ddn.a[0], s.Tdir1 * ddn.a[0],
                    s.Tdir2 * ddn.a[0]}};
      const T f0 = (s.Tm * fdn.a[0] + s.R * s.albd * ddn_above.a[0] + src0) /
                   (T(1) - s.R * s.alb);
      fdn_above = {{f0, T(0), T(0)}};
      fup_above = {{s.albd * ddn_above.a[0] + s.alb * f0, T(0), T(0)}};
    } else {
      const Mat3<T> R = m3_load_rest(s.R, a.R + mat(l), plane);
      const Mat3<T> Tm = m3_load_rest(s.Tm, a.Tm + mat(l), plane);
      const Mat3<T> Tdd = m3_load_rest(s.Tdd, a.Tdd + mat(l), plane);
      const Mat3<T> Tdir = m3_load_rest(s.Tdir0, a.Tdir + mat(l), plane);
      const Mat3<T> alb_n = m3_load_rest(s.alb, a.albb + mat(l), plane);
      const Mat3<T> albd_n = m3_load_rest(s.albd, a.albdb + mat(l), plane);
      const Vec3<T> src = m3_vec(Tdd, ddn);
      ddn_above = m3_vec(Tdir, ddn);
      const Mat3<T> LU = m3_lu(m3_eye_minus(m3_mul(R, alb_n)));
      const Vec3<T> tsrc = m3_vec(albd_n, ddn_above);
      const Vec3<T> rhs =
          v3_add(v3_add(m3_vec(Tm, fdn), m3_vec(R, tsrc)), src);
      fdn_above = m3_lu_sub(LU, rhs);
      fup_above = v3_add(m3_vec(alb_n, fdn_above), tsrc);
    }
    a.fup[lev(l)] = sum3(fup_above);
    a.fdn[lev(l)] = sum3(fdn_above);
    a.fdir[lev(l)] = sum3(ddn_above);
    a.fup_c[lev(l)] = fup_c;
    a.fdn_c[lev(l)] = fdn_c2;
    a.fdir_c[lev(l)] = ddn_c2;
    if (cm && clr_below) {
      fdn = fdn_above;
      ddn = ddn_above;
    } else {
      const Mat3<T> v = m3_shared(sd);
      fdn = m3_vec(v, fdn_above);
      ddn = m3_vec(v, ddn_above);
    }
    fdn_c = fdn_c2;
    ddn_c = ddn_c2;
  }
}

template <typename T>
int launch(void *const *p, int ncol, int nlev, int ng, int mode, int do3d,
           double overhang, double cft, double max_od, void *stream) {
  SpSwArgs<T> a;
  const T **in[] = {&a.R, &a.Tm, &a.Rd, &a.Tdd, &a.Tdir, &a.rcl, &a.tcl,
                    &a.rdcl, &a.tddcl, &a.tdircl, &a.u9, &a.v9top,
                    &a.v9bot, &a.msk_up, &a.msk_dn, &a.ent13, &a.alb0,
                    &a.albd0, &a.albc0, &a.albdc0, &a.ddn0, &a.incoming};
  T **out[] = {&a.albd_f, &a.alb_c_f, &a.albd_c_f, &a.fup, &a.fdn,
               &a.fdir, &a.fup_c, &a.fdn_c, &a.fdir_c, &a.albb, &a.albdb,
               &a.albcb, &a.albdcb};
  int k = 0;
  for (const T **q : in) *q = (const T *)p[k++];
  for (T **q : out) *q = (T *)p[k++];
  a.ncol = ncol;
  a.nlev = nlev;
  a.ng = ng;
  a.mode = mode;
  a.do3d = do3d;
  a.overhang = (T)overhang;
  a.cft = (T)cft;
  a.max_od = (T)max_od;
  const int threads = ((ng + 31) / 32) * 32;
  if (threads > kMaxThreads) return (int)cudaErrorInvalidConfiguration;
  // a whole column's per-level data (137 levels: 19 KB in float, 38 KB in
  // double) and the ring
  const size_t smem =
      ((size_t)nlev * kUp + (size_t)kSlots * kDnK * threads) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spartacus_sw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  spartacus_sw_kernel<T><<<ncol, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// p: the 35 tensor pointers in the order of SpSwArgs.
extern "C" int ecrad_spartacus_sw_f32(void *const *p, int ncol, int nlev,
                                      int ng, int mode, int do3d,
                                      double overhang, double cft,
                                      double max_od, void *stream) {
  return launch<float>(p, ncol, nlev, ng, mode, do3d, overhang, cft, max_od,
                       stream);
}

extern "C" int ecrad_spartacus_sw_f64(void *const *p, int ncol, int nlev,
                                      int ng, int mode, int do3d,
                                      double overhang, double cft,
                                      double max_od, void *stream) {
  return launch<double>(p, ncol, nlev, ng, mode, do3d, overhang, cft,
                        max_od, stream);
}
