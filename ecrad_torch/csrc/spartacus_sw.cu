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
// What bounds it on the H100: the level recurrence and its arithmetic (a
// 3x3 LU, eight to fourteen 3x3 products per level, and for Explicit six
// small matrix exponentials), then the bytes: 50 layer planes read by
// each sweep, 20 written by the up sweep and read back by the down sweep.
// One block per column with one thread per g-point keeps the carry (two
// albedo matrices, the clear-sky pair and six migration distances) in
// registers and the loads of a level contiguous over g; the per-column
// data of a level is staged once in shared memory.  The up-to-down
// hand-off goes through scratch planes that the wrapper allocates, each
// thread reading back only its own (column, g).  One block per column
// covers any ncol.
#include "common.cuh"
#include "matrix3.cuh"

namespace {

using namespace ecrad;

// Entrapment modes (ecrad_torch/config.py Entrapment)
constexpr int kZero = 0, kEdgeOnly = 1, kExplicit = 2, kNonFractal = 3,
              kMaximum = 4;

template <typename T> struct SpSwArgs {
  const T *R, *Tm, *Rd, *Tdd, *Tdir;
  const T *rcl, *tcl, *rdcl, *tddcl, *tdircl;
  const T *u9, *v9top, *v9bot, *msk_up, *msk_dn, *ent13;
  const T *alb0, *albd0, *albc0, *albdc0, *ddn0, *incoming;
  T *albd_f, *alb_c_f, *albd_c_f;
  T *fup, *fdn, *fdir, *fup_c, *fdn_c, *fdir_c;
  // scratch: the up sweep's entry carry at each level
  T *albb, *albdb, *albcb, *albdcb;
  int ncol, nlev, ng, mode, do3d;
  T overhang, cft, max_od;
};

// Per-column data of one level, the same for every g-point.
template <typename T> struct SwUpLevel {
  T u[9], v[9], msk[4], ent[13];
};
template <typename T> struct SwDnLevel {
  T v[9], msk[2];
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

template <typename T>
__global__ void spartacus_sw_kernel(SpSwArgs<T> a) {
  __shared__ SwUpLevel<T> su;
  __shared__ SwDnLevel<T> sd;
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
  }
  for (int l = nlev - 1; l >= 0; --l) {
    const size_t lc = (size_t)l * ncol + col;
    for (int i = threadIdx.x; i < 35; i += blockDim.x) {
      if (i < 9) su.u[i] = a.u9[lc * 9 + i];
      else if (i < 18) su.v[i - 9] = a.v9top[lc * 9 + i - 9];
      else if (i < 22) su.msk[i - 18] = a.msk_up[lc * 4 + i - 18];
      else su.ent[i - 22] = a.ent13[lc * 13 + i - 22];
    }
    __syncthreads();
    if (on) {
      // entry carry: the albedos of the atmosphere below this layer
      m3_store(alb, a.albb + mat(l), plane);
      m3_store(albd, a.albdb + mat(l), plane);
      a.albcb[lev(l)] = alb_c;
      a.albdcb[lev(l)] = albd_c;

      const Mat3<T> R = m3_load(a.R + mat(l), plane);
      const Mat3<T> Tm = m3_load(a.Tm + mat(l), plane);
      const Mat3<T> Rd = m3_load(a.Rd + mat(l), plane);
      const Mat3<T> Tdd = m3_load(a.Tdd + mat(l), plane);
      const Mat3<T> Tdir = m3_load(a.Tdir + mat(l), plane);
      const T rcl = a.rcl[lev(l)], tcl = a.tcl[lev(l)];
      const T rdcl = a.rdcl[lev(l)], tddcl = a.tddcl[lev(l)];
      const T tdircl = a.tdircl[lev(l)];
      const bool cm = su.msk[0] != T(0);
      const bool above_clear = su.msk[1] != T(0);
      const bool mm = su.msk[2] != T(0);
      const bool ntop = su.msk[3] != T(0);
      const T *e = su.ent;
      const Mat3<T> u = m3_shared(su.u), v = m3_shared(su.v);

      // clear-sky scalar adding
      const T inv_d = T(1) / (T(1) - alb_c * rcl);
      const T alb_c_new = rcl + tcl * tcl * alb_c * inv_d;
      const T albd_c_new = rdcl + (tdircl * albd_c + tddcl * alb_c) * tcl *
                                      inv_d;

      // layer adding: the region-0 scalar form in a clear layer
      Mat3<T> X, Xd;
      if (cm) {
        const T a00 = alb.a[0][0], ad00 = albd.a[0][0];
        const T R00 = R.a[0][0], T00 = Tm.a[0][0];
        const T inv_s = T(1) / (T(1) - a00 * R00);
        X = m3_embed00(R00 + T00 * T00 * a00 * inv_s);
        Xd = m3_embed00(Rd.a[0][0] + (Tdir.a[0][0] * ad00 +
                                      Tdd.a[0][0] * a00) * T00 * inv_s);
      } else {
        const Mat3<T> LU = m3_lu(m3_eye_minus(m3_mul(alb, R)));
        X = m3_add(R, m3_mul(Tm, m3_lu_solve(LU, m3_mul(alb, Tm))));
        const Mat3<T> srcm = m3_add(m3_mul(albd, Tdir), m3_mul(alb, Tdd));
        Xd = m3_add(Rd, m3_mul(Tm, m3_lu_solve(LU, srcm)));
      }

      // step_migrations (radiation_spartacus_sw.F90:966-1046)
      if (explicit_mode && mm) {
        const T xld = e[11], xldir = e[12];
        const T cf = T(1) - e[0];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const bool act = r == 0 ? cf < T(1) : cf > T(0);
          const T Rdg = R.a[r][r], Tdg = Tm.a[r][r];
          const T Rddg = Rd.a[r][r], Tddg = Tdd.a[r][r];
          const T Tdirg = Tdir.a[r][r];
          const T Adg = alb.a[r][r], Addg = albd.a[r][r];
          const T ms = Tdg / (T(1) - Rdg * Adg);
          const T xe = d_pow(T(1) - Rdg * Adg, T(-1.5));
          const T top_alb_dir =
              d_max(Rddg + ms * (Tddg * Adg + Tdirg * Addg), T(1.0e-8));
          const T xdir_new = d_max(
              xldir + ((Tddg * Adg * xe + Tdirg * Addg * (xe - T(1))) *
                           (xdif.a[r] + xld) +
                       Tdirg * Addg * (xdir.a[r] + xldir)) *
                          Tdg / top_alb_dir,
              T(0));
          const T top_alb = d_max(Rdg + ms * Tdg * Adg, T(1.0e-8));
          const T xdif_new =
              xld + xe * Adg * Tdg * Tdg * (xdif.a[r] + xld) / top_alb;
          xdir.a[r] = act ? xdir_new : T(0);
          xdif.a[r] = act ? xdif_new : T(0);
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
          // Explicit entrapment (radiation_spartacus_sw.F90:586-760)
          Mat3<T> acc = m3_zero<T>(), accd = m3_zero<T>();
          const T opp = e[10], invszp = e[9];
#pragma unroll 1
          for (int j2 = 0; j2 < 3; ++j2) {
            T ts = T(1) - (T(1) - a.overhang) * opp * d_min(e[j2], e[6 + j2]) /
                              d_max(e[j2], a.cft);
            if (!ntop) ts = T(0);
            const T tr01 = ts * e[3] / d_max(su.u[j2], T(1.0e-5));
            const T tr10 = ts * e[3] / d_max(su.u[3 + j2], T(1.0e-5));
            const T tr12 = ts * e[4] / d_max(su.u[3 + j2], T(1.0e-5));
            const T tr21 = ts * e[4] / d_max(su.u[6 + j2], T(1.0e-5));
            const Mat3<T> Pm =
                entrap(a, tr01, tr10, tr12, tr21, xdif.a[j2], invszp);
            const Mat3<T> Pmd =
                entrap(a, tr01, tr10, tr12, tr21, xdir.a[j2], invszp);
#pragma unroll
            for (int i = 0; i < 3; ++i)
#pragma unroll
              for (int j = 0; j < 3; ++j) {
                acc.a[i][j] = acc.a[i][j] + Pm.a[i][j] * v.a[j2][j] * X.a[j2][j2];
                accd.a[i][j] =
                    accd.a[i][j] + Pmd.a[i][j] * v.a[j2][j] * Xd.a[j2][j2];
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
    __syncthreads();  // every thread has read `su` before the next stage
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
  }
  for (int l = 0; l < nlev; ++l) {
    const size_t lc = (size_t)l * ncol + col;
    for (int i = threadIdx.x; i < 11; i += blockDim.x) {
      if (i < 9) sd.v[i] = a.v9bot[lc * 9 + i];
      else sd.msk[i - 9] = a.msk_dn[lc * 2 + i - 9];
    }
    __syncthreads();
    if (on) {
      const Mat3<T> R = m3_load(a.R + mat(l), plane);
      const Mat3<T> Tm = m3_load(a.Tm + mat(l), plane);
      const Mat3<T> Tdd = m3_load(a.Tdd + mat(l), plane);
      const Mat3<T> Tdir = m3_load(a.Tdir + mat(l), plane);
      const T rcl = a.rcl[lev(l)], tcl = a.tcl[lev(l)];
      const T tddcl = a.tddcl[lev(l)], tdircl = a.tdircl[lev(l)];
      const Mat3<T> alb_n = m3_load(a.albb + mat(l), plane);
      const Mat3<T> albd_n = m3_load(a.albdb + mat(l), plane);
      const T alb_cn = a.albcb[lev(l)], albd_cn = a.albdcb[lev(l)];
      const bool cm = sd.msk[0] != T(0);
      const bool clr_below = sd.msk[1] != T(0);

      const Vec3<T> src = m3_vec(Tdd, ddn);
      const Vec3<T> ddn_above = m3_vec(Tdir, ddn);
      // clear-sky scalars
      const T src_c = tddcl * ddn_c;
      const T ddn_c2 = tdircl * ddn_c;
      const T fdn_c2 = (tcl * fdn_c + rcl * albd_cn * ddn_c2 + src_c) /
                       (T(1) - rcl * alb_cn);
      const T fup_c = albd_cn * ddn_c2 + alb_cn * fdn_c2;
      Vec3<T> fdn_above, fup_above;
      if (cm) {
        const T f0 = (Tm.a[0][0] * fdn.a[0] +
                      R.a[0][0] * albd_n.a[0][0] * ddn_above.a[0] +
                      src.a[0]) /
                     (T(1) - R.a[0][0] * alb_n.a[0][0]);
        fdn_above = {{f0, T(0), T(0)}};
        fup_above = {{albd_n.a[0][0] * ddn_above.a[0] + alb_n.a[0][0] * f0,
                      T(0), T(0)}};
      } else {
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
        const Mat3<T> v = m3_shared(sd.v);
        fdn = m3_vec(v, fdn_above);
        ddn = m3_vec(v, ddn_above);
      }
      fdn_c = fdn_c2;
      ddn_c = ddn_c2;
    }
    __syncthreads();  // every thread has read `sd` before the next stage
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
  spartacus_sw_kernel<T><<<ncol, threads, 0, (cudaStream_t)stream>>>(a);
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
