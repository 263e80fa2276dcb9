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
// What bounds it on the H100: the level recurrence and its 3x3 algebra (a
// LU, up to eight 3x3 products per level), then the bytes: 24 layer planes
// read by each sweep, 14 written by the up sweep and read back by the down
// sweep.  One block per column with one thread per g-point keeps the carry
// (the albedo matrix, the source vector, the clear-sky pair) in registers
// and the loads of a level contiguous over g; the per-column data of a
// level is staged once in shared memory; the up-to-down hand-off goes
// through scratch planes that the wrapper allocates, each thread reading
// back only its own (column, g).  One block per column covers any ncol.
#include "common.cuh"
#include "matrix3.cuh"

namespace {

using namespace ecrad;

template <typename T> struct SpLwArgs {
  const T *R, *Tm, *SU, *SD;
  const T *rcl, *tcl, *sucl, *sdcl;
  const T *u9, *v9top, *v9bot, *msk_up, *msk_dn;
  const T *alb0, *src0, *albc0, *srcc0;
  T *src_f, *src_c_f, *fup, *fdn, *fup_c, *fdn_c;
  // scratch: the up sweep's entry carry at each level
  T *albb, *srcb, *albcb, *srccb;
  int ncol, nlev, ng, multilayer;
};

template <typename T> struct LwLevel {
  T u[9], v[9], msk[2];
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

template <typename T>
__global__ void spartacus_lw_kernel(SpLwArgs<T> a) {
  __shared__ LwLevel<T> s;
  const int col = blockIdx.x;
  const int g = threadIdx.x;
  const bool on = g < a.ng;
  const int ncol = a.ncol, nlev = a.nlev, ng = a.ng;
  const size_t cg = (size_t)col * ng + g;
  const size_t plane = (size_t)ncol * ng;
  auto lev = [&](int l) { return (size_t)l * plane + cg; };
  auto mat = [&](int l) { return (size_t)l * 9 * plane + cg; };
  auto vec = [&](int l) { return (size_t)l * 3 * plane + cg; };

  // --- up sweep, surface -> TOA
  Mat3<T> alb;
  Vec3<T> src;
  T alb_c = T(0), src_c = T(0);
  if (on) {
    alb = m3_load(a.alb0 + cg, plane);
    src = v3_load(a.src0 + cg, plane);
    alb_c = a.albc0[cg];
    src_c = a.srcc0[cg];
  }
  for (int l = nlev - 1; l >= 0; --l) {
    const size_t lc = (size_t)l * ncol + col;
    for (int i = threadIdx.x; i < 20; i += blockDim.x) {
      if (i < 9) s.u[i] = a.u9[lc * 9 + i];
      else if (i < 18) s.v[i - 9] = a.v9top[lc * 9 + i - 9];
      else s.msk[i - 18] = a.msk_up[lc * 2 + i - 18];
    }
    __syncthreads();
    if (on) {
      m3_store(alb, a.albb + mat(l), plane);
      v3_store(src, a.srcb + vec(l), plane);
      a.albcb[lev(l)] = alb_c;
      a.srccb[lev(l)] = src_c;

      const Mat3<T> R = m3_load(a.R + mat(l), plane);
      const Mat3<T> Tm = m3_load(a.Tm + mat(l), plane);
      const Vec3<T> SU = v3_load(a.SU + vec(l), plane);
      const Vec3<T> SD = v3_load(a.SD + vec(l), plane);
      const T rcl = a.rcl[lev(l)], tcl = a.tcl[lev(l)];
      const T sucl = a.sucl[lev(l)], sdcl = a.sdcl[lev(l)];
      const bool cm = s.msk[0] != T(0);
      const bool both_clear = cm && s.msk[1] != T(0);

      // clear-sky scalar adding
      const T inv_d = T(1) / (T(1) - alb_c * rcl);
      const T alb_c_new = rcl + tcl * tcl * alb_c * inv_d;
      const T src_c_new = sucl + tcl * (src_c + alb_c * sdcl) * inv_d;

      Mat3<T> X;
      Vec3<T> S;
      if (cm) {
        const T a00 = alb.a[0][0];
        const T inv_s = T(1) / (T(1) - a00 * R.a[0][0]);
        X = m3_embed00(R.a[0][0] + Tm.a[0][0] * Tm.a[0][0] * a00 * inv_s);
        S = {{SU.a[0] + Tm.a[0][0] * (src.a[0] + a00 * SD.a[0]) * inv_s,
              T(0), T(0)}};
      } else {
        const Mat3<T> LU = m3_lu(m3_eye_minus(m3_mul(alb, R)));
        X = m3_add(R, m3_mul(Tm, m3_lu_solve(LU, m3_mul(alb, Tm))));
        const Vec3<T> rhs = v3_add(src, m3_vec(alb, SD));
        S = v3_add(SU, m3_vec(Tm, m3_lu_sub(LU, rhs)));
      }

      if (both_clear) {
        alb = m3_embed00(X.a[0][0]);
        src = {{S.a[0], T(0), T(0)}};
      } else {
        const Mat3<T> u = m3_shared(s.u), v = m3_shared(s.v);
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
      alb_c = alb_c_new;
      src_c = src_c_new;
    }
    __syncthreads();  // every thread has read `s` before the next stage
  }
  if (on) {
    v3_store(src, a.src_f + cg, plane);
    a.src_c_f[cg] = src_c;
  }

  // --- down sweep, TOA -> surface
  Vec3<T> fdn = {{T(0), T(0), T(0)}};
  T fdn_c = T(0);
  for (int l = 0; l < nlev; ++l) {
    const size_t lc = (size_t)l * ncol + col;
    for (int i = threadIdx.x; i < 11; i += blockDim.x) {
      if (i < 9) s.v[i] = a.v9bot[lc * 9 + i];
      else s.msk[i - 9] = a.msk_dn[lc * 2 + i - 9];
    }
    __syncthreads();
    if (on) {
      const Mat3<T> R = m3_load(a.R + mat(l), plane);
      const Mat3<T> Tm = m3_load(a.Tm + mat(l), plane);
      const Vec3<T> SD = v3_load(a.SD + vec(l), plane);
      const T rcl = a.rcl[lev(l)], tcl = a.tcl[lev(l)];
      const T sdcl = a.sdcl[lev(l)];
      const Mat3<T> alb_n = m3_load(a.albb + mat(l), plane);
      const Vec3<T> src_n = v3_load(a.srcb + vec(l), plane);
      const T alb_cn = a.albcb[lev(l)], src_cn = a.srccb[lev(l)];
      const bool cm = s.msk[0] != T(0);
      const bool clr_below = s.msk[1] != T(0);

      const T fdn_c2 =
          (tcl * fdn_c + rcl * src_cn + sdcl) / (T(1) - rcl * alb_cn);
      const T fup_c = src_cn + alb_cn * fdn_c2;
      Vec3<T> fdn_above, fup_above;
      if (cm) {
        const T f0 = (Tm.a[0][0] * fdn.a[0] + R.a[0][0] * src_n.a[0] +
                      SD.a[0]) /
                     (T(1) - R.a[0][0] * alb_n.a[0][0]);
        fdn_above = {{f0, T(0), T(0)}};
        fup_above = {{src_n.a[0] + alb_n.a[0][0] * f0, T(0), T(0)}};
      } else {
        const Mat3<T> LU = m3_lu(m3_eye_minus(m3_mul(R, alb_n)));
        const Vec3<T> rhs =
            v3_add(v3_add(m3_vec(Tm, fdn), m3_vec(R, src_n)), SD);
        fdn_above = m3_lu_sub(LU, rhs);
        fup_above = v3_add(m3_vec(alb_n, fdn_above), src_n);
      }
      a.fup[lev(l)] = sum3(fup_above);
      a.fdn[lev(l)] = sum3(fdn_above);
      a.fup_c[lev(l)] = fup_c;
      a.fdn_c[lev(l)] = fdn_c2;
      fdn = (cm && clr_below) ? fdn_above : m3_vec(m3_shared(s.v), fdn_above);
      fdn_c = fdn_c2;
    }
    __syncthreads();  // every thread has read `s` before the next stage
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
               &a.albb, &a.srcb, &a.albcb, &a.srccb};
  int k = 0;
  for (const T **q : in) *q = (const T *)p[k++];
  for (T **q : out) *q = (T *)p[k++];
  a.ncol = ncol;
  a.nlev = nlev;
  a.ng = ng;
  a.multilayer = multilayer;
  const int threads = ((ng + 31) / 32) * 32;
  spartacus_lw_kernel<T><<<ncol, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// p: the 27 tensor pointers in the order of SpLwArgs.
extern "C" int ecrad_spartacus_lw_f32(void *const *p, int ncol, int nlev,
                                      int ng, int multilayer, void *stream) {
  return launch<float>(p, ncol, nlev, ng, multilayer, stream);
}

extern "C" int ecrad_spartacus_lw_f64(void *const *p, int ncol, int nlev,
                                      int ng, int multilayer, void *stream) {
  return launch<double>(p, ncol, nlev, ng, multilayer, stream);
}
