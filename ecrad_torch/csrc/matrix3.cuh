// 3x3 region algebra of the SPARTACUS sweep kernels, one matrix per
// thread in registers.  Each function does the arithmetic of its plain
// version in ecrad_torch/solvers/matrix.py entry by entry, in the same
// order (sums left to right, LU without pivoting), so the kernels and the
// plain sweeps differ only by the compiler's fused multiply-adds.
#pragma once

#include "common.cuh"

namespace ecrad {

template <typename T> struct Mat3 {
  T a[3][3];
};
template <typename T> struct Vec3 {
  T a[3];
};

template <typename T> __device__ __forceinline__ Mat3<T> m3_zero() {
  Mat3<T> z;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) z.a[i][j] = T(0);
  return z;
}

// A with only [0][0] = x (the clear-layer branch)
template <typename T> __device__ __forceinline__ Mat3<T> m3_embed00(T x) {
  Mat3<T> z = m3_zero<T>();
  z.a[0][0] = x;
  return z;
}

// Load a stacked matrix: entry k = 3*i + j at p[k * stride].
template <typename T>
__device__ __forceinline__ Mat3<T> m3_load(const T *p, size_t stride) {
  Mat3<T> m;
#pragma unroll
  for (int k = 0; k < 9; ++k) m.a[k / 3][k % 3] = p[k * stride];
  return m;
}

template <typename T>
__device__ __forceinline__ void m3_store(const Mat3<T> &m, T *p,
                                         size_t stride) {
#pragma unroll
  for (int k = 0; k < 9; ++k) p[k * stride] = m.a[k / 3][k % 3];
}

// Load a per-column 3x3 matrix staged in shared memory as 9 values.
template <typename T>
__device__ __forceinline__ Mat3<T> m3_shared(const T *s) {
  Mat3<T> m;
#pragma unroll
  for (int k = 0; k < 9; ++k) m.a[k / 3][k % 3] = s[k];
  return m;
}

// A matrix of the stacked layout whose [0][0] is already in a register:
// loads the other eight entries.
template <typename T>
__device__ __forceinline__ Mat3<T> m3_load_rest(T a00, const T *p,
                                                size_t stride) {
  Mat3<T> m;
  m.a[0][0] = a00;
#pragma unroll
  for (int k = 1; k < 9; ++k) m.a[k / 3][k % 3] = p[k * stride];
  return m;
}

// Stage one column's per-level data, K values per level gathered from the
// (nlev, ncol, k) arrays src[] of widths w[] of the SPARTACUS sweeps, and
// wait for every thread's share.
template <typename T, int N>
__device__ __forceinline__ void stage(T *st, const T *const (&src)[N],
                                      const int (&w)[N], int K, int col,
                                      int ncol, int nlev) {
  for (int i = threadIdx.x; i < nlev * K; i += blockDim.x) {
    const int l = i / K;
    int k = i % K, s = 0;
    while (k >= w[s]) k -= w[s++];
    st[i] = src[s][((size_t)l * ncol + col) * w[s] + k];
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ Mat3<T> m3_mul(const Mat3<T> &A,
                                          const Mat3<T> &B) {
  Mat3<T> C;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T c = A.a[i][0] * B.a[0][j];
      c = c + A.a[i][1] * B.a[1][j];
      c = c + A.a[i][2] * B.a[2][j];
      C.a[i][j] = c;
    }
  return C;
}

template <typename T>
__device__ __forceinline__ Vec3<T> m3_vec(const Mat3<T> &A,
                                          const Vec3<T> &x) {
  Vec3<T> y;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T c = A.a[i][0] * x.a[0];
    c = c + A.a[i][1] * x.a[1];
    c = c + A.a[i][2] * x.a[2];
    y.a[i] = c;
  }
  return y;
}

template <typename T>
__device__ __forceinline__ Mat3<T> m3_add(const Mat3<T> &A,
                                          const Mat3<T> &B) {
  Mat3<T> C;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) C.a[i][j] = A.a[i][j] + B.a[i][j];
  return C;
}

template <typename T>
__device__ __forceinline__ Vec3<T> v3_add(const Vec3<T> &a,
                                          const Vec3<T> &b) {
  Vec3<T> c;
#pragma unroll
  for (int i = 0; i < 3; ++i) c.a[i] = a.a[i] + b.a[i];
  return c;
}

// I - A
template <typename T>
__device__ __forceinline__ Mat3<T> m3_eye_minus(const Mat3<T> &A) {
  Mat3<T> C;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) C.a[i][j] = (i == j ? T(1) : T(0)) - A.a[i][j];
  return C;
}

// LU without pivoting, packed (matrix._pl_lu)
template <typename T> __device__ __forceinline__ Mat3<T> m3_lu(Mat3<T> L) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const T inv_diag = T(1) / L.a[k][k];
#pragma unroll
    for (int i = k + 1; i < 3; ++i) L.a[i][k] = L.a[i][k] * inv_diag;
#pragma unroll
    for (int i = k + 1; i < 3; ++i)
#pragma unroll
      for (int j = k + 1; j < 3; ++j)
        L.a[i][j] = L.a[i][j] - L.a[i][k] * L.a[k][j];
  }
  return L;
}

// Forward/back substitution (matrix._lu_sub)
template <typename T>
__device__ __forceinline__ Vec3<T> m3_lu_sub(const Mat3<T> &L, Vec3<T> y) {
  y.a[1] = y.a[1] - L.a[1][0] * y.a[0];
  y.a[2] = y.a[2] - L.a[2][0] * y.a[0];
  y.a[2] = y.a[2] - L.a[2][1] * y.a[1];
  Vec3<T> x;
  x.a[2] = y.a[2] / L.a[2][2];
  x.a[1] = (y.a[1] - L.a[1][2] * x.a[2]) / L.a[1][1];
  x.a[0] = ((y.a[0] - L.a[0][1] * x.a[1]) - L.a[0][2] * x.a[2]) / L.a[0][0];
  return x;
}

// X = A^-1 B, column by column, from the packed LU of A
template <typename T>
__device__ __forceinline__ Mat3<T> m3_lu_solve(const Mat3<T> &LU,
                                               const Mat3<T> &B) {
  Mat3<T> X;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    Vec3<T> b;
#pragma unroll
    for (int i = 0; i < 3; ++i) b.a[i] = B.a[i][j];
    const Vec3<T> x = m3_lu_sub(LU, b);
#pragma unroll
    for (int i = 0; i < 3; ++i) X.a[i][j] = x.a[i];
  }
  return X;
}

template <typename T> __device__ __forceinline__ T sum3(const Vec3<T> &x) {
  return x.a[0] + x.a[1] + x.a[2];
}

// (e^x - 1)/x (matrix._phi1): series below |x| < 0.1, exp form above
template <typename T> __device__ __forceinline__ T phi1(T x) {
  if (d_abs(x) < T(0.1))
    return T(1) + x / T(2) * (T(1) + x / T(3) * (T(1) + x / T(4) * (
        T(1) + x / T(5) * (T(1) + x / T(6)))));
  return (d_exp(x) - T(1)) / x;
}

// expm of the conservative-exchange generator (-a b 0; a -b-c d; 0 c -d)
// by Putzer's algorithm (matrix.pl_fast_expm_exchange_3)
template <typename T>
__device__ __forceinline__ Mat3<T> fast_expm_exchange_3(T a, T b, T c,
                                                        T d) {
  const T tmp1 = T(0.5) * (a + b + c + d);
  const T disc = d_max(tmp1 * tmp1 - (a * c + a * d + b * d), T(0));
  const T tmp2 = d_sqrt(disc);
  const T lam1 = -tmp1 + tmp2;
  const T lam2 = -tmp1 - tmp2;
  T sinh_over;
  if (tmp2 < T(1e-3)) {
    const T h2 = tmp2 * tmp2;
    sinh_over = T(1) + h2 / T(6) * (T(1) + h2 / T(20));
  } else {
    const T ex = d_exp(tmp2);
    sinh_over = (ex - T(1) / ex) * T(0.5) / tmp2;
  }
  const T dd1_12 = d_exp(-tmp1) * sinh_over;
  const T p1 = phi1(lam1);
  T dd2;
  if (d_abs(lam2) < T(1e-3)) {
    dd2 = T(0.5) + (lam1 + lam2) / T(6) +
          (lam1 * lam1 + lam1 * lam2 + lam2 * lam2) / T(24);
  } else {
    dd2 = (dd1_12 - p1) / lam2;
  }
  Mat3<T> M;
  M.a[0][0] = -a; M.a[0][1] = b;      M.a[0][2] = T(0);
  M.a[1][0] = a;  M.a[1][1] = -b - c; M.a[1][2] = d;
  M.a[2][0] = T(0); M.a[2][1] = c;    M.a[2][2] = -d;
  Mat3<T> Ms = M;
#pragma unroll
  for (int i = 0; i < 3; ++i) Ms.a[i][i] = M.a[i][i] - lam1;
  const Mat3<T> MM = m3_mul(M, Ms);
  Mat3<T> E;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      E.a[i][j] = (i == j ? T(1) : T(0)) + p1 * M.a[i][j] + dd2 * MM.a[i][j];
  return E;
}

}  // namespace ecrad
