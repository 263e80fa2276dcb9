// SPARTACUS layer matrices: per (column, layer, g-point) element, the three
// regions' optics and two-stream coefficients and, where the element's
// use_expm flag is set, the 3D refinement by a matrix exponential; one
// launch set per band set.
//
// Replaces no TPU kernel: the JAX package leaves this stage to XLA
// (ecrad_tpu/solvers/spartacus.py maps the layer-matrix build over levels,
// with a lax.cond per level, and has no pallas_call for it).  It was added
// because the plain torch build (ecrad_torch/solvers/spartacus.py
// _sw_layer_mats, _lw_layer_mats: elementwise planes over every element, the
// refinement over gathered chunks with a host read of the active count and
// of each chunk's squaring count) held the card for ~55-60 ms per 1000
// columns in the SPARTACUS cell, over 100 times the bytes it moves.  Wrappers:
// ecrad_torch/solvers/cuda_spartacus.py sw_layer_mats, lw_layer_mats; their
// plain versions are _sw_layer_mats and _lw_layer_mats, which run on the CPU.
//
// Inputs: the band set's raw optics (Optics below: the gas od, ssa, g in
// SPARTACUS g order, the band cloud properties, the g-points' bands, the
// cloudy regions' od scaling, max_cloud_od), from which each pass makes the
// region optics in registers (region_optics, spartacus._region_optics op
// for op), so no per-element region tensor exists.  Outputs in the sweeps'
// layout: SW R, T, Rd, Tdd, Tdir (nlev, 9, ncol, ng), entry k = 3*i + j; LW
// R, T (nlev, 9, ncol, ng) and the region-fraction scaled sources SU, SD
// (nlev, 3, ncol, ng); and the clear-sky planes the sweeps read beside
// them, (nlev, ncol, ng) each: SW the five sw_ref_trans coefficients of the
// gas, LW lw_ref_trans' four of the gas with the unscaled Planck terms.
// Every entry is written: the diagonal two-stream values and zeros
// elsewhere, or the refined element's whole matrices; in a clear layer only
// the [0][0] entry (and [0] of a source) is kept, by a select, as the plain
// build does.
//
// Two passes:
// * build: one thread per element over a flat (column, layer, g-point)
//   index, in blocks of 128, so that a warp's loads of the optics and its
//   stores of each matrix entry and clear-sky plane are contiguous over g.
//   It writes every element's clear-sky coefficients (region 0's two-stream,
//   before the refine pass may replace [0][0]), the two-stream matrices of
//   every element that is not refined (region 0 only in a clear layer), and
//   appends each refined element's index to a list on the card: one
//   shared-memory atomic per element and one global atomic per block.
// * refine: a persistent grid of one-warp blocks, sized to the blocks the
//   card keeps resident, walks the list up to its length, which it reads on
//   the card (no host read of use_expm, of the count or of a squaring
//   count).  One thread per refined element, so no lane idles at the end of
//   a (column, layer)'s refined g-points (they are a prefix, the ng3D rule)
//   except where the elements' squaring counts differ: each element squares
//   its own count of times.  It makes the element's region optics again
//   from the raw inputs, and the LW one its side emissivity.  Its first
//   thread adds the list's length to a running total on the card (the
//   wrappers' counter refined), which the host reads only when asked.
//
// The refinement follows solvers/matrix.py op for op: the SW Gamma is the
// 9x9 block-upper-triangular [[A11 (6x6), A13 (6x3)], [0, A33 (3x3)]]
// (pl_expm_blockut: 63 entries, at most 13 squarings), the LW one a dense
// 6x6 (pl_expm, at most 6 squarings), both the same template with Q = 3 or
// 0; Pade-7 scaling and squaring, LU without pivoting, sums in index order.
// The SW refinement runs in the working type, the LW one in float64
// whatever the working type, cast on the store; the region optics and the
// side emissivity in the working type, as the plain build.  The file
// compiles without FMA contraction (kernels.SOURCE_FLAGS): the region
// merge and the two-stream coefficients round as the plain build's
// (common.cuh sw_ref_trans, as sw_fused.cu), and so does the refinement,
// whose every add and multiply is one torch op in the plain build.
//
// What bounds it: bytes.  Every element writes 45 + 5 (SW) or 24 + 4 (LW)
// entries and reads its gas optics and a few per-(column, layer) values
// (ecCKD at 137 levels and 32 g-points: ~0.9 GB SW and ~0.6 GB LW per 1000
// columns, ~0.45 ms at 3.35 TB/s for both).  The refinement does ~8,000
// float operations per SW element and ~5,000 float64 ones per LW element,
// but on 10-15% of the elements of the benchmark's meridian state.  A whole
// element's matrices do not fit in registers (six 63-entry matrices live in
// the SW Pade step), so each thread keeps the right operand of each product
// in registers (63 or 36 values) and streams the left operand's rows from
// three per-thread matrices in shared memory, laid out [entry][lane] so
// that a warp's accesses hit 32 different banks: 24 KB a warp in float, 48
// KB in double, 30 KB for the LW refinement.  With 255 registers a thread,
// 8 such warps share an SM.  Contracting multiply-adds would halve the SW
// refinement's time on the card, but moves its float32 results by up to 1.0
// where the exponential's solves are ill-conditioned (PERF.md).
#include "common.cuh"

namespace {

using ecrad::d_abs;
using ecrad::d_max;
using ecrad::d_sqrt;
using ecrad::Limits;

constexpr int kBuildThreads = 128;
constexpr int kRefineThreads = 32;  // one warp: per-lane shared matrices
constexpr int NREG = 3;

// solvers/matrix.py: theta3 and the Pade-7 coefficients
constexpr double kTheta3 = 3.925724783138660;
constexpr double kC0 = 17297280.0, kC1 = 8648640.0, kC2 = 1995840.0,
                 kC3 = 277200.0, kC4 = 25200.0, kC5 = 1512.0, kC6 = 56.0,
                 kC7 = 1.0;
constexpr int kSwMaxSquarings = 13;  // matrix._STATIC_SQUARINGS
constexpr int kLwMaxSquarings = 6;   // spartacus._lw_refine's cap

__device__ __forceinline__ float d_frexp(float x, int *e) {
  return frexpf(x, e);
}
__device__ __forceinline__ double d_frexp(double x, int *e) {
  return frexp(x, e);
}
__device__ __forceinline__ float d_ldexp(float x, int e) {
  return ldexpf(x, e);
}
__device__ __forceinline__ double d_ldexp(double x, int e) {
  return ldexp(x, e);
}

// torch.maximum / torch.minimum / torch.clamp: NaN propagates
template <typename T> __device__ __forceinline__ T t_max(T a, T b) {
  return (a != a || a > b) ? a : b;
}
template <typename T> __device__ __forceinline__ T t_min(T a, T b) {
  return (a != a || a < b) ? a : b;
}
template <typename T> __device__ __forceinline__ T clamp_lo(T x, T lo) {
  return x < lo ? lo : x;
}
template <typename T> __device__ __forceinline__ T clamp01(T x) {
  return x < T(0) ? T(0) : (x > T(1) ? T(1) : x);
}

// --- block-upper-triangular matrices ------------------------------------
// [[M11 (P x P), M13 (P x Q)], [0, M33 (Q x Q)]], N = P + Q, stored in NE
// entries: rows i < P whole, rows i >= P from column P on.  Q = 0 is a dense
// P x P matrix.
template <int P, int Q> struct But {
  static constexpr int N = P + Q;
  static constexpr int NE = P * N + Q * Q;
  static __host__ __device__ constexpr int at(int i, int j) {
    return i < P ? i * N + j : P * N + (i - P) * Q + (j - P);
  }
  static __host__ __device__ constexpr int lo(int i) { return i < P ? 0 : P; }
};

// A per-thread matrix in shared memory, entry k of lane t at s[k * 32 + t].
template <typename T> struct Shared {
  T *s;
  __device__ __forceinline__ T &operator[](int k) const {
    return s[k * kRefineThreads];
  }
};

template <typename T, int P, int Q>
__device__ __forceinline__ void load(T (&r)[But<P, Q>::NE], Shared<T> s) {
#pragma unroll
  for (int k = 0; k < But<P, Q>::NE; ++k) r[k] = s[k];
}

// Row i of A as a length-N array (entries left of the row's first used
// column are not read).
template <typename T, int P, int Q>
__device__ __forceinline__ void row_of(const T (&r)[But<P, Q>::NE], int i,
                                       T (&a)[P + Q]) {
  using B = But<P, Q>;
#pragma unroll
  for (int j = 0; j < B::N; ++j)
    if (j >= B::lo(i)) a[j] = r[B::at(i, j)];
}

template <typename T, int P, int Q>
__device__ __forceinline__ void row_of(Shared<T> s, int i, T (&a)[P + Q]) {
  using B = But<P, Q>;
#pragma unroll
  for (int j = 0; j < B::N; ++j)
    if (j >= B::lo(i)) a[j] = s[B::at(i, j)];
}

template <typename T, int P, int Q>
__device__ __forceinline__ void store_row(Shared<T> s, int i,
                                          const T (&c)[P + Q]) {
  using B = But<P, Q>;
#pragma unroll
  for (int j = 0; j < B::N; ++j)
    if (j >= B::lo(i)) s[B::at(i, j)] = c[j];
}

// Row i of the product A B (matrix.py _but_matmul, pl_matmul's sums in q
// order): c11 = a11 B11, c13 = a11 B13 + a13 B33, c33 = a33 B33.  a is row
// i of A, B is in registers.
template <typename T, int P, int Q>
__device__ __forceinline__ void but_row(int i, const T (&a)[P + Q],
                                        const T (&b)[But<P, Q>::NE],
                                        T (&c)[P + Q]) {
  using B = But<P, Q>;
  if (i < P) {
#pragma unroll
    for (int j = 0; j < B::N; ++j) {
      T s1 = a[0] * b[B::at(0, j)];
#pragma unroll
      for (int q = 1; q < P; ++q) s1 = s1 + a[q] * b[B::at(q, j)];
      c[j] = s1;
      if constexpr (Q > 0) {
        if (j >= P) {
          T s2 = a[P] * b[B::at(P, j)];
#pragma unroll
          for (int q = P + 1; q < B::N; ++q)
            s2 = s2 + a[q] * b[B::at(q, j)];
          c[j] = s1 + s2;
        }
      }
    }
  } else {
    if constexpr (Q > 0) {
#pragma unroll
      for (int j = P; j < B::N; ++j) {
        T s2 = a[P] * b[B::at(P, j)];
#pragma unroll
        for (int q = P + 1; q < B::N; ++q) s2 = s2 + a[q] * b[B::at(q, j)];
        c[j] = s2;
      }
    }
  }
}

// LU without pivoting of the m x m block at (o, o) of r, in place
// (matrix.py _pl_lu).
template <typename T, int P, int Q, int M>
__device__ __forceinline__ void lu_block(T (&r)[But<P, Q>::NE], int o) {
  using B = But<P, Q>;
#pragma unroll
  for (int k = 0; k < M - 1; ++k) {
    const T inv = T(1) / r[B::at(o + k, o + k)];
#pragma unroll
    for (int i = k + 1; i < M; ++i)
      r[B::at(o + i, o + k)] = r[B::at(o + i, o + k)] * inv;
#pragma unroll
    for (int i = k + 1; i < M; ++i)
#pragma unroll
      for (int j = k + 1; j < M; ++j)
        r[B::at(o + i, o + j)] =
            r[B::at(o + i, o + j)] -
            r[B::at(o + i, o + k)] * r[B::at(o + k, o + j)];
  }
}

// Forward and back substitution with the packed LU of the m x m block at
// (o, o) of r, on one right-hand side (matrix.py _lu_sub).
template <typename T, int P, int Q, int M>
__device__ __forceinline__ void lu_solve(const T (&r)[But<P, Q>::NE], int o,
                                         T (&y)[M]) {
  using B = But<P, Q>;
#pragma unroll
  for (int i = 1; i < M; ++i)
#pragma unroll
    for (int j = 0; j < i; ++j) y[i] = y[i] - r[B::at(o + i, o + j)] * y[j];
  y[M - 1] = y[M - 1] / r[B::at(o + M - 1, o + M - 1)];
#pragma unroll
  for (int i = M - 2; i >= 0; --i) {
    T acc = y[i];
#pragma unroll
    for (int j = i + 1; j < M; ++j) acc = acc - r[B::at(o + i, o + j)] * y[j];
    y[i] = acc / r[B::at(o + i, o + i)];
  }
}

// The scaling of Pade scaling and squaring (matrix.py _scaling): expo =
// ceil(log2(norm / theta3)) in [0, max_sq], s = 2^-expo.
template <typename T>
__device__ __forceinline__ int squarings(T norm, int max_sq, T &s) {
  T x = norm / T(kTheta3);
  x = clamp_lo(x, ecrad::Limits<T>::tiny());  // torch rounds 1e-300 too
  int e;
  const T frac = d_frexp(x, &e);
  if (frac == T(0.5)) e -= 1;
  e = e < 0 ? 0 : (e > max_sq ? max_sq : e);
  s = d_ldexp(T(1), -e);
  return e;
}

// exp(A) of the block-upper-triangular A in r (matrix.py pl_expm_blockut,
// and pl_expm where Q = 0), left in s0; s1 and s2 are scratch.
template <typename T, int P, int Q, int MaxSq>
__device__ __forceinline__ void expm(T (&r)[But<P, Q>::NE], Shared<T> s0,
                                     Shared<T> s1, Shared<T> s2) {
  using B = But<P, Q>;
  constexpr int N = B::N, NE = B::NE;
  // the 1-norm: largest column sum of |A| (sums over rows in row order;
  // the columns of the 13 and 33 blocks summed apart, then added)
  T norm = T(0);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T cs = d_abs(r[B::at(0, j)]);
#pragma unroll
    for (int i = 1; i < P; ++i) cs = cs + d_abs(r[B::at(i, j)]);
    if (j >= P) {
      T c3 = d_abs(r[B::at(P, j)]);
#pragma unroll
      for (int i = P + 1; i < N; ++i) c3 = c3 + d_abs(r[B::at(i, j)]);
      cs = cs + c3;
    }
    norm = j == 0 ? cs : t_max(norm, cs);
  }
  T sc;
  const int expo = squarings(norm, MaxSq, sc);
  // As = A 2^-expo (s0); A2 = As As (s1)
  T a[N], c[N];
#pragma unroll
  for (int k = 0; k < NE; ++k) {
    r[k] = r[k] * sc;
    s0[k] = r[k];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    row_of<T, P, Q>(r, i, a);
    but_row<T, P, Q>(i, a, r, c);
    store_row<T, P, Q>(s1, i, c);
  }
  // A4 = A2 A2 (s2)
  load<T, P, Q>(r, s1);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    row_of<T, P, Q>(r, i, a);
    but_row<T, P, Q>(i, a, r, c);
    store_row<T, P, Q>(s2, i, c);
  }
  // A6 = A4 A2 row by row, folded into U = ((c3 A2 + c1 I) + c5 A4) + c7
  // A6 (s2, over A4's rows once read) and V, with c2, c0, c4, c6 (s1)
#pragma unroll
  for (int i = 0; i < N; ++i) {
    row_of<T, P, Q>(s2, i, a);
    but_row<T, P, Q>(i, a, r, c);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j < B::lo(i)) continue;
      const int k = B::at(i, j);
      // the identity's entry; the 13 block has none
      const bool blk = (i < P) == (j < P);
      const T eye = i == j ? T(1) : T(0);
      T u = T(kC3) * r[k];
      T v = T(kC2) * r[k];
      if (blk) {
        u = u + T(kC1) * eye;
        v = v + T(kC0) * eye;
      }
      u = u + T(kC5) * a[j];
      v = v + T(kC4) * a[j];
      s2[k] = u + T(kC7) * c[j];
      s1[k] = v + T(kC6) * c[j];
    }
  }
  // U = As U (s2)
  load<T, P, Q>(r, s2);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    row_of<T, P, Q>(s0, i, a);
    but_row<T, P, Q>(i, a, r, c);
    store_row<T, P, Q>(s2, i, c);
  }
  // R = (V - U)^-1 (2 U) + I blockwise (matrix.py _but_solve): X11 = W11^-1
  // B11, X33 = W33^-1 B33, X13 = W11^-1 (B13 - W13 X33); R in s0
#pragma unroll
  for (int k = 0; k < NE; ++k) r[k] = s1[k] - s2[k];
  lu_block<T, P, Q, P>(r, 0);
  T x33[Q > 0 ? Q * Q : 1];
  if constexpr (Q > 0) {
    lu_block<T, P, Q, Q>(r, P);
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      T y[Q];
#pragma unroll
      for (int i = 0; i < Q; ++i) y[i] = T(2) * s2[B::at(P + i, P + j)];
      lu_solve<T, P, Q, Q>(r, P, y);
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        x33[i * Q + j] = y[i];
        s0[B::at(P + i, P + j)] = y[i] + (i == j ? T(1) : T(0));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T y[P];
#pragma unroll
    for (int i = 0; i < P; ++i) y[i] = T(2) * s2[B::at(i, j)];
    if constexpr (Q > 0) {
      if (j >= P) {
#pragma unroll
        for (int i = 0; i < P; ++i) {
          T w = r[B::at(i, P)] * x33[j - P];
#pragma unroll
          for (int q = 1; q < Q; ++q)
            w = w + r[B::at(i, P + q)] * x33[q * Q + (j - P)];
          y[i] = y[i] - w;
        }
      }
    }
    lu_solve<T, P, Q, P>(r, 0, y);
#pragma unroll
    for (int i = 0; i < P; ++i)
      s0[B::at(i, j)] = j < P ? y[i] + (i == j ? T(1) : T(0)) : y[i];
  }
  // each element squares its own expo times
  for (int it = 0; it < expo; ++it) {
    load<T, P, Q>(r, s0);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      row_of<T, P, Q>(r, i, a);
      but_row<T, P, Q>(i, a, r, c);
      store_row<T, P, Q>(s0, i, c);
    }
  }
}

// Exchange matrix of transfer rates t (k = 3*i + j): X[i][i] = t[i][0] +
// t[i][1] + t[i][2], X[i][j] = -t[j][i] (spartacus._exchange).
template <typename T>
__device__ __forceinline__ void exchange(const T (&t)[9], T (&x)[9]) {
#pragma unroll
  for (int i = 0; i < NREG; ++i)
#pragma unroll
    for (int j = 0; j < NREG; ++j)
      x[3 * i + j] = i == j ? (t[3 * i] + t[3 * i + 1]) + t[3 * i + 2]
                            : -t[3 * j + i];
}

// 3x3 LU of m (k = 3*i + j) in place, and a solve with it
template <typename T> __device__ __forceinline__ void lu3(T (&m)[9]) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const T inv = T(1) / m[4 * k];
#pragma unroll
    for (int i = k + 1; i < 3; ++i) m[3 * i + k] = m[3 * i + k] * inv;
#pragma unroll
    for (int i = k + 1; i < 3; ++i)
#pragma unroll
      for (int j = k + 1; j < 3; ++j)
        m[3 * i + j] = m[3 * i + j] - m[3 * i + k] * m[3 * k + j];
  }
}
template <typename T>
__device__ __forceinline__ void solve3(const T (&lu)[9], T (&y)[3]) {
  y[1] = y[1] - lu[3] * y[0];
  y[2] = y[2] - lu[6] * y[0];
  y[2] = y[2] - lu[7] * y[1];
  y[2] = y[2] / lu[8];
  y[1] = (y[1] - lu[5] * y[2]) / lu[4];
  y[0] = ((y[0] - lu[1] * y[1]) - lu[2] * y[2]) / lu[0];
}

using SwBut = But<6, 3>;
using LwBut = But<6, 0>;

// The 3D SW layer matrices of one element (spartacus._sw_refine): region
// optics od, ssa, g, mu0 and 1/mu0, diffuse and direct transfer rates;
// writes R, T, Rd, Tdd, Tdir (k = 3*i + j) to out[m][k].
template <typename T>
__device__ __forceinline__ void sw_refine(const T (&od)[3], const T (&ssa)[3],
                                          const T (&g)[3], T mu0, T inv_mu0,
                                          const T (&td)[9], const T (&tdr)[9],
                                          Shared<T> s0, Shared<T> s1,
                                          Shared<T> s2, T (&out)[5][9]) {
  using B = SwBut;
  T xd[9], xdir[9];
  exchange(td, xd);
  exchange(tdr, xdir);
  T r[B::NE];
#pragma unroll
  for (int k = 0; k < B::NE; ++k) r[k] = T(0);
#pragma unroll
  for (int i = 0; i < NREG; ++i) {
    const T factor = T(0.75) * g[i];
    const T g1 = T(2) - ssa[i] * (T(1.25) + factor);
    const T g2 = ssa[i] * (T(0.75) - factor);
    const T g3 = T(0.5) - mu0 * factor;
#pragma unroll
    for (int j = 0; j < NREG; ++j) {
      const T d = i == j ? od[i] * g1 + xd[4 * i] : xd[3 * i + j];
      r[B::at(i, j)] = d;
      r[B::at(3 + i, 3 + j)] = -d;
      r[B::at(6 + i, 6 + j)] =
          i == j ? -xdir[4 * i] + -od[i] * inv_mu0 : -xdir[3 * i + j];
    }
    r[B::at(i, 3 + i)] = -od[i] * g2;
    r[B::at(3 + i, i)] = od[i] * g2;
    r[B::at(i, 6 + i)] = -od[i] * ssa[i] * g3;
    r[B::at(3 + i, 6 + i)] = od[i] * ssa[i] * (T(1) - g3);
  }
  expm<T, 6, 3, kSwMaxSquarings>(r, s0, s1, s2);
  load<T, 6, 3>(r, s0);
  // E11 = E[0:3, 0:3], E12 = E[0:3, 3:6], E21, E22 below them; E13, E23
  // the direct columns; E33 the direct block
  T lu[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) lu[k] = r[B::at(k / 3, k % 3)];
  lu3(lu);
#pragma unroll
  for (int j = 0; j < NREG; ++j) {
    T y[3] = {r[B::at(0, 3 + j)], r[B::at(1, 3 + j)], r[B::at(2, 3 + j)]};
    solve3(lu, y);
    T z[3] = {r[B::at(0, 6 + j)], r[B::at(1, 6 + j)], r[B::at(2, 6 + j)]};
    solve3(lu, z);
#pragma unroll
    for (int i = 0; i < NREG; ++i) {
      out[0][3 * i + j] = clamp01(-y[i]);
      out[2][3 * i + j] = t_min(clamp_lo(-z[i], T(0)), mu0);
      out[4][3 * i + j] = clamp01(r[B::at(6 + i, 6 + j)]);
    }
  }
#pragma unroll
  for (int i = 0; i < NREG; ++i)
#pragma unroll
    for (int j = 0; j < NREG; ++j) {
      T t = r[B::at(3 + i, 0)] * out[0][j];
      T d = r[B::at(3 + i, 0)] * out[2][j];
#pragma unroll
      for (int q = 1; q < NREG; ++q) {
        t = t + r[B::at(3 + i, q)] * out[0][3 * q + j];
        d = d + r[B::at(3 + i, q)] * out[2][3 * q + j];
      }
      out[1][3 * i + j] = clamp01(t + r[B::at(3 + i, 3 + j)]);
      out[3][3 * i + j] = t_min(clamp_lo(d + r[B::at(3 + i, 6 + j)], T(0)),
                                mu0);
    }
}

// The 3D LW layer matrices and sources of one element, in double
// (spartacus._lw_refine): region optics, transfer rates, side emissivity,
// region fractions, Planck at the layer's top and base; R, T (k = 3*i + j)
// to out[0], out[1], SU, SD to out[2][0:3], out[3][0:3].  s3 holds the two
// particular solutions (12 values).
__device__ __forceinline__ void lw_refine(
    const double (&od)[3], const double (&ssa)[3], const double (&g)[3],
    const double (&tr)[9], double side, const double (&rf)[3], double plt,
    double plb, Shared<double> s0, Shared<double> s1, Shared<double> s2,
    Shared<double> s3, double (&out)[4][9]) {
  using B = LwBut;
  double trs[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) trs[k] = tr[k];
  trs[3] = trs[3] * side;
  trs[6] = trs[6] * side;
  double r[B::NE];
  double g2d[3];
#pragma unroll
  for (int i = 0; i < NREG; ++i) {
    const double factor = (ecrad::kLwDiffusivity * 0.5) * ssa[i];
    const double g1 = ecrad::kLwDiffusivity - factor * (1.0 + g[i]);
    const double g2 = factor * (1.0 - g[i]);
    g2d[i] = od[i] * g2;
#pragma unroll
    for (int j = 0; j < NREG; ++j) {
      const double d = i == j ? od[i] * g1 + ((trs[3 * i] + trs[3 * i + 1]) +
                                              trs[3 * i + 2])
                              : -trs[3 * j + i];
      r[B::at(i, j)] = d;
      r[B::at(3 + i, 3 + j)] = -d;
      r[B::at(i, 3 + j)] = 0.0;
      r[B::at(3 + i, j)] = 0.0;
    }
  }
#pragma unroll
  for (int i = 0; i < NREG; ++i) {
    r[B::at(i, 3 + i)] = -g2d[i];
    r[B::at(3 + i, i)] = g2d[i];
  }
  // the particular solutions: sol_d = -G^-1 pd, sol0 = G^-1 (sol_d - pt)
  double pt[6], pd[6];
  const double dpl = plb - plt;
#pragma unroll
  for (int i = 0; i < NREG; ++i) {
    const double emis =
        od[i] * (1.0 - ssa[i]) * rf[i] * ecrad::kLwDiffusivity;
    pt[i] = -emis * plt;
    pt[3 + i] = emis * plt;
    pd[i] = -emis * dpl;
    pd[3 + i] = emis * dpl;
  }
#pragma unroll
  for (int k = 0; k < B::NE; ++k) s0[k] = r[k];
  lu_block<double, 6, 0, 6>(r, 0);
  lu_solve<double, 6, 0, 6>(r, 0, pd);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    pd[i] = -pd[i];  // sol_d
    s3[i] = pd[i];
    pt[i] = pd[i] - pt[i];
  }
  lu_solve<double, 6, 0, 6>(r, 0, pt);
#pragma unroll
  for (int i = 0; i < 6; ++i) s3[6 + i] = pt[i];  // sol0
  load<double, 6, 0>(r, s0);
  expm<double, 6, 0, kLwMaxSquarings>(r, s0, s1, s2);
  load<double, 6, 0>(r, s0);
  double sd[6], s0v[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    sd[i] = s3[i];
    s0v[i] = s3[6 + i];
  }
  double lu[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) lu[k] = r[B::at(k / 3, k % 3)];
  lu3(lu);
  // R = -E11^-1 E12, T = E21 R + E22
#pragma unroll
  for (int j = 0; j < NREG; ++j) {
    double y[3] = {r[B::at(0, 3 + j)], r[B::at(1, 3 + j)],
                   r[B::at(2, 3 + j)]};
    solve3(lu, y);
#pragma unroll
    for (int i = 0; i < NREG; ++i) out[0][3 * i + j] = -y[i];
  }
#pragma unroll
  for (int i = 0; i < NREG; ++i)
#pragma unroll
    for (int j = 0; j < NREG; ++j) {
      double t = r[B::at(3 + i, 0)] * out[0][j];
#pragma unroll
      for (int q = 1; q < NREG; ++q)
        t = t + r[B::at(3 + i, q)] * out[0][3 * q + j];
      out[1][3 * i + j] = t + r[B::at(3 + i, 3 + j)];
    }
  // tmp = sol0[:3] + sol_d[:3] - E12 sol0[3:]; su = sol0[:3] - E11^-1 tmp
  double tmp[3], e22s[3];
#pragma unroll
  for (int i = 0; i < NREG; ++i) {
    double m = r[B::at(i, 3)] * s0v[3];
    double m22 = r[B::at(3 + i, 3)] * s0v[3];
#pragma unroll
    for (int q = 1; q < NREG; ++q) {
      m = m + r[B::at(i, 3 + q)] * s0v[3 + q];
      m22 = m22 + r[B::at(3 + i, 3 + q)] * s0v[3 + q];
    }
    tmp[i] = (s0v[i] + sd[i]) - m;
    e22s[i] = m22;
  }
  solve3(lu, tmp);
  double su[3], dsu[3];
#pragma unroll
  for (int i = 0; i < NREG; ++i) {
    su[i] = s0v[i] - tmp[i];
    dsu[i] = su[i] - s0v[i];
  }
  // sd = E21 (su - sol0[:3]) + sol0[3:] - E22 sol0[3:] + sol_d[3:]
#pragma unroll
  for (int i = 0; i < NREG; ++i) {
    double m = r[B::at(3 + i, 0)] * dsu[0];
#pragma unroll
    for (int q = 1; q < NREG; ++q) m = m + r[B::at(3 + i, q)] * dsu[q];
    out[2][i] = su[i];
    out[3][i] = ((m + s0v[3 + i]) - e22s[i]) + sd[3 + i];
  }
}

// --- the region optics ---------------------------------------------------

constexpr double kSideEmissThin = 1.4107;  // spartacus.SIDE_EMISS_THIN

// A band set's raw optics, read by both passes: the gas (with aerosol) od,
// ssa, g (ncol, nlev, ng), ssa and g null for an absorbing gas (the LW
// without aerosol scattering); the band cloud properties (ncol, nlev,
// nband); each g-point's band (ng,); the two cloudy regions' od scaling
// (ncol, nlev, 2); the largest cloudy-region od.
template <typename T> struct Optics {
  const T *od, *ssa, *g;
  const T *odc_b, *ssac_b, *gc_b;
  const int *band;
  const T *scal;
  T max_od;
  int nband;
};

// Region 0 of element e: the gas as given
template <typename T>
__device__ __forceinline__ void gas(const Optics<T> &a, size_t e, T (&od)[3],
                                    T (&ssa)[3], T (&asy)[3]) {
  od[0] = a.od[e];
  ssa[0] = a.ssa ? a.ssa[e] : T(0);
  asy[0] = a.ssa ? a.g[e] : T(0);
}

// Regions 1 and 2 of the element at (column, layer) cl and g-point g, from
// region 0's values: the gas merged with the scaled cloud
// (cuda_tripleclouds.merge_regions: ssa and g from the unclamped od, the
// 1e-300 floors behind a test of the divisor, 0 in float), then the od
// clamped at max_od (spartacus._region_optics).
template <typename T>
__device__ __forceinline__ void cloudy(const Optics<T> &a, size_t cl, int g,
                                       T (&od)[3], T (&ssa)[3], T (&asy)[3]) {
  const size_t lb = cl * a.nband + a.band[g];
  const T odcb = a.odc_b[lb], ssacb = a.ssac_b[lb], gcb = a.gc_b[lb];
  const T scat_clear = ssa[0] * od[0];
#pragma unroll
  for (int r = 1; r < NREG; ++r) {
    const T odc = a.scal[2 * cl + r - 1] * odcb;
    const T od_tot = od[0] + odc;
    const T scat_cloud = ssacb * odc;
    T scat, gscat;
    if (a.ssa) {
      scat = scat_clear + scat_cloud;
      gscat = asy[0] * scat_clear + gcb * scat_cloud;
    } else {
      scat = scat_cloud;
      gscat = gcb * scat_cloud;
    }
    ssa[r] = od_tot > T(0) ? scat / d_max(od_tot, Limits<T>::tiny()) : T(0);
    asy[r] = scat > T(0) ? gscat / d_max(scat, Limits<T>::tiny()) : T(0);
    od[r] = od_tot > a.max_od ? a.max_od : od_tot;
  }
}

// The LW side emissivity of a refined element (radiation_spartacus_lw.F90:
// 289-310, spartacus._side_emissivity) from its region optics and its
// (column, layer)'s cloud aspect ratio, in the working type
template <typename T>
__device__ __forceinline__ T side_emissivity(T aspect, const T (&od)[3],
                                             const T (&ssa)[3],
                                             const T (&asy)[3]) {
  const T lateral_od = (aspect / T(NREG - 1)) *
                       (od[1] * (T(1) - ssa[1]) + od[2] * (T(1) - ssa[2]));
  const T sq1 = d_sqrt(clamp_lo(T(1) - ssa[1], T(0)));
  const T thick =
      T(2) * sq1 / (sq1 + d_sqrt(clamp_lo(T(1) - ssa[1] * asy[1], T(0))));
  return (T(kSideEmissThin) - thick) / (lateral_od + T(1)) + thick;
}

// --- the build pass ------------------------------------------------------

// Append the refined elements of a block to the list: a slot in shared
// memory per element, one global atomic per block.  Every thread of the
// block calls it.
__device__ __forceinline__ void append(bool want, int e, int *list,
                                       int *count) {
  __shared__ int s_n, s_base;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  const int slot = want ? atomicAdd(&s_n, 1) : -1;
  __syncthreads();
  if (threadIdx.x == 0) s_base = s_n > 0 ? atomicAdd(count, s_n) : 0;
  __syncthreads();
  if (want) list[s_base + slot] = e;
}

// The output tensors' pointers, passed by value
template <typename T, int M> struct Ptrs {
  T *m[M];
};

struct Elem {
  int col, lev, g;
  size_t cl;                          // (column, layer)
  size_t plane, base9, base3, base1;  // an entry's stride; entry 0 of R, of
                                      // SU and of a clear-sky plane
};

__device__ __forceinline__ Elem element(int e, int ncol, int nlev, int ng) {
  Elem x;
  x.col = e / (nlev * ng);
  const int rem = e - x.col * nlev * ng;
  x.lev = rem / ng;
  x.g = rem - x.lev * ng;
  x.cl = (size_t)x.col * nlev + x.lev;
  x.plane = (size_t)ncol * ng;
  const size_t cg = (size_t)x.col * ng + x.g;
  x.base9 = (size_t)x.lev * 9 * x.plane + cg;
  x.base3 = (size_t)x.lev * 3 * x.plane + cg;
  x.base1 = (size_t)x.lev * x.plane + cg;
  return x;
}

// mu0 (ncol,); use_expm (ncol, nlev, ng) and clear (ncol, nlev) as bytes;
// writes the clear-sky planes cl5 of every element and R, T, Rd, Tdd, Tdir
// (nlev, 9, ncol, ng) of every element not refined, and lists the refined
// ones
template <typename T>
__global__ void __launch_bounds__(kBuildThreads) sw_build_kernel(
    Optics<T> a, const T *__restrict__ mu0s,
    const unsigned char *__restrict__ use_expm,
    const unsigned char *__restrict__ clear, Ptrs<T, 5> outs, Ptrs<T, 5> cl5,
    int *list, int *count, int ncol, int nlev, int ng, int refine) {
  const long long n = (long long)ncol * nlev * ng;
  const int e = blockIdx.x * kBuildThreads + threadIdx.x;
  const bool valid = e < n;
  const bool want = valid && refine && use_expm[e];
  if (refine) append(want, e, list, count);
  if (!valid) return;
  const Elem x = element(e, ncol, nlev, ng);
  const T mu0 = mu0s[x.col];
  T od[3], ssa[3], asy[3], c[5][3];
  gas(a, e, od, ssa, asy);
  ecrad::sw_ref_trans(mu0, od[0], ssa[0], asy[0], c[0][0], c[1][0], c[2][0],
                      c[3][0], c[4][0]);
#pragma unroll
  for (int m = 0; m < 5; ++m) cl5.m[m][x.base1] = c[m][0];
  if (want) return;
  if (clear[x.cl] != 0) {
#pragma unroll
    for (int r = 1; r < NREG; ++r)
#pragma unroll
      for (int m = 0; m < 5; ++m) c[m][r] = T(0);
  } else {
    cloudy(a, x.cl, x.g, od, ssa, asy);
#pragma unroll
    for (int r = 1; r < NREG; ++r)
      ecrad::sw_ref_trans(mu0, od[r], ssa[r], asy[r], c[0][r], c[1][r],
                          c[2][r], c[3][r], c[4][r]);
  }
#pragma unroll
  for (int m = 0; m < 5; ++m)
#pragma unroll
    for (int k = 0; k < 9; ++k)
      outs.m[m][x.base9 + k * x.plane] = k % 4 == 0 ? c[m][k / 4] : T(0);
}

// rf (ncol, nlev, 3); the Planck values at layer tops and bases (ncol,
// nlev, ng) with a column stride pstride; writes the clear-sky planes cl4
// of every element (the unscaled Planck terms) and R, T (nlev, 9, ncol, ng)
// and SU, SD (nlev, 3, ncol, ng) of every element not refined (the Planck
// terms scaled by region fraction), and lists the refined ones
template <typename T>
__global__ void __launch_bounds__(kBuildThreads) lw_build_kernel(
    Optics<T> a, const T *__restrict__ rfs,
    const unsigned char *__restrict__ clear, const T *__restrict__ pl_top,
    const T *__restrict__ pl_bot, const unsigned char *__restrict__ use_expm,
    Ptrs<T, 4> outs, Ptrs<T, 4> cl4, int *list, int *count, int ncol,
    int nlev, int ng, int pstride, int refine) {
  const long long n = (long long)ncol * nlev * ng;
  const int e = blockIdx.x * kBuildThreads + threadIdx.x;
  const bool valid = e < n;
  const bool want = valid && refine && use_expm[e];
  if (refine) append(want, e, list, count);
  if (!valid) return;
  const Elem x = element(e, ncol, nlev, ng);
  const size_t pi = (size_t)x.col * pstride + (size_t)x.lev * ng + x.g;
  const T pt = pl_top[pi], pb = pl_bot[pi];
  T od[3], ssa[3], asy[3], c[4][3];
  gas(a, e, od, ssa, asy);
  {
    T cs[4];
    ecrad::lw_ref_trans(od[0], ssa[0], asy[0], pt, pb, cs[0], cs[1], cs[2],
                        cs[3]);
#pragma unroll
    for (int m = 0; m < 4; ++m) cl4.m[m][x.base1] = cs[m];
  }
  if (want) return;
  const bool clr = clear[x.cl] != 0;
  if (!clr) cloudy(a, x.cl, x.g, od, ssa, asy);
#pragma unroll
  for (int r = 0; r < NREG; ++r) {
    if (r == 0 || !clr) {
      const T rf = rfs[3 * x.cl + r];
      ecrad::lw_ref_trans(od[r], ssa[r], asy[r], rf * pt, rf * pb, c[0][r],
                          c[1][r], c[2][r], c[3][r]);
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m) c[m][r] = T(0);
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int k = 0; k < 9; ++k)
      outs.m[m][x.base9 + k * x.plane] = k % 4 == 0 ? c[m][k / 4] : T(0);
#pragma unroll
  for (int m = 2; m < 4; ++m)
#pragma unroll
    for (int r = 0; r < NREG; ++r) outs.m[m][x.base3 + r * x.plane] = c[m][r];
}

// --- the refine pass -----------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kRefineThreads) sw_refine_kernel(
    Optics<T> a, const T *__restrict__ mu0s, const T *__restrict__ tr_diff,
    const T *__restrict__ tr_dir, const unsigned char *__restrict__ clear,
    Ptrs<T, 5> outs, const int *__restrict__ list,
    const int *__restrict__ count, long long *__restrict__ total, int ncol,
    int nlev, int ng) {
  constexpr int NE = SwBut::NE;
  __shared__ T smem[3 * NE * kRefineThreads];
  const Shared<T> s0{smem + threadIdx.x},
      s1{smem + NE * kRefineThreads + threadIdx.x},
      s2{smem + 2 * NE * kRefineThreads + threadIdx.x};
  const int n = *count;
  if (blockIdx.x == 0 && threadIdx.x == 0) *total += n;
  for (int i = blockIdx.x * kRefineThreads + threadIdx.x; i < n;
       i += gridDim.x * kRefineThreads) {
    const int e = list[i];
    const Elem x = element(e, ncol, nlev, ng);
    T od[3], ssa[3], g[3], td[9], tdr[9];
    gas(a, e, od, ssa, g);
    cloudy(a, x.cl, x.g, od, ssa, g);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      td[k] = tr_diff[9 * x.cl + k];
      tdr[k] = tr_dir[9 * x.cl + k];
    }
    const T mu0 = mu0s[x.col];
    const T inv_mu0 = T(1) / mu0;
    T out[5][9];
    sw_refine(od, ssa, g, mu0, inv_mu0, td, tdr, s0, s1, s2, out);
    const bool clr = clear[x.cl] != 0;  // use_expm_everywhere only
#pragma unroll
    for (int m = 0; m < 5; ++m)
#pragma unroll
      for (int k = 0; k < 9; ++k)
        outs.m[m][x.base9 + k * x.plane] = clr && k ? T(0) : out[m][k];
  }
}

// tr (ncol, nlev, 3, 3); aspect (ncol, nlev): the cloud aspect ratio where
// the side emissivity applies, 0 where it is 1
template <typename T>
__global__ void __launch_bounds__(kRefineThreads) lw_refine_kernel(
    Optics<T> a, const T *__restrict__ tr, const T *__restrict__ aspect,
    const T *__restrict__ rfs, const unsigned char *__restrict__ clear,
    const T *__restrict__ pl_top, const T *__restrict__ pl_bot,
    Ptrs<T, 4> outs, const int *__restrict__ list,
    const int *__restrict__ count, long long *__restrict__ total, int ncol,
    int nlev, int ng, int pstride) {
  constexpr int NE = LwBut::NE;
  __shared__ double smem[(3 * NE + 12) * kRefineThreads];
  const Shared<double> s0{smem + threadIdx.x},
      s1{smem + NE * kRefineThreads + threadIdx.x},
      s2{smem + 2 * NE * kRefineThreads + threadIdx.x},
      s3{smem + 3 * NE * kRefineThreads + threadIdx.x};
  const int n = *count;
  if (blockIdx.x == 0 && threadIdx.x == 0) *total += n;
  for (int i = blockIdx.x * kRefineThreads + threadIdx.x; i < n;
       i += gridDim.x * kRefineThreads) {
    const int e = list[i];
    const Elem x = element(e, ncol, nlev, ng);
    T odt[3], ssat[3], gt[3];
    gas(a, e, odt, ssat, gt);
    cloudy(a, x.cl, x.g, odt, ssat, gt);
    const T asp = aspect[x.cl];
    const T side = asp > T(0) ? side_emissivity(asp, odt, ssat, gt) : T(1);
    double od[3], ssa[3], g[3], trd[9], rf[3];
#pragma unroll
    for (int r = 0; r < NREG; ++r) {
      od[r] = double(odt[r]);
      ssa[r] = double(ssat[r]);
      g[r] = double(gt[r]);
      rf[r] = double(rfs[3 * x.cl + r]);
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) trd[k] = double(tr[9 * x.cl + k]);
    const size_t pi = (size_t)x.col * pstride + (size_t)x.lev * ng + x.g;
    double out[4][9];
    lw_refine(od, ssa, g, trd, double(side), rf, double(pl_top[pi]),
              double(pl_bot[pi]), s0, s1, s2, s3, out);
    const bool clr = clear[x.cl] != 0;  // use_expm_everywhere only
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int k = 0; k < 9; ++k)
        outs.m[m][x.base9 + k * x.plane] = clr && k ? T(0) : T(out[m][k]);
#pragma unroll
    for (int m = 2; m < 4; ++m)
#pragma unroll
      for (int r = 0; r < NREG; ++r)
        outs.m[m][x.base3 + r * x.plane] = clr && r ? T(0) : T(out[m][r]);
  }
}

// The refine pass's grid: as many one-warp blocks as the card keeps
// resident, no more than the elements need.
template <typename K> int refine_blocks(K kernel, long long n) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                kRefineThreads, 0);
  const long long need = (n + kRefineThreads - 1) / kRefineThreads;
  const long long most = (long long)(sms > 0 ? sms : 1) *
                         (per_sm > 0 ? per_sm : 1);
  return (int)(need < most ? need : most);
}

// p[0:8]: od, ssa, g (ssa and g null: absorbing), od_cloud_b, ssa_cloud_b,
// g_cloud_b, band_from_g (int32), od_scaling
template <typename T>
Optics<T> optics(void *const *p, int nband, double max_od) {
  Optics<T> a;
  a.od = (const T *)p[0];
  a.ssa = (const T *)p[1];
  a.g = (const T *)p[2];
  a.odc_b = (const T *)p[3];
  a.ssac_b = (const T *)p[4];
  a.gc_b = (const T *)p[5];
  a.band = (const int *)p[6];
  a.scal = (const T *)p[7];
  a.max_od = T(max_od);
  a.nband = nband;
  return a;
}

// p: the optics (8), mu0, tr_diff, tr_dir, use_expm, clear, R, T, Rd, Tdd,
// Tdir, the five clear-sky planes, list, count, total
template <typename T>
int launch_sw(void *const *p, int ncol, int nlev, int ng, int nband,
              int refine, double max_od, void *stream) {
  const long long n = (long long)ncol * nlev * ng;
  if (n == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  const Optics<T> a = optics<T>(p, nband, max_od);
  Ptrs<T, 5> outs, cl5;
  for (int m = 0; m < 5; ++m) {
    outs.m[m] = (T *)p[13 + m];
    cl5.m[m] = (T *)p[18 + m];
  }
  int *list = (int *)p[23], *count = (int *)p[24];
  long long *total = (long long *)p[25];
  const int blocks = (int)((n + kBuildThreads - 1) / kBuildThreads);
  sw_build_kernel<T><<<blocks, kBuildThreads, 0, st>>>(
      a, (const T *)p[8], (const unsigned char *)p[11],
      (const unsigned char *)p[12], outs, cl5, list, count, ncol, nlev, ng,
      refine);
  if (refine) {
    const int grid = refine_blocks(sw_refine_kernel<T>, n);
    sw_refine_kernel<T><<<grid, kRefineThreads, 0, st>>>(
        a, (const T *)p[8], (const T *)p[9], (const T *)p[10],
        (const unsigned char *)p[12], outs, list, count, total, ncol, nlev,
        ng);
  }
  return (int)cudaGetLastError();
}

// p: the optics (8), tr, aspect, reg_fracs, clear, pl_top, pl_bot,
// use_expm, R, T, SU, SD, the four clear-sky planes, list, count, total
template <typename T>
int launch_lw(void *const *p, int ncol, int nlev, int ng, int nband,
              int pstride, int refine, double max_od, void *stream) {
  const long long n = (long long)ncol * nlev * ng;
  if (n == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  const Optics<T> a = optics<T>(p, nband, max_od);
  Ptrs<T, 4> outs, cl4;
  for (int m = 0; m < 4; ++m) {
    outs.m[m] = (T *)p[15 + m];
    cl4.m[m] = (T *)p[19 + m];
  }
  int *list = (int *)p[23], *count = (int *)p[24];
  long long *total = (long long *)p[25];
  const int blocks = (int)((n + kBuildThreads - 1) / kBuildThreads);
  lw_build_kernel<T><<<blocks, kBuildThreads, 0, st>>>(
      a, (const T *)p[10], (const unsigned char *)p[11], (const T *)p[12],
      (const T *)p[13], (const unsigned char *)p[14], outs, cl4, list, count,
      ncol, nlev, ng, pstride, refine);
  if (refine) {
    const int grid = refine_blocks(lw_refine_kernel<T>, n);
    lw_refine_kernel<T><<<grid, kRefineThreads, 0, st>>>(
        a, (const T *)p[8], (const T *)p[9], (const T *)p[10],
        (const unsigned char *)p[11], (const T *)p[12], (const T *)p[13],
        outs, list, count, total, ncol, nlev, ng, pstride);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The pointer arrays of launch_sw and launch_lw; ncol, nlev, ng, the
// number of bands of the cloud properties; the Planck inputs' column
// stride (LW); refine: build the 3D refinement (list, count and total
// non-null, the count zeroed; the refine pass adds the count to total);
// max_cloud_od
int ecrad_spartacus_sw_mats_f32(void *const *p, int ncol, int nlev, int ng,
                                int nband, int refine, double max_od,
                                void *stream) {
  return launch_sw<float>(p, ncol, nlev, ng, nband, refine, max_od, stream);
}

int ecrad_spartacus_sw_mats_f64(void *const *p, int ncol, int nlev, int ng,
                                int nband, int refine, double max_od,
                                void *stream) {
  return launch_sw<double>(p, ncol, nlev, ng, nband, refine, max_od, stream);
}

int ecrad_spartacus_lw_mats_f32(void *const *p, int ncol, int nlev, int ng,
                                int nband, int pstride, int refine,
                                double max_od, void *stream) {
  return launch_lw<float>(p, ncol, nlev, ng, nband, pstride, refine, max_od,
                          stream);
}

int ecrad_spartacus_lw_mats_f64(void *const *p, int ncol, int nlev, int ng,
                                int nband, int pstride, int refine,
                                double max_od, void *stream) {
  return launch_lw<double>(p, ncol, nlev, ng, nband, pstride, refine,
                           max_od, stream);
}

}  // extern "C"
