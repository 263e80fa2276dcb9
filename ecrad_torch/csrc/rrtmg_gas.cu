// RRTMG gas optics: the taumol interpolation of both band sets, as two
// kernels: rrtmg_lw_taumol_kernel (ifsrrtm/rrtm_taumol1.F90 ...
// rrtm_taumol16.F90, 16 bands, 140 g-points) and rrtmg_sw_taumol_kernel
// (srtm_taumol16.F90 ... srtm_taumol29.F90, 14 bands, 112 g-points).
//
// Replaces no TPU kernel: the JAX package leaves RRTMG gas optics to XLA
// (ecrad_tpu/optics/rrtmg_lw.py, rrtmg_sw.py hold no pallas_call).  It was
// written for the card because the plain version (the band functions of
// ecrad_torch/optics/rrtmg_lw.py and rrtmg_sw.py), which makes each (row,
// weight) pair of each band a gather of a whole (ncol, nlev, ng_band) plane,
// then a multiply and an add, some 5,000 launches a block, was the largest
// device cost of a RRTMG step.  Wrappers, the packed tables and the plain
// versions: ecrad_torch/optics/cuda_rrtmg.py.
//
// What bounds it on the H100: the bytes written.  Per (column, layer) the LW
// kernel writes od and the Planck function at 140 g-points and the SW
// kernel od and ssa at 112, 504 values, against the 45 fields of
// rrtmg_prepare.GasColumns it reads.  The packed tables (0.6 MB LW and
// 0.35 MB SW in float32) stay in the 50 MB L2 for the whole launch.  On the
// card the kernels take 14.6x (LW) and 6.6x (SW) that bound (PERF.md §6):
// latency in the band formulations and the table reads holds them, which
// is unmeasured in detail.  The design:
// - A block takes kRows consecutive (column, layer) rows of the flat
//   ncol * nlev axis and stages their GasColumns fields in shared memory,
//   each field's rows one contiguous load (phase 0).
// - One thread per (band, row) runs the band's formulation, ported from the
//   plain band function as it is: only the lower or the upper atmosphere's
//   branch, whichever applies to the row; the eta-edge quartic weights of
//   the two-species interpolation; the minor gases' adjusted columns; the
//   band-1 and band-2 pressure corrections.  It reduces the band's
//   interpolation to a list of terms in shared memory, each an offset into
//   the packed tables (a row of ng_band entries, g-points last) and a
//   weight, with the Planck function of the band in LW.  So the indices and
//   weights of a (row, band) are computed once, shared by its g-points, and
//   never stored as (ncol, nlev, ng) planes (phase 1).
// - One thread per (row, g-point) sums its band's terms at its g-point,
//   times a per-g factor where the band has one (the upper g-corrections of
//   bands 4 and 7), and writes od and the Planck function (LW), or od and
//   ssa (SW) (phase 2).  Consecutive threads take consecutive g-points of
//   consecutive rows: each store of a warp is one contiguous run of the
//   (ncol, nlev, ng) outputs, each table read of a band's lanes one row.
//   The Planck fraction stays in a register.
// - The SW solar source per column (sfluxzen) is made by the block holding
//   the column's top layer: one thread per band finds the source layer (the
//   plain version's argmax searches) and the eta there, then one thread per
//   g-point interpolates and writes it (phase 3).
// Sums run in a fixed order, so two launches agree bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;          // (column, layer) rows of a block
constexpr int kThreads = 128;
constexpr int kNBandLw = 16, kNBandSw = 14;
// phase 1 takes one thread per (band, row)
static_assert(kNBandLw * kRows == kThreads && kNBandSw * kRows <= kThreads,
              "a thread per (band, row)");
constexpr int kNgLw = 140, kNgSw = 112;
// the most terms of a (row, band): LW band 5's lower atmosphere has 21 for
// od and 2 for the Planck fraction, SW band 24's 13 for od and 2 Rayleigh
constexpr int kMaxTermsLw = 24, kMaxTermsSw = 16;
// the tables' fixed dimensions (cuda_rrtmg._check_shape): pressures of the
// lower and upper tables, eta points, minor-gas temperatures, chi_mls
// pressures, TOTPLNK temperatures
constexpr int kNjpA = 13, kNjpB = 47, kNetaA = 9, kNetaB = 5;
constexpr int kNMinor = 19, kNChi = 59, kNPlanck = 181;
constexpr double kOneMinus = 1.0 - 1.0e-6;    // rrtmg_interp.ONEMINUS

// The float fields of rrtmg_prepare.GasColumns, in its order
// (cuda_rrtmg.FLOAT_FIELDS)
enum FField {
  F_PAVEL, F_TAVEL, F_COLDRY, F_COLBRD, F_COLH2O, F_COLCO2, F_COLO3,
  F_COLN2O, F_COLCH4, F_COLO2, F_COLMOL, F_WX_CCL4, F_WX_CFC11, F_WX_CFC12,
  F_WX_CFC22, F_FAC00, F_FAC01, F_FAC10, F_FAC11, F_SELFFAC, F_SELFFRAC,
  F_FORFAC, F_FORFRAC, F_SCALEMINOR, F_SCALEMINORN2, F_MINORFRAC,
  F_RAT_H2OCO2, F_RAT_H2OCO2_1, F_RAT_H2OO3, F_RAT_H2OO3_1, F_RAT_H2ON2O,
  F_RAT_H2ON2O_1, F_RAT_H2OCH4, F_RAT_H2OCH4_1, F_RAT_N2OCO2,
  F_RAT_N2OCO2_1, F_RAT_O3CO2, F_RAT_O3CO2_1, kNFField
};
// Its int64 indices (cuda_rrtmg.INT_FIELDS), then the bool tropo mask
enum IField {
  I_JP, I_JT, I_JT1, I_INDSELF, I_INDFOR, I_INDMINOR, I_TROPO, kNIField
};

// The slots of the packed tables (cuda_rrtmg.LW_SLOTS and SW_SLOTS): band
// b's table KEY is L<b>_KEY (LW) or S<b>_KEY (SW)
enum LwSlot {
  L1_KA, L1_KB, L1_SELFREF, L1_FORREF, L1_KA_MN2, L1_KB_MN2, L1_FRACREFA,
  L1_FRACREFB, L2_KA, L2_KB, L2_SELFREF, L2_FORREF, L2_FRACREFA, L2_FRACREFB,
  L3_KA, L3_KB, L3_SELFREF, L3_FORREF, L3_KA_MN2O, L3_KB_MN2O, L3_FRACREFA,
  L3_FRACREFB, L3_RP_A, L3_RP_B, L3_RM_A, L3_RM_B, L4_KA, L4_KB, L4_SELFREF,
  L4_FORREF, L4_FRACREFA, L4_FRACREFB, L4_RP_A, L4_RP_B, L4_CORR, L5_KA,
  L5_KB, L5_SELFREF, L5_FORREF, L5_KA_MO3, L5_CCL4, L5_FRACREFA, L5_FRACREFB,
  L5_RP_A, L5_RP_B, L5_RM_A, L6_KA, L6_SELFREF, L6_FORREF, L6_KA_MCO2,
  L6_CFC11ADJ, L6_CFC12, L6_FRACREFA, L7_KA, L7_KB, L7_SELFREF, L7_FORREF,
  L7_KA_MCO2, L7_KB_MCO2, L7_FRACREFA, L7_FRACREFB, L7_RP_A, L7_RM_A, L7_CORR,
  L8_KA, L8_KB, L8_SELFREF, L8_FORREF, L8_KA_MCO2, L8_KA_MO3, L8_KA_MN2O,
  L8_KB_MCO2, L8_KB_MN2O, L8_CFC12, L8_CFC22ADJ, L8_FRACREFA, L8_FRACREFB,
  L9_KA, L9_KB, L9_SELFREF, L9_FORREF, L9_KA_MN2O, L9_KB_MN2O, L9_FRACREFA,
  L9_FRACREFB, L9_RP_A, L9_RM_A, L10_KA, L10_KB, L10_SELFREF, L10_FORREF,
  L10_FRACREFA, L10_FRACREFB, L11_KA, L11_KB, L11_SELFREF, L11_FORREF,
  L11_KA_MO2, L11_KB_MO2, L11_FRACREFA, L11_FRACREFB, L12_KA, L12_SELFREF,
  L12_FORREF, L12_FRACREFA, L12_RP_A, L13_KA, L13_SELFREF, L13_FORREF,
  L13_KA_MCO2, L13_KB_MO3, L13_FRACREFA, L13_FRACREFB, L13_RP_A, L13_RM_A,
  L14_KA, L14_KB, L14_SELFREF, L14_FORREF, L14_FRACREFA, L14_FRACREFB, L15_KA,
  L15_SELFREF, L15_FORREF, L15_KA_MN2, L15_FRACREFA, L15_RP_A, L15_RM_A,
  L16_KA, L16_KB, L16_SELFREF, L16_FORREF, L16_FRACREFA, L16_FRACREFB,
  L16_RP_A, L_CHI_MLS, L_TOTPLNK, L_PLANCK_SCALE, kNLwSlot
};
enum SwSlot {
  S16_KA, S16_KB, S16_SELFREF, S16_FORREF, S16_SFLUXREF, S16_RAYL,
  S16_STRRAT1, S17_KA, S17_KB, S17_SELFREF, S17_FORREF, S17_SFLUXREF,
  S17_RAYL, S17_STRRAT, S17_LAYREFFR, S18_KA, S18_KB, S18_SELFREF, S18_FORREF,
  S18_SFLUXREF, S18_RAYL, S18_STRRAT, S18_LAYREFFR, S19_KA, S19_KB,
  S19_SELFREF, S19_FORREF, S19_SFLUXREF, S19_RAYL, S19_STRRAT, S19_LAYREFFR,
  S20_KA, S20_KB, S20_SELFREF, S20_FORREF, S20_SFLUXREF, S20_ABSCH4, S20_RAYL,
  S21_KA, S21_KB, S21_SELFREF, S21_FORREF, S21_SFLUXREF, S21_RAYL, S21_STRRAT,
  S21_LAYREFFR, S22_KA, S22_KB, S22_SELFREF, S22_FORREF, S22_SFLUXREF,
  S22_RAYL, S22_STRRAT, S22_LAYREFFR, S23_KA, S23_SELFREF, S23_FORREF,
  S23_SFLUXREF, S23_RAYL, S23_GIVFAC, S24_KA, S24_KB, S24_SELFREF, S24_FORREF,
  S24_SFLUXREF, S24_ABSO3A, S24_ABSO3B, S24_RAYLA, S24_RAYLB, S24_STRRAT,
  S24_LAYREFFR, S25_KA, S25_SFLUXREF, S25_RAYL, S25_ABSO3A, S25_ABSO3B,
  S26_SFLUXREF, S26_RAYL, S27_KA, S27_KB, S27_SFLUXREF, S27_RAYL,
  S27_SCALEKUR, S28_KA, S28_KB, S28_SFLUXREF, S28_RAYL, S28_STRRAT,
  S28_LAYREFFR, S29_KA, S29_KB, S29_SELFREF, S29_FORREF, S29_SFLUXREF,
  S29_ABSH2O, S29_ABSCO2, S29_RAYL, S_ONES, kNSwSlot
};

// Where the slots and bands lie (the tables' ``kernel:<set>_layout``)
template <int kNSlot, int kNBand> struct Layout {
  int off[kNSlot + 1];     // each slot's first entry, then the total
  int gstart[kNBand + 1];  // each band's first g-point, then ng
};
using LwLayout = Layout<kNLwSlot, kNBandLw>;
using SwLayout = Layout<kNSwSlot, kNBandSw>;

template <typename T> struct Cols {
  const T *f[kNFField];
  const long long *i[I_TROPO];
  const bool *tropo;
};

template <typename T> struct LwArgs {
  Cols<T> c;
  const T *t_hl, *t_skin, *pk;     // t_skin null without an emission
  T *od, *planck_hl, *emission;
  int ncol, nlev;
  T min_od;
  LwLayout lay;
};

template <typename T> struct SwArgs {
  Cols<T> c;
  const T *pk;
  T *od, *ssa, *sflux;
  int ncol, nlev;
  T min_od;
  SwLayout lay;
};

__device__ __forceinline__ float d_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double d_pow(double x, double y) {
  return pow(x, y);
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
// torch.clamp's bounds, which keep a NaN
template <typename T> __device__ __forceinline__ T clamp_min(T x, T lo) {
  return x < lo ? lo : x;
}
template <typename T> __device__ __forceinline__ T clamp_max(T x, T hi) {
  return x > hi ? hi : x;
}

// --- phase 0: the block's rows ----------------------------------------------

template <typename T> struct Stage {
  T f[kNFField][kRows];
  int i[kNIField][kRows];
  int col[kRows], lev[kRows];
};

template <typename T>
__device__ void stage_rows(const Cols<T> &c, int row0, int nrows, int nlev,
                           Stage<T> &s) {
  for (int k = threadIdx.x; k < kNFField * kRows; k += kThreads) {
    const int fld = k / kRows, r = k - fld * kRows, row = row0 + r;
    s.f[fld][r] = row < nrows ? c.f[fld][row] : T(0);
  }
  for (int k = threadIdx.x; k < kNIField * kRows; k += kThreads) {
    const int fld = k / kRows, r = k - fld * kRows, row = row0 + r;
    int v = 0;
    if (row < nrows)
      v = fld == I_TROPO ? (int)c.tropo[row] : (int)c.i[fld][row];
    s.i[fld][r] = v;
  }
  if (threadIdx.x < kRows) {
    const int row = row0 + threadIdx.x;
    s.col[threadIdx.x] = row / nlev;
    s.lev[threadIdx.x] = row - (row / nlev) * nlev;
  }
}

// one staged row's fields
template <typename T> struct Row {
  const Stage<T> &s;
  int r;
  __device__ T f(int k) const { return s.f[k][r]; }
  __device__ int i(int k) const { return s.i[k][r]; }
  __device__ bool lower() const { return s.i[I_TROPO][r] != 0; }
};

// --- phase 1: a (row, band)'s terms -----------------------------------------

// The terms of each (band, row) task: od's first, then the Planck
// fraction's (LW) or Rayleigh's (SW); mult a per-g factor's offset or -1
template <typename T, int kMax, int kTasks> struct Terms {
  int off[kMax][kTasks];
  T w[kMax][kTasks];
  int ntau[kTasks], nall[kTasks], mult[kTasks];
};

// rrtmg_interp.spec_setup
template <typename T> struct Spec {
  T comb, parm, fs;
  int js;
};

template <typename T>
__device__ __forceinline__ Spec<T> spec(int n_eta, T col1, T col2, T rat) {
  Spec<T> s;
  s.comb = col1 + rat * col2;
  s.parm = clamp_max(col1 / s.comb, T(kOneMinus));
  const T mult = T(n_eta) * s.parm;
  s.js = (int)mult;
  s.fs = mult - T(s.js);
  return s;
}

// One (band, row) task: appends the band's terms for the row, each the
// offset of a table row of ng entries and its weight.  The interpolations
// are rrtmg_interp's, with the factor the band function multiplies their
// sum by (a column amount, a correction) folded into the weights.
template <typename T, int kMax, int kTasks, class Lay> struct Task {
  using Real = T;
  const T *pk;
  const Lay &lay;
  Row<T> c;
  int ng;
  Terms<T, kMax, kTasks> &ts;
  int t, n;

  __device__ void add(int o, T w) {
    ts.off[n][t] = o;
    ts.w[n][t] = w;
    ++n;
  }
  __device__ void end_tau() { ts.ntau[t] = n; }
  __device__ void mult(int slot) { ts.mult[t] = lay.off[slot]; }
  __device__ int at(int slot) const { return lay.off[slot]; }
  __device__ T scalar(int slot) const { return pk[lay.off[slot]]; }
  // the rows of a slot's table
  __device__ int rows(int slot) const {
    return (lay.off[slot + 1] - lay.off[slot]) / ng;
  }
  // a per-g vector
  __device__ void vec(int slot, T scale) { add(at(slot), scale); }

  // major_1: one key species; the upper tables start at jp index 12
  __device__ void major1(int slot, bool upper, T scale) {
    const int off = upper ? 12 : 0, njp = upper ? kNjpB : kNjpA;
    const int jp = c.i(I_JP), jt = c.i(I_JT), jt1 = c.i(I_JT1);
    const int jp0 = clampi(jp - off, 0, njp - 1);
    const int jp1 = clampi(jp + 1 - off, 0, njp - 1);
    const int o = at(slot);
    add(o + (jp0 * 5 + jt) * ng, scale * c.f(F_FAC00));
    add(o + (jp0 * 5 + jt + 1) * ng, scale * c.f(F_FAC10));
    add(o + (jp1 * 5 + jt1) * ng, scale * c.f(F_FAC01));
    add(o + (jp1 * 5 + jt1 + 1) * ng, scale * c.f(F_FAC11));
  }

  // one pressure plane of major_2 (major_2_pairs side_pairs)
  __device__ void side(int o, int jp0, int jt, T fac_a, T fac_b,
                       const Spec<T> &sp, int njs, int nfl, bool edges) {
    const int base = (jp0 * 5 + jt) * njs;
    for (int djt = 0; djt < 2; ++djt) {
      const T w = sp.comb * (djt ? fac_b : fac_a);
      const int k = base + djt * njs + sp.js;
      if (edges && (sp.parm < T(0.125) || sp.parm > T(0.875))) {
        const bool hi = sp.parm > T(0.875);
        const T p = hi ? -sp.fs : sp.fs - T(1);
        const T p4 = (p * p) * (p * p);
        const int d0 = hi ? 1 : 0, d1 = hi ? 0 : 1, d2 = hi ? -1 : 2;
        add(o + clampi(k + d0, 0, nfl - 1) * ng, w * p4);
        add(o + clampi(k + d1, 0, nfl - 1) * ng,
            w * (T(1) - p - T(2) * p4));
        add(o + clampi(k + d2, 0, nfl - 1) * ng, w * (p + p4));
      } else {
        add(o + clampi(k, 0, nfl - 1) * ng, w * (T(1) - sp.fs));
        add(o + clampi(k + 1, 0, nfl - 1) * ng, w * sp.fs);
      }
    }
  }

  // major_2: two key species, each pressure plane with its own eta; the
  // lower tables' 9-point eta with the quartic edge weights, the upper's
  // 5-point eta linear
  __device__ void major2(int slot, bool upper, T col1, T col2, T rat0,
                         T rat1) {
    const int off = upper ? 12 : 0, njp = upper ? kNjpB : kNjpA;
    const int njs = upper ? kNetaB : kNetaA, nfl = njp * 5 * njs;
    const int jp = c.i(I_JP);
    side(at(slot), clampi(jp - off, 0, njp - 1), c.i(I_JT), c.f(F_FAC00),
         c.f(F_FAC10), spec(njs - 1, col1, col2, rat0), njs, nfl, !upper);
    side(at(slot), clampi(jp + 1 - off, 0, njp - 1), c.i(I_JT1),
         c.f(F_FAC01), c.f(F_FAC11), spec(njs - 1, col1, col2, rat1), njs,
         nfl, !upper);
  }

  // the SW two-species interpolation: one eta for both pressure planes,
  // no edge weights (rrtmg_sw._SwBand._major_2_shared_js); returns the eta
  __device__ Spec<T> major2s(int slot, bool upper, T col1, T col2, T rat) {
    const int off = upper ? 12 : 0, njp = upper ? kNjpB : kNjpA;
    const int njs = upper ? kNetaB : kNetaA, nfl = njp * 5 * njs;
    const Spec<T> sp = spec(njs - 1, col1, col2, rat);
    const int jp = c.i(I_JP), jt = c.i(I_JT), jt1 = c.i(I_JT1);
    const int jp0 = clampi(jp - off, 0, njp - 1);
    const int jp1 = clampi(jp + 1 - off, 0, njp - 1);
    const int o = at(slot);
    for (int djs = 0; djs < 2; ++djs) {
      const T fsw = djs ? sp.comb * sp.fs : sp.comb * (T(1) - sp.fs);
      const int k = sp.js + djs;
      add(o + clampi((jp0 * 5 + jt) * njs + k, 0, nfl - 1) * ng,
          fsw * c.f(F_FAC00));
      add(o + clampi((jp0 * 5 + jt + 1) * njs + k, 0, nfl - 1) * ng,
          fsw * c.f(F_FAC10));
      add(o + clampi((jp1 * 5 + jt1) * njs + k, 0, nfl - 1) * ng,
          fsw * c.f(F_FAC01));
      add(o + clampi((jp1 * 5 + jt1 + 1) * njs + k, 0, nfl - 1) * ng,
          fsw * c.f(F_FAC11));
    }
    return sp;
  }

  __device__ void self_cont(int slot, T scale) {
    const int o = at(slot), ind = c.i(I_INDSELF);
    const T f = c.f(F_SELFFAC), w1 = f * c.f(F_SELFFRAC);
    add(o + ind * ng, scale * (f - w1));
    add(o + (ind + 1) * ng, scale * w1);
  }

  __device__ void for_cont(int slot, T scale) {
    const int o = at(slot), n = rows(slot), ind = c.i(I_INDFOR);
    const T f = c.f(F_FORFAC), w1 = f * c.f(F_FORFRAC);
    add(o + clampi(ind, 0, n - 1) * ng, scale * (f - w1));
    add(o + clampi(ind + 1, 0, n - 1) * ng, scale * w1);
  }

  // minor_1 at unit scale, times scale
  __device__ void minor1(int slot, T scale) {
    const int o = at(slot), ind = c.i(I_INDMINOR);
    const T mf = c.f(F_MINORFRAC);
    add(o + ind * ng, scale * (T(1) - mf));
    add(o + (ind + 1) * ng, scale * mf);
  }

  // minor_2 at the eta of refrat on n_eta + 1 points, times scale
  __device__ void minor_eta(int slot, int n_eta, T col1, T col2, T refrat,
                            T scale) {
    const Spec<T> sp = spec(n_eta, col1, col2, refrat);
    const int njs = n_eta + 1, nfl = kNMinor * njs, o = at(slot);
    const int ind = c.i(I_INDMINOR);
    const T mf = c.f(F_MINORFRAC), fm = sp.fs;
    const int r00 = clampi(ind * njs + sp.js, 0, nfl - 1);
    const int r01 = clampi(ind * njs + sp.js + 1, 0, nfl - 1);
    const int r10 = clampi((ind + 1) * njs + sp.js, 0, nfl - 1);
    const int r11 = clampi((ind + 1) * njs + sp.js + 1, 0, nfl - 1);
    add(o + r00 * ng, scale * ((T(1) - mf) * (T(1) - fm)));
    add(o + r01 * ng, scale * ((T(1) - mf) * fm));
    add(o + r10 * ng, scale * (mf * (T(1) - fm)));
    add(o + r11 * ng, scale * (mf * fm));
  }

  // planck_frac_2: the Planck fraction at the eta of refrat
  __device__ void pfrac_eta(int slot, int n_eta, T col1, T col2, T refrat) {
    const Spec<T> sp = spec(n_eta, col1, col2, refrat);
    const int o = at(slot);
    add(o + sp.js * ng, T(1) - sp.fs);
    add(o + clampi(sp.js + 1, 0, n_eta) * ng, sp.fs);
  }

  // chi_mls(species, jp + 1), 1-based species (GasColumns.chi_jp1)
  __device__ T chi_ref(int species) const {
    return pk[lay.off[L_CHI_MLS] + (species - 1) * kNChi + c.i(I_JP) + 1];
  }
};

// rrtmg_lw._adjusted_column
template <typename T>
__device__ __forceinline__ T adjusted_column(T col, T coldry, T chi_ref,
                                             T thresh, T c0, T expo) {
  const T rat = T(1.0e20) * (col / coldry) / chi_ref;
  const T adjfac = c0 + d_pow(clamp_min(rat - c0, T(1e-30)), expo);
  return rat > thresh ? adjfac * chi_ref * coldry * T(1.0e-20) : col;
}

// --- the LW bands (rrtmg_lw.band1 ... band16) --------------------------------
// Each appends od's terms (end_tau), then the Planck fraction's.

template <class X> __device__ void lw_band1(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  const T p = c.f(F_PAVEL), h2o = c.f(F_COLH2O);
  const T scalen2 = c.f(F_COLBRD) * c.f(F_SCALEMINORN2);
  if (c.lower()) {
    const T cor =
        p < T(250) ? T(1) - T(0.15) * (T(250) - p) / T(154.4) : T(1);
    x.major1(L1_KA, false, cor * h2o);
    x.self_cont(L1_SELFREF, cor * h2o);
    x.for_cont(L1_FORREF, cor * h2o);
    x.minor1(L1_KA_MN2, cor * scalen2);
    x.end_tau();
    x.vec(L1_FRACREFA, T(1));
  } else {
    const T cor = T(1) - T(0.15) * (p / T(95.6));
    x.major1(L1_KB, true, cor * h2o);
    x.for_cont(L1_FORREF, cor * h2o);
    x.minor1(L1_KB_MN2, cor * scalen2);
    x.end_tau();
    x.vec(L1_FRACREFB, T(1));
  }
}

template <class X> __device__ void lw_band2(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  const T h2o = c.f(F_COLH2O);
  if (c.lower()) {
    const T cor = T(1) - T(0.05) * (c.f(F_PAVEL) - T(100)) / T(900);
    x.major1(L2_KA, false, cor * h2o);
    x.self_cont(L2_SELFREF, cor * h2o);
    x.for_cont(L2_FORREF, cor * h2o);
    x.end_tau();
    x.vec(L2_FRACREFA, T(1));
  } else {
    x.major1(L2_KB, true, h2o);
    x.for_cont(L2_FORREF, h2o);
    x.end_tau();
    x.vec(L2_FRACREFB, T(1));
  }
}

template <class X> __device__ void lw_band3(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  const T h2o = c.f(F_COLH2O), co2 = c.f(F_COLCO2);
  const T adjcoln2o = adjusted_column(c.f(F_COLN2O), c.f(F_COLDRY),
                                      x.chi_ref(4), T(1.5), T(0.5), T(0.65));
  if (c.lower()) {
    x.major2(L3_KA, false, h2o, co2, c.f(F_RAT_H2OCO2),
             c.f(F_RAT_H2OCO2_1));
    x.self_cont(L3_SELFREF, h2o);
    x.for_cont(L3_FORREF, h2o);
    x.minor_eta(L3_KA_MN2O, 8, h2o, co2, x.scalar(L3_RM_A), adjcoln2o);
    x.end_tau();
    x.pfrac_eta(L3_FRACREFA, 8, h2o, co2, x.scalar(L3_RP_A));
  } else {
    x.major2(L3_KB, true, h2o, co2, c.f(F_RAT_H2OCO2), c.f(F_RAT_H2OCO2_1));
    x.for_cont(L3_FORREF, h2o);
    x.minor_eta(L3_KB_MN2O, 4, h2o, co2, x.scalar(L3_RM_B), adjcoln2o);
    x.end_tau();
    x.pfrac_eta(L3_FRACREFB, 4, h2o, co2, x.scalar(L3_RP_B));
  }
}

template <class X> __device__ void lw_band4(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  const T h2o = c.f(F_COLH2O), co2 = c.f(F_COLCO2), o3 = c.f(F_COLO3);
  if (c.lower()) {
    x.major2(L4_KA, false, h2o, co2, c.f(F_RAT_H2OCO2),
             c.f(F_RAT_H2OCO2_1));
    x.self_cont(L4_SELFREF, h2o);
    x.for_cont(L4_FORREF, h2o);
    x.end_tau();
    x.pfrac_eta(L4_FRACREFA, 8, h2o, co2, x.scalar(L4_RP_A));
  } else {
    x.major2(L4_KB, true, o3, co2, c.f(F_RAT_O3CO2), c.f(F_RAT_O3CO2_1));
    x.mult(L4_CORR);
    x.end_tau();
    x.pfrac_eta(L4_FRACREFB, 4, o3, co2, x.scalar(L4_RP_B));
  }
}

template <class X> __device__ void lw_band5(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  const T h2o = c.f(F_COLH2O), co2 = c.f(F_COLCO2), o3 = c.f(F_COLO3);
  if (c.lower()) {
    x.major2(L5_KA, false, h2o, co2, c.f(F_RAT_H2OCO2),
             c.f(F_RAT_H2OCO2_1));
    x.self_cont(L5_SELFREF, h2o);
    x.for_cont(L5_FORREF, h2o);
    x.minor_eta(L5_KA_MO3, 8, h2o, co2, x.scalar(L5_RM_A), o3);
    x.vec(L5_CCL4, c.f(F_WX_CCL4));
    x.end_tau();
    x.pfrac_eta(L5_FRACREFA, 8, h2o, co2, x.scalar(L5_RP_A));
  } else {
    x.major2(L5_KB, true, o3, co2, c.f(F_RAT_O3CO2), c.f(F_RAT_O3CO2_1));
    x.vec(L5_CCL4, c.f(F_WX_CCL4));
    x.end_tau();
    x.pfrac_eta(L5_FRACREFB, 4, o3, co2, x.scalar(L5_RP_B));
  }
}

template <class X> __device__ void lw_band6(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  const T h2o = c.f(F_COLH2O);
  if (c.lower()) {
    const T adjcolco2 = adjusted_column(c.f(F_COLCO2), c.f(F_COLDRY),
                                        x.chi_ref(2), T(3), T(2), T(0.77));
    x.major1(L6_KA, false, h2o);
    x.self_cont(L6_SELFREF, h2o);
    x.for_cont(L6_FORREF, h2o);
    x.minor1(L6_KA_MCO2, adjcolco2);
  }
  x.vec(L6_CFC11ADJ, c.f(F_WX_CFC11));
  x.vec(L6_CFC12, c.f(F_WX_CFC12));
  x.end_tau();
  x.vec(L6_FRACREFA, T(1));
}

template <class X> __device__ void lw_band7(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  const T h2o = c.f(F_COLH2O), o3 = c.f(F_COLO3);
  if (c.lower()) {
    const T adj = adjusted_column(c.f(F_COLCO2), c.f(F_COLDRY),
                                  x.chi_ref(2), T(3), T(3), T(0.79));
    x.major2(L7_KA, false, h2o, o3, c.f(F_RAT_H2OO3), c.f(F_RAT_H2OO3_1));
    x.self_cont(L7_SELFREF, h2o);
    x.for_cont(L7_FORREF, h2o);
    x.minor_eta(L7_KA_MCO2, 8, h2o, o3, x.scalar(L7_RM_A), adj);
    x.end_tau();
    x.pfrac_eta(L7_FRACREFA, 8, h2o, o3, x.scalar(L7_RP_A));
  } else {
    const T adj = adjusted_column(c.f(F_COLCO2), c.f(F_COLDRY),
                                  x.chi_ref(2), T(3), T(2), T(0.79));
    x.major1(L7_KB, true, o3);
    x.minor1(L7_KB_MCO2, adj);
    x.mult(L7_CORR);
    x.end_tau();
    x.vec(L7_FRACREFB, T(1));
  }
}

template <class X> __device__ void lw_band8(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  const T h2o = c.f(F_COLH2O), o3 = c.f(F_COLO3), n2o = c.f(F_COLN2O);
  const T adjcolco2 = adjusted_column(c.f(F_COLCO2), c.f(F_COLDRY),
                                      x.chi_ref(2), T(3), T(2), T(0.65));
  if (c.lower()) {
    x.major1(L8_KA, false, h2o);
    x.self_cont(L8_SELFREF, h2o);
    x.for_cont(L8_FORREF, h2o);
    x.minor1(L8_KA_MCO2, adjcolco2);
    x.minor1(L8_KA_MO3, o3);
    x.minor1(L8_KA_MN2O, n2o);
  } else {
    x.major1(L8_KB, true, o3);
    x.minor1(L8_KB_MCO2, adjcolco2);
    x.minor1(L8_KB_MN2O, n2o);
  }
  x.vec(L8_CFC12, c.f(F_WX_CFC12));
  x.vec(L8_CFC22ADJ, c.f(F_WX_CFC22));
  x.end_tau();
  x.vec(c.lower() ? L8_FRACREFA : L8_FRACREFB, T(1));
}

template <class X> __device__ void lw_band9(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  const T h2o = c.f(F_COLH2O), ch4 = c.f(F_COLCH4);
  const T adjcoln2o = adjusted_column(c.f(F_COLN2O), c.f(F_COLDRY),
                                      x.chi_ref(4), T(1.5), T(0.5), T(0.65));
  if (c.lower()) {
    x.major2(L9_KA, false, h2o, ch4, c.f(F_RAT_H2OCH4),
             c.f(F_RAT_H2OCH4_1));
    x.self_cont(L9_SELFREF, h2o);
    x.for_cont(L9_FORREF, h2o);
    x.minor_eta(L9_KA_MN2O, 8, h2o, ch4, x.scalar(L9_RM_A), adjcoln2o);
    x.end_tau();
    x.pfrac_eta(L9_FRACREFA, 8, h2o, ch4, x.scalar(L9_RP_A));
  } else {
    x.major1(L9_KB, true, ch4);
    x.minor1(L9_KB_MN2O, adjcoln2o);
    x.end_tau();
    x.vec(L9_FRACREFB, T(1));
  }
}

template <class X> __device__ void lw_band10(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  const T h2o = c.f(F_COLH2O);
  if (c.lower()) {
    x.major1(L10_KA, false, h2o);
    x.self_cont(L10_SELFREF, h2o);
    x.for_cont(L10_FORREF, h2o);
    x.end_tau();
    x.vec(L10_FRACREFA, T(1));
  } else {
    x.major1(L10_KB, true, h2o);
    x.for_cont(L10_FORREF, h2o);
    x.end_tau();
    x.vec(L10_FRACREFB, T(1));
  }
}

template <class X> __device__ void lw_band11(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  const T h2o = c.f(F_COLH2O);
  const T scaleo2 = c.f(F_COLO2) * c.f(F_SCALEMINOR);
  if (c.lower()) {
    x.major1(L11_KA, false, h2o);
    x.self_cont(L11_SELFREF, h2o);
    x.for_cont(L11_FORREF, h2o);
    x.minor1(L11_KA_MO2, scaleo2);
    x.end_tau();
    x.vec(L11_FRACREFA, T(1));
  } else {
    x.major1(L11_KB, true, h2o);
    x.for_cont(L11_FORREF, h2o);
    x.minor1(L11_KB_MO2, scaleo2);
    x.end_tau();
    x.vec(L11_FRACREFB, T(1));
  }
}

// the upper atmosphere has no absorption here and a zero Planck fraction
template <class X> __device__ void lw_band12(X &x) {
  const auto &c = x.c;
  if (c.lower()) {
    const auto h2o = c.f(F_COLH2O), co2 = c.f(F_COLCO2);
    x.major2(L12_KA, false, h2o, co2, c.f(F_RAT_H2OCO2),
             c.f(F_RAT_H2OCO2_1));
    x.self_cont(L12_SELFREF, h2o);
    x.for_cont(L12_FORREF, h2o);
    x.end_tau();
    x.pfrac_eta(L12_FRACREFA, 8, h2o, co2, x.scalar(L12_RP_A));
  } else {
    x.end_tau();
  }
}

template <class X> __device__ void lw_band13(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  const T h2o = c.f(F_COLH2O), n2o = c.f(F_COLN2O);
  if (c.lower()) {
    // CO2 adjusted against a fixed chi of 3.55e-4 (rrtm_taumol13.F90)
    const T co2 = c.f(F_COLCO2), coldry = c.f(F_COLDRY);
    const T rat = T(1.0e20) * (co2 / coldry) / T(3.55e-4);
    const T adjfac = T(2) + d_pow(clamp_min(rat - T(2), T(1e-30)), T(0.68));
    const T adjcolco2 =
        rat > T(3) ? adjfac * T(3.55e-4) * coldry * T(1.0e-20) : co2;
    x.major2(L13_KA, false, h2o, n2o, c.f(F_RAT_H2ON2O),
             c.f(F_RAT_H2ON2O_1));
    x.self_cont(L13_SELFREF, h2o);
    x.for_cont(L13_FORREF, h2o);
    x.minor_eta(L13_KA_MCO2, 8, h2o, n2o, x.scalar(L13_RM_A), adjcolco2);
    x.end_tau();
    x.pfrac_eta(L13_FRACREFA, 8, h2o, n2o, x.scalar(L13_RP_A));
  } else {
    x.minor1(L13_KB_MO3, c.f(F_COLO3));
    x.end_tau();
    x.vec(L13_FRACREFB, T(1));
  }
}

template <class X> __device__ void lw_band14(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  const T h2o = c.f(F_COLH2O), co2 = c.f(F_COLCO2);
  if (c.lower()) {
    x.major1(L14_KA, false, co2);
    x.self_cont(L14_SELFREF, h2o);
    x.for_cont(L14_FORREF, h2o);
    x.end_tau();
    x.vec(L14_FRACREFA, T(1));
  } else {
    x.major1(L14_KB, true, co2);
    x.end_tau();
    x.vec(L14_FRACREFB, T(1));
  }
}

template <class X> __device__ void lw_band15(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  if (c.lower()) {
    const T h2o = c.f(F_COLH2O), n2o = c.f(F_COLN2O), co2 = c.f(F_COLCO2);
    const T scalen2 = c.f(F_COLBRD) * c.f(F_SCALEMINOR);
    x.major2(L15_KA, false, n2o, co2, c.f(F_RAT_N2OCO2),
             c.f(F_RAT_N2OCO2_1));
    x.self_cont(L15_SELFREF, h2o);
    x.for_cont(L15_FORREF, h2o);
    x.minor_eta(L15_KA_MN2, 8, n2o, co2, x.scalar(L15_RM_A), scalen2);
    x.end_tau();
    x.pfrac_eta(L15_FRACREFA, 8, n2o, co2, x.scalar(L15_RP_A));
  } else {
    x.end_tau();
  }
}

template <class X> __device__ void lw_band16(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  const T h2o = c.f(F_COLH2O), ch4 = c.f(F_COLCH4);
  if (c.lower()) {
    x.major2(L16_KA, false, h2o, ch4, c.f(F_RAT_H2OCH4),
             c.f(F_RAT_H2OCH4_1));
    x.self_cont(L16_SELFREF, h2o);
    x.for_cont(L16_FORREF, h2o);
    x.end_tau();
    x.pfrac_eta(L16_FRACREFA, 8, h2o, ch4, x.scalar(L16_RP_A));
  } else {
    x.major1(L16_KB, true, ch4);
    x.end_tau();
    x.vec(L16_FRACREFB, T(1));
  }
}

template <class X> __device__ void lw_band(int b, X &x) {
  switch (b) {
    case 0: lw_band1(x); break;
    case 1: lw_band2(x); break;
    case 2: lw_band3(x); break;
    case 3: lw_band4(x); break;
    case 4: lw_band5(x); break;
    case 5: lw_band6(x); break;
    case 6: lw_band7(x); break;
    case 7: lw_band8(x); break;
    case 8: lw_band9(x); break;
    case 9: lw_band10(x); break;
    case 10: lw_band11(x); break;
    case 11: lw_band12(x); break;
    case 12: lw_band13(x); break;
    case 13: lw_band14(x); break;
    case 14: lw_band15(x); break;
    default: lw_band16(x); break;
  }
}

// --- the SW bands (rrtmg_sw._band16 ... _band29) -----------------------------
// Each appends od's terms (end_tau), then Rayleigh's.

template <class X> __device__ void sw_band16(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  const T h2o = c.f(F_COLH2O);
  if (c.lower()) {
    x.major2s(S16_KA, false, h2o, c.f(F_COLCH4), x.scalar(S16_STRRAT1));
    x.self_cont(S16_SELFREF, h2o);
    x.for_cont(S16_FORREF, h2o);
  } else {
    x.major1(S16_KB, true, c.f(F_COLCH4));
  }
  x.end_tau();
  x.vec(S16_RAYL, c.f(F_COLMOL));
}

template <class X> __device__ void sw_band17(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  const T h2o = c.f(F_COLH2O), co2 = c.f(F_COLCO2);
  if (c.lower()) {
    x.major2s(S17_KA, false, h2o, co2, x.scalar(S17_STRRAT));
    x.self_cont(S17_SELFREF, h2o);
  } else {
    x.major2s(S17_KB, true, h2o, co2, x.scalar(S17_STRRAT));
  }
  x.for_cont(S17_FORREF, h2o);
  x.end_tau();
  x.vec(S17_RAYL, c.f(F_COLMOL));
}

template <class X> __device__ void sw_band18(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  const T h2o = c.f(F_COLH2O), ch4 = c.f(F_COLCH4);
  if (c.lower()) {
    x.major2s(S18_KA, false, h2o, ch4, x.scalar(S18_STRRAT));
    x.self_cont(S18_SELFREF, h2o);
    x.for_cont(S18_FORREF, h2o);
  } else {
    x.major1(S18_KB, true, ch4);
  }
  x.end_tau();
  x.vec(S18_RAYL, c.f(F_COLMOL));
}

template <class X> __device__ void sw_band19(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  const T h2o = c.f(F_COLH2O), co2 = c.f(F_COLCO2);
  if (c.lower()) {
    x.major2s(S19_KA, false, h2o, co2, x.scalar(S19_STRRAT));
    x.self_cont(S19_SELFREF, h2o);
    x.for_cont(S19_FORREF, h2o);
  } else {
    x.major1(S19_KB, true, co2);
  }
  x.end_tau();
  x.vec(S19_RAYL, c.f(F_COLMOL));
}

template <class X> __device__ void sw_band20(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  const T h2o = c.f(F_COLH2O);
  if (c.lower()) {
    x.major1(S20_KA, false, h2o);
    x.self_cont(S20_SELFREF, h2o);
  } else {
    x.major1(S20_KB, true, h2o);
  }
  x.for_cont(S20_FORREF, h2o);
  x.vec(S20_ABSCH4, c.f(F_COLCH4));
  x.end_tau();
  x.vec(S20_RAYL, c.f(F_COLMOL));
}

template <class X> __device__ void sw_band21(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  const T h2o = c.f(F_COLH2O), co2 = c.f(F_COLCO2);
  if (c.lower()) {
    x.major2s(S21_KA, false, h2o, co2, x.scalar(S21_STRRAT));
    x.self_cont(S21_SELFREF, h2o);
  } else {
    x.major2s(S21_KB, true, h2o, co2, x.scalar(S21_STRRAT));
  }
  x.for_cont(S21_FORREF, h2o);
  x.end_tau();
  x.vec(S21_RAYL, c.f(F_COLMOL));
}

// S22_STRRAT holds o2adj * strrat, o2adj = 1.6
template <class X> __device__ void sw_band22(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  const T h2o = c.f(F_COLH2O), o2 = c.f(F_COLO2);
  const T o2cont = T(4.35e-4) * o2 / T(700);
  if (c.lower()) {
    x.major2s(S22_KA, false, h2o, o2, x.scalar(S22_STRRAT));
    x.self_cont(S22_SELFREF, h2o);
    x.for_cont(S22_FORREF, h2o);
  } else {
    x.major1(S22_KB, true, o2 * T(1.6));
  }
  x.vec(S_ONES, o2cont);
  x.end_tau();
  x.vec(S22_RAYL, c.f(F_COLMOL));
}

template <class X> __device__ void sw_band23(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  if (c.lower()) {
    const T h2o = c.f(F_COLH2O);
    x.major1(S23_KA, false, x.scalar(S23_GIVFAC) * h2o);
    x.self_cont(S23_SELFREF, h2o);
    x.for_cont(S23_FORREF, h2o);
  }
  x.end_tau();
  x.vec(S23_RAYL, c.f(F_COLMOL));
}

template <class X> __device__ void sw_band24(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  const T h2o = c.f(F_COLH2O), o2 = c.f(F_COLO2), o3 = c.f(F_COLO3);
  const T colmol = c.f(F_COLMOL);
  if (c.lower()) {
    const Spec<T> sp = x.major2s(S24_KA, false, h2o, o2,
                                 x.scalar(S24_STRRAT));
    x.vec(S24_ABSO3A, o3);
    x.self_cont(S24_SELFREF, h2o);
    x.for_cont(S24_FORREF, h2o);
    x.end_tau();
    // Rayleigh interpolated in eta (RAYLA), at the major absorption's eta
    const int o = x.at(S24_RAYLA);
    x.add(o + sp.js * x.ng, colmol * (T(1) - sp.fs));
    x.add(o + clampi(sp.js + 1, 0, kNetaA - 1) * x.ng, colmol * sp.fs);
  } else {
    x.major1(S24_KB, true, o2);
    x.vec(S24_ABSO3B, o3);
    x.end_tau();
    x.vec(S24_RAYLB, colmol);
  }
}

template <class X> __device__ void sw_band25(X &x) {
  const auto &c = x.c;
  if (c.lower()) {
    x.major1(S25_KA, false, c.f(F_COLH2O));
    x.vec(S25_ABSO3A, c.f(F_COLO3));
  } else {
    x.vec(S25_ABSO3B, c.f(F_COLO3));
  }
  x.end_tau();
  x.vec(S25_RAYL, c.f(F_COLMOL));
}

// Rayleigh scattering only
template <class X> __device__ void sw_band26(X &x) {
  x.end_tau();
  x.vec(S26_RAYL, x.c.f(F_COLMOL));
}

template <class X> __device__ void sw_band27(X &x) {
  const auto &c = x.c;
  x.major1(c.lower() ? S27_KA : S27_KB, !c.lower(), c.f(F_COLO3));
  x.end_tau();
  x.vec(S27_RAYL, c.f(F_COLMOL));
}

template <class X> __device__ void sw_band28(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  const T o3 = c.f(F_COLO3), o2 = c.f(F_COLO2);
  x.major2s(c.lower() ? S28_KA : S28_KB, !c.lower(), o3, o2,
            x.scalar(S28_STRRAT));
  x.end_tau();
  x.vec(S28_RAYL, c.f(F_COLMOL));
}

template <class X> __device__ void sw_band29(X &x) {
  using T = typename X::Real;
  const auto &c = x.c;
  const T h2o = c.f(F_COLH2O), co2 = c.f(F_COLCO2);
  if (c.lower()) {
    x.major1(S29_KA, false, h2o);
    x.self_cont(S29_SELFREF, h2o);
    x.for_cont(S29_FORREF, h2o);
    x.vec(S29_ABSCO2, co2);
  } else {
    x.major1(S29_KB, true, co2);
    x.vec(S29_ABSH2O, h2o);
  }
  x.end_tau();
  x.vec(S29_RAYL, c.f(F_COLMOL));
}

template <class X> __device__ void sw_band(int b, X &x) {
  switch (b) {
    case 0: sw_band16(x); break;
    case 1: sw_band17(x); break;
    case 2: sw_band18(x); break;
    case 3: sw_band19(x); break;
    case 4: sw_band20(x); break;
    case 5: sw_band21(x); break;
    case 6: sw_band22(x); break;
    case 7: sw_band23(x); break;
    case 8: sw_band24(x); break;
    case 9: sw_band25(x); break;
    case 10: sw_band26(x); break;
    case 11: sw_band27(x); break;
    case 12: sw_band28(x); break;
    default: sw_band29(x); break;
  }
}

// --- the SW solar source (rrtmg_sw._SwBand.solfr_* and sflux_eta) ------------

// The top-down index of a column's solar-source layer for a band whose
// reference level lies in the lower (upper = false) or upper atmosphere:
// the first layer at or above reference level layreffr whose layer below
// is under it (and in the lower atmosphere, for the lower case), or else
// the topmost lower-atmosphere layer (lower case) or the top layer; in the
// lower case never above the topmost lower-atmosphere layer
template <typename T>
__device__ int solar_layer(const Cols<T> &c, int col, int nlev, int layreffr,
                           bool upper) {
  const long long *jp = c.i[I_JP] + (size_t)col * nlev;
  const bool *tropo = c.tropo + (size_t)col * nlev;
  int ktop = -1, kcross = -1;
  for (int k = 0; k < nlev && (kcross < 0 || ktop < 0); ++k) {
    const int kb = k + 1 < nlev ? k + 1 : nlev - 1;
    if (ktop < 0 && tropo[k]) ktop = k;
    const bool here = upper ? !tropo[k] : tropo[kb];
    if (kcross < 0 && here && (int)jp[k] + 1 >= layreffr &&
        (int)jp[kb] + 1 < layreffr)
      kcross = k;
  }
  if (upper) return kcross >= 0 ? kcross : 0;
  if (ktop < 0) ktop = 0;
  const int k = kcross >= 0 ? kcross : ktop;
  return k > ktop ? k : ktop;
}

// The eta index and fraction of band b's (0 = band 16) solar source for a
// column, or js = -1 where the band's source is its sfluxref as it is
template <typename T>
__device__ void solar_eta(const SwArgs<T> &a, int b, int col, int &js,
                          T &fs) {
  int f1 = F_COLH2O, f2, rat, layreffr;
  bool upper = false;
  switch (b) {
    case 1: f2 = F_COLCO2; rat = S17_STRRAT; layreffr = S17_LAYREFFR;
            upper = true; break;
    case 2: f2 = F_COLCH4; rat = S18_STRRAT; layreffr = S18_LAYREFFR; break;
    case 3: f2 = F_COLCO2; rat = S19_STRRAT; layreffr = S19_LAYREFFR; break;
    case 5: f2 = F_COLCO2; rat = S21_STRRAT; layreffr = S21_LAYREFFR; break;
    case 6: f2 = F_COLO2; rat = S22_STRRAT; layreffr = S22_LAYREFFR; break;
    case 8: f2 = F_COLO2; rat = S24_STRRAT; layreffr = S24_LAYREFFR; break;
    case 12: f1 = F_COLO3; f2 = F_COLO2; rat = S28_STRRAT;
             layreffr = S28_LAYREFFR; upper = true; break;
    default: js = -1; fs = T(0); return;
  }
  const T *pk = a.pk;
  const int k = solar_layer(a.c, col, a.nlev, (int)pk[a.lay.off[layreffr]],
                            upper);
  const size_t row = (size_t)col * a.nlev + k;
  const Spec<T> sp = spec(upper ? kNetaB - 1 : kNetaA - 1, a.c.f[f1][row],
                          a.c.f[f2][row], pk[a.lay.off[rat]]);
  js = sp.js;
  fs = sp.fs;
}

// band b's (0 = band 16) SFLUXREF slot
__device__ __forceinline__ int sfluxref_slot(int b) {
  switch (b) {
    case 0: return S16_SFLUXREF;
    case 1: return S17_SFLUXREF;
    case 2: return S18_SFLUXREF;
    case 3: return S19_SFLUXREF;
    case 4: return S20_SFLUXREF;
    case 5: return S21_SFLUXREF;
    case 6: return S22_SFLUXREF;
    case 7: return S23_SFLUXREF;
    case 8: return S24_SFLUXREF;
    case 9: return S25_SFLUXREF;
    case 10: return S26_SFLUXREF;
    case 11: return S27_SFLUXREF;
    case 12: return S28_SFLUXREF;
    default: return S29_SFLUXREF;
  }
}

// --- the kernels ------------------------------------------------------------

// The phase-2 sum of a task's terms [k0, k1) at the band's g-point gi
template <typename T, int kMax, int kTasks>
__device__ __forceinline__ T sum_terms(const Terms<T, kMax, kTasks> &ts,
                                       const T *__restrict__ pk, int t, int k0,
                                       int k1, int gi) {
  T acc = T(0);
#pragma unroll 4
  for (int k = k0; k < k1; ++k) acc += ts.w[k][t] * pk[ts.off[k][t] + gi];
  return acc;
}

// each g-point's band
template <int kNBand, int kNg>
__device__ void band_of_g(const int *gstart, unsigned char *bog) {
  for (int g = threadIdx.x; g < kNg; g += kThreads) {
    int b = 0;
    while (b + 1 < kNBand && gstart[b + 1] <= g) ++b;
    bog[g] = (unsigned char)b;
  }
}

// TOTPLNK interpolation (cuda_rrtmg._planck_store) of band b at t
template <typename T>
__device__ T planck_band(const T *pk, const LwLayout &lay, int b, T t) {
  int ind;
  T frac;
  if (t >= T(339)) {
    ind = 180;
    frac = t - T(339);
  } else if (t < T(160)) {
    ind = 1;
    frac = T(0);
  } else {
    ind = (int)floor(t - T(159));
    frac = t - floor(t);
  }
  ind -= 1;
  const int ind1 = clampi(ind + 1, 0, kNPlanck - 1);
  const T *tp = pk + lay.off[L_TOTPLNK];
  const T p = (T(1) - frac) * tp[ind * kNBandLw + b] +
              frac * tp[ind1 * kNBandLw + b];
  return pk[lay.off[L_PLANCK_SCALE] + b] * p;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rrtmg_lw_taumol_kernel(const LwArgs<T> a) {
  constexpr int kTasks = kNBandLw * kRows;
  __shared__ Stage<T> s;
  __shared__ Terms<T, kMaxTermsLw, kTasks> ts;
  __shared__ T planck[3][kTasks];    // half level below, top, surface
  __shared__ unsigned char bog[kNgLw];
  const int nlev = a.nlev, nrows = a.ncol * nlev;
  const int row0 = blockIdx.x * kRows;
  stage_rows(a.c, row0, nrows, nlev, s);
  band_of_g<kNBandLw, kNgLw>(a.lay.gstart, bog);
  __syncthreads();

  {  // phase 1: one thread per (band, row)
    const int t = threadIdx.x, b = t / kRows, r = t - b * kRows;
    ts.ntau[t] = ts.nall[t] = 0;
    ts.mult[t] = -1;
    if (row0 + r < nrows) {
      Task<T, kMaxTermsLw, kTasks, LwLayout> x{
          a.pk, a.lay, Row<T>{s, r},
          a.lay.gstart[b + 1] - a.lay.gstart[b], ts, t, 0};
      lw_band(b, x);
      ts.nall[t] = x.n;
      const int col = s.col[r], lev = s.lev[r];
      const T *thl = a.t_hl + (size_t)col * (nlev + 1);
      planck[0][t] = planck_band(a.pk, a.lay, b, thl[lev + 1]);
      if (lev == 0) planck[1][t] = planck_band(a.pk, a.lay, b, thl[0]);
      if (lev == nlev - 1 && a.emission)
        planck[2][t] = planck_band(a.pk, a.lay, b, a.t_skin[col]);
    }
  }
  __syncthreads();

  // phase 2: one thread per (row, g-point)
  for (int e = threadIdx.x; e < kRows * kNgLw; e += kThreads) {
    const int r = e / kNgLw, g = e - r * kNgLw, row = row0 + r;
    if (row >= nrows) break;
    const int b = bog[g], gi = g - a.lay.gstart[b], t = b * kRows + r;
    T tau = sum_terms(ts, a.pk, t, 0, ts.ntau[t], gi);
    if (ts.mult[t] >= 0) tau *= a.pk[ts.mult[t] + gi];
    const T pfrac = sum_terms(ts, a.pk, t, ts.ntau[t], ts.nall[t], gi);
    a.od[(size_t)row * kNgLw + g] = clamp_min(tau, a.min_od);
    const int col = s.col[r], lev = s.lev[r];
    T *hl = a.planck_hl + (size_t)col * (nlev + 1) * kNgLw + g;
    hl[(size_t)(lev + 1) * kNgLw] = planck[0][t] * pfrac;
    if (lev == 0) hl[0] = planck[1][t] * pfrac;
    if (lev == nlev - 1 && a.emission)
      a.emission[(size_t)col * kNgLw + g] = planck[2][t] * pfrac;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rrtmg_sw_taumol_kernel(const SwArgs<T> a) {
  constexpr int kTasks = kNBandSw * kRows;
  __shared__ Stage<T> s;
  __shared__ Terms<T, kMaxTermsSw, kTasks> ts;
  __shared__ unsigned char bog[kNgSw];
  __shared__ int sol_js[kRows][kNBandSw];
  __shared__ T sol_fs[kRows][kNBandSw];
  const int nlev = a.nlev, nrows = a.ncol * nlev;
  const int row0 = blockIdx.x * kRows;
  stage_rows(a.c, row0, nrows, nlev, s);
  band_of_g<kNBandSw, kNgSw>(a.lay.gstart, bog);
  __syncthreads();

  if (threadIdx.x < kTasks) {  // phase 1: one thread per (band, row)
    const int t = threadIdx.x, b = t / kRows, r = t - b * kRows;
    ts.ntau[t] = ts.nall[t] = 0;
    ts.mult[t] = -1;
    if (row0 + r < nrows) {
      Task<T, kMaxTermsSw, kTasks, SwLayout> x{
          a.pk, a.lay, Row<T>{s, r},
          a.lay.gstart[b + 1] - a.lay.gstart[b], ts, t, 0};
      sw_band(b, x);
      ts.nall[t] = x.n;
    }
  }
  __syncthreads();

  // phase 2: one thread per (row, g-point)
  for (int e = threadIdx.x; e < kRows * kNgSw; e += kThreads) {
    const int r = e / kNgSw, g = e - r * kNgSw, row = row0 + r;
    if (row >= nrows) break;
    const int b = bog[g], gi = g - a.lay.gstart[b], t = b * kRows + r;
    const T taug = sum_terms(ts, a.pk, t, 0, ts.ntau[t], gi);
    const T taur = sum_terms(ts, a.pk, t, ts.ntau[t], ts.nall[t], gi);
    const T od = taur + taug;
    const size_t i = (size_t)row * kNgSw + g;
    a.od[i] = clamp_min(od, a.min_od);
    a.ssa[i] = taur / od;
  }

  // phase 3: the solar source of the columns whose top layer is here
  const int col0 = (row0 + nlev - 1) / nlev;
  const int col1 = min(a.ncol, (row0 + kRows - 1) / nlev + 1);
  if (col0 >= col1) return;   // the same for the whole block
  for (int t = threadIdx.x; t < (col1 - col0) * kNBandSw; t += kThreads) {
    const int j = t / kNBandSw, b = t - j * kNBandSw;
    solar_eta(a, b, col0 + j, sol_js[j][b], sol_fs[j][b]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < (col1 - col0) * kNgSw; e += kThreads) {
    const int j = e / kNgSw, g = e - j * kNgSw, b = bog[g];
    const int ng = a.lay.gstart[b + 1] - a.lay.gstart[b];
    const int gi = g - a.lay.gstart[b];
    const int slot = sfluxref_slot(b);
    const T *ref = a.pk + a.lay.off[slot];
    const int js = sol_js[j][b];
    T v;
    if (js < 0) {
      v = ref[gi];
      if (b == 11) v *= a.pk[a.lay.off[S27_SCALEKUR]];
    } else {
      const int njs = (a.lay.off[slot + 1] - a.lay.off[slot]) / ng;
      const T f0 = ref[js * ng + gi];
      const T f1 = ref[clampi(js + 1, 0, njs - 1) * ng + gi];
      v = f0 + sol_fs[j][b] * (f1 - f0);
    }
    a.sflux[(size_t)(col0 + j) * kNgSw + g] = v;
  }
}

template <typename T> void read_cols(void *const *p, int &k, Cols<T> &c) {
  for (int f = 0; f < kNFField; ++f) c.f[f] = (const T *)p[k++];
  for (int f = 0; f < I_TROPO; ++f) c.i[f] = (const long long *)p[k++];
  c.tropo = (const bool *)p[k++];
}

template <typename T>
int launch_lw(void *const *p, const int *layout, int ncol, int nlev,
              double min_od, void *stream) {
  LwArgs<T> a;
  int k = 0;
  read_cols(p, k, a.c);
  a.t_hl = (const T *)p[k++];
  a.t_skin = (const T *)p[k++];
  a.pk = (const T *)p[k++];
  a.od = (T *)p[k++];
  a.planck_hl = (T *)p[k++];
  a.emission = (T *)p[k++];
  a.ncol = ncol;
  a.nlev = nlev;
  a.min_od = (T)min_od;
  for (int i = 0; i <= kNLwSlot; ++i) a.lay.off[i] = layout[i];
  for (int i = 0; i <= kNBandLw; ++i)
    a.lay.gstart[i] = layout[kNLwSlot + 1 + i];
  const int blocks = (ncol * nlev + kRows - 1) / kRows;
  rrtmg_lw_taumol_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sw(void *const *p, const int *layout, int ncol, int nlev,
              double min_od, void *stream) {
  SwArgs<T> a;
  int k = 0;
  read_cols(p, k, a.c);
  a.pk = (const T *)p[k++];
  a.od = (T *)p[k++];
  a.ssa = (T *)p[k++];
  a.sflux = (T *)p[k++];
  a.ncol = ncol;
  a.nlev = nlev;
  a.min_od = (T)min_od;
  for (int i = 0; i <= kNSwSlot; ++i) a.lay.off[i] = layout[i];
  for (int i = 0; i <= kNBandSw; ++i)
    a.lay.gstart[i] = layout[kNSwSlot + 1 + i];
  const int blocks = (ncol * nlev + kRows - 1) / kRows;
  rrtmg_sw_taumol_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// p: the GasColumns fields (FField, then IField order), temperature_hl,
// skin_temperature (or null), the packed tables, od, planck_hl, emission
// (or null); layout: the tables' kernel:lw_layout
int ecrad_rrtmg_lw_taumol_f32(void *const *p, const int *layout, int ncol,
                              int nlev, double min_od, void *stream) {
  return launch_lw<float>(p, layout, ncol, nlev, min_od, stream);
}

int ecrad_rrtmg_lw_taumol_f64(void *const *p, const int *layout, int ncol,
                              int nlev, double min_od, void *stream) {
  return launch_lw<double>(p, layout, ncol, nlev, min_od, stream);
}

// p: the GasColumns fields, the packed tables, od, ssa, sfluxzen; layout:
// the tables' kernel:sw_layout
int ecrad_rrtmg_sw_taumol_f32(void *const *p, const int *layout, int ncol,
                              int nlev, double min_od, void *stream) {
  return launch_sw<float>(p, layout, ncol, nlev, min_od, stream);
}

int ecrad_rrtmg_sw_taumol_f64(void *const *p, const int *layout, int ncol,
                              int nlev, double min_od, void *stream) {
  return launch_sw<double>(p, layout, ncol, nlev, min_od, stream);
}

}  // extern "C"
