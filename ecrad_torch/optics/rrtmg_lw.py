"""RRTMG longwave gas optical depths + Planck fractions (140 g-points).

Port of ``ecrad_tpu/optics/rrtmg_lw.py``: the 16 band kernels
ifsrrtm/rrtm_taumol1.F90 ... rrtm_taumol16.F90 as torch gathers over
(ncol, nlev), with the per-band g-points concatenated to the full
140-point spectral axis.  The reference's per-layer IF(JLAY<=LAYTROP)
split becomes a masked select between the lower- and upper-atmosphere
formulations.

Band structure (rrtm_taumol*.F90 headers):
   1:  10-350    H2O (minor N2)               9: 1180-1390  H2O,CH4 (m N2O)
   2: 350-500    H2O                         10: 1390-1480  H2O
   3: 500-630    H2O,CO2 (minor N2O)         11: 1480-1800  H2O (minor O2)
   4: 630-700    H2O,CO2 / O3,CO2            12: 1800-2080  H2O,CO2
   5: 700-820    H2O,CO2 (m O3,CCL4)         13: 2080-2250  H2O,N2O (m CO2,CO)
   6: 820-980    H2O (m CO2,CFC11,CFC12)     14: 2250-2380  CO2
   7: 980-1080   H2O,O3 (minor CO2)          15: 2380-2600  N2O,CO2 (m N2)
   8: 1080-1180  H2O/O3 (m CO2,O3,N2O,CFCs)  16: 2600-3250  H2O,CH4 / CH4
"""

from __future__ import annotations

import numpy as np
import torch

from ecrad_torch.optics import rrtmg_interp as ri
from ecrad_torch.optics.rrtmg_prepare import GasColumns


# ---------------------------------------------------------------------------
# Table preparation (host-side, once at setup)

def build_lw_tables(raw: dict) -> dict:
    """Reshape extracted tables into gather-friendly layouts.

    raw: dict from rrtmg_data.load_tables(). Returns a flat dict of numpy
    arrays (converted to tensors by the caller)."""
    t = {}
    for b in range(1, 17):
        p = f"lw{b:02d}/"
        for name, arr in raw.items():
            if not name.startswith(p):
                continue
            short = name[len(p):]
            if short == "KAO":
                t[f"{b}/ka"] = (ri.reshape_ka2(arr) if arr.ndim == 4
                                else ri.reshape_ka1(arr))
            elif short == "KBO":
                t[f"{b}/kb"] = (ri.reshape_kb2(arr) if arr.ndim == 4
                                else ri.reshape_kb1(arr))
            elif short.startswith(("KAO_M", "KBO_M")):
                key = short.replace("KAO_", "ka_").replace("KBO_", "kb_") \
                    .lower()
                t[f"{b}/{key}"] = (ri.reshape_minor2(arr) if arr.ndim == 3
                                   else arr)
            elif short == "SELFREFO":
                t[f"{b}/selfref"] = arr
            elif short == "FORREFO":
                t[f"{b}/forref"] = arr
            elif short == "FRACREFAO":
                t[f"{b}/fracrefa"] = arr
            elif short == "FRACREFBO":
                t[f"{b}/fracrefb"] = arr
            elif short in ("CCL4O", "CFC11ADJO", "CFC12O", "CFC22ADJO"):
                t[f"{b}/{short[:-1].lower()}"] = arr
    t["chi_mls"] = raw["chi_mls"]
    t["totplnk"] = raw["lw_totplnk"]
    t["delwave"] = raw["lw_delwave"]
    return t


# ---------------------------------------------------------------------------
# Small helpers

def _adjusted_column(col, coldry, chi_ref, thresh, c0, expo):
    """Empirical minor-gas column adjustment (rrtm_taumol3.F90:144-150,
    taumol6/7/8/9/13 variants)."""
    rat = 1.0e20 * (col / coldry) / chi_ref
    adjfac = c0 + torch.clamp(rat - c0, min=1e-30) ** expo
    return torch.where(rat > thresh,
                       adjfac * chi_ref * coldry * 1.0e-20, col)


class _Band:
    """Holds the per-band tables plus the gas columns.

    chi_host: the chi_mls table as host numpy, for the scalar reference
    ratios (one device-to-host copy per gas-optics call)."""

    def __init__(self, tables, cols: GasColumns, band: int, chi_host):
        self.t = {k.split("/", 1)[1]: v for k, v in tables.items()
                  if k.startswith(f"{band}/")}
        self.chi = chi_host
        self.c = cols
        self.band = band

    @staticmethod
    def s(x):
        """Add the g-broadcast axis to a batch scalar (ncol, nlev)."""
        return x[..., None]

    def wg(self, a, b):
        """Troposphere/stratosphere select per g."""
        return torch.where(self.c.tropo[..., None], a, b)

    def gvec(self, vec):
        """(ng,) constant broadcasting along the g axis."""
        return torch.as_tensor(vec, dtype=self.c.colh2o.dtype,
                               device=self.c.colh2o.device)

    def chi_ref(self, species_1b):
        """chi_mls(species, jp+1) per (col, lev) (1-based species)."""
        return self.c.chi_jp1[..., species_1b - 1]

    def chi_const(self, species_1b, jp_1b):
        return float(self.chi[species_1b - 1][jp_1b - 1])

    def self_for(self):
        # LW continuum factors are scaled by colh2o
        # (rrtm_setcoef_140gp.F90:249-251)
        c = self.c
        h2o = self.s(c.colh2o)
        tself = ri.self_continuum(self.t["selfref"], c.selffac, c.selffrac,
                                  c.indself)
        tfor = ri.foreign_continuum(self.t["forref"], c.forfac, c.forfrac,
                                    c.indfor)
        return h2o * tself, h2o * tfor

    def minor1(self, key):
        """1-D minor-gas absorption coefficient (scale applied by the
        caller; all rrtm_taumol* minor_1 uses have unit scale)."""
        return ri.minor_1(self.t[key], torch.ones_like(self.c.minorfrac),
                          self.c.minorfrac, self.c.indminor)

    def major_lower_1(self):
        c = self.c
        return ri.major_1(self.t["ka"], c.jp, c.jt, c.jt1,
                          c.fac00, c.fac01, c.fac10, c.fac11)

    def major_upper_1(self):
        c = self.c
        return ri.major_1(self.t["kb"], c.jp, c.jt, c.jt1,
                          c.fac00, c.fac01, c.fac10, c.fac11, jp_offset=12)

    def major_lower_2(self, col1, col2, rat0, rat1):
        c = self.c
        sc0, sp0, js0, fs0 = ri.spec_setup(8, col1, col2, rat0)
        sc1, sp1, js1, fs1 = ri.spec_setup(8, col1, col2, rat1)
        return ri.major_2(self.t["ka"], c.jp, c.jt, c.jt1,
                          c.fac00, c.fac01, c.fac10, c.fac11,
                          sc0, sp0, js0, fs0, sc1, sp1, js1, fs1,
                          eta_edges=True)

    def major_upper_2(self, col1, col2, rat0, rat1):
        c = self.c
        sc0, sp0, js0, fs0 = ri.spec_setup(4, col1, col2, rat0)
        sc1, sp1, js1, fs1 = ri.spec_setup(4, col1, col2, rat1)
        return ri.major_2(self.t["kb"], c.jp, c.jt, c.jt1,
                          c.fac00, c.fac01, c.fac10, c.fac11,
                          sc0, sp0, js0, fs0, sc1, sp1, js1, fs1,
                          jp_offset=12, eta_edges=False)

    def pfrac_eta(self, key, col1, col2, refrat, n_eta):
        """Eta-interpolated Planck fraction with constant reference ratio."""
        _, _, jpl, fpl = ri.spec_setup(n_eta, col1, col2, refrat)
        return ri.planck_frac_2(self.t[key], jpl, fpl)

    def minor_eta(self, key, col1, col2, refrat):
        """Eta-dependent minor gas absorption coefficient."""
        c = self.c
        _, _, jm, fm = ri.spec_setup(8, col1, col2, refrat)
        return ri.minor_2(self.t[key], jm, fm, c.minorfrac, c.indminor)

    def bcast(self, vec):
        """(ng,) table broadcast to the full batch-g shape."""
        v = self.gvec(vec)
        return torch.broadcast_to(v, tuple(self.c.colh2o.shape) + (len(v),))


# ---------------------------------------------------------------------------
# Band implementations. Each returns (tau, pfrac) of shape (ncol,nlev,ngb).

def band1(tb: _Band):
    """rrtm_taumol1.F90: low/high key H2O, minor N2 both."""
    c = tb.c
    tself, tfor = tb.self_for()
    scalen2 = c.colbrd * c.scaleminorn2
    taun2_lo = tb.s(scalen2) * tb.minor1("ka_mn2")
    taun2_hi = tb.s(scalen2) * tb.minor1("kb_mn2")
    corradj_lo = torch.where(c.pavel < 250.0,
                           1.0 - 0.15 * (250.0 - c.pavel) / 154.4, 1.0)
    corradj_hi = 1.0 - 0.15 * (c.pavel / 95.6)

    tau_lo = tb.s(corradj_lo) * (
        tb.s(c.colh2o) * tb.major_lower_1() + tself + tfor + taun2_lo)
    tau_hi = tb.s(corradj_hi) * (
        tb.s(c.colh2o) * tb.major_upper_1() + tfor + taun2_hi)
    tau = tb.wg(tau_lo, tau_hi)
    pfrac = tb.wg(tb.bcast(tb.t["fracrefa"]),
                     tb.bcast(tb.t["fracrefb"]))
    return tau, pfrac


def band2(tb: _Band):
    """rrtm_taumol2.F90: H2O both; pressure correction in lower."""
    c = tb.c
    tself, tfor = tb.self_for()
    corradj = 1.0 - 0.05 * (c.pavel - 100.0) / 900.0
    tau_lo = tb.s(corradj) * (
        tb.s(c.colh2o) * tb.major_lower_1() + tself + tfor)
    tau_hi = tb.s(c.colh2o) * tb.major_upper_1() + tfor
    tau = tb.wg(tau_lo, tau_hi)
    pfrac = tb.wg(tb.bcast(tb.t["fracrefa"]),
                     tb.bcast(tb.t["fracrefb"]))
    return tau, pfrac


def band3(tb: _Band):
    """rrtm_taumol3.F90: H2O+CO2 both; minor N2O with eta, adjusted col."""
    c = tb.c
    tself, tfor = tb.self_for()
    refrat_planck_a = tb.chi_const(1, 9) / tb.chi_const(2, 9)
    refrat_planck_b = tb.chi_const(1, 13) / tb.chi_const(2, 13)
    refrat_m_a = tb.chi_const(1, 3) / tb.chi_const(2, 3)
    refrat_m_b = tb.chi_const(1, 13) / tb.chi_const(2, 13)

    adjcoln2o = _adjusted_column(c.coln2o, c.coldry, tb.chi_ref(4),
                                 1.5, 0.5, 0.65)

    tau_major_lo = tb.major_lower_2(c.colh2o, c.colco2,
                                    c.rat_h2oco2, c.rat_h2oco2_1)
    absn2o_lo = tb.minor_eta("ka_mn2o", c.colh2o, c.colco2, refrat_m_a)
    tau_lo = (tau_major_lo + tself + tfor
              + tb.s(adjcoln2o) * absn2o_lo)
    pfrac_lo = tb.pfrac_eta("fracrefa", c.colh2o, c.colco2,
                            refrat_planck_a, 8)

    tau_major_hi = tb.major_upper_2(c.colh2o, c.colco2,
                                    c.rat_h2oco2, c.rat_h2oco2_1)
    # upper minor: 4-point eta
    _, _, jm_hi, fm_hi = ri.spec_setup(4, c.colh2o, c.colco2, refrat_m_b)
    absn2o_hi = ri.minor_2(tb.t["kb_mn2o"], jm_hi, fm_hi, c.minorfrac,
                           c.indminor)
    tau_hi = tau_major_hi + tfor + tb.s(adjcoln2o) * absn2o_hi
    pfrac_hi = tb.pfrac_eta("fracrefb", c.colh2o, c.colco2,
                            refrat_planck_b, 4)

    return (tb.wg(tau_lo, tau_hi),
            tb.wg(pfrac_lo, pfrac_hi))


def band4(tb: _Band):
    """rrtm_taumol4.F90: H2O+CO2 low / O3+CO2 high; empirical upper
    g-corrections."""
    c = tb.c
    tself, tfor = tb.self_for()
    refrat_planck_a = tb.chi_const(1, 11) / tb.chi_const(2, 11)
    refrat_planck_b = tb.chi_const(3, 13) / tb.chi_const(2, 13)

    tau_lo = (tb.major_lower_2(c.colh2o, c.colco2,
                               c.rat_h2oco2, c.rat_h2oco2_1)
              + tself + tfor)
    pfrac_lo = tb.pfrac_eta("fracrefa", c.colh2o, c.colco2,
                            refrat_planck_a, 8)

    tau_hi = tb.major_upper_2(c.colo3, c.colco2,
                              c.rat_o3co2, c.rat_o3co2_1)
    # empirical adjustments to upper-atmosphere g-points 8-14 (1-based)
    ng = tau_hi.shape[-1]
    corr = np.ones(ng)
    corr[7:14] = [0.92, 0.88, 1.07, 1.1, 0.99, 0.88, 0.943]
    tau_hi = tau_hi * tb.gvec(corr)
    pfrac_hi = tb.pfrac_eta("fracrefb", c.colo3, c.colco2,
                            refrat_planck_b, 4)

    return (tb.wg(tau_lo, tau_hi),
            tb.wg(pfrac_lo, pfrac_hi))


def band5(tb: _Band):
    """rrtm_taumol5.F90: H2O+CO2 low (minor O3, CCL4) / O3+CO2 high
    (CCL4)."""
    c = tb.c
    tself, tfor = tb.self_for()
    refrat_planck_a = tb.chi_const(1, 5) / tb.chi_const(2, 5)
    refrat_planck_b = tb.chi_const(3, 43) / tb.chi_const(2, 43)
    refrat_m_a = tb.chi_const(1, 7) / tb.chi_const(2, 7)

    abso3 = tb.minor_eta("ka_mo3", c.colh2o, c.colco2, refrat_m_a)
    tau_ccl4 = tb.s(c.wx_ccl4) * tb.gvec(tb.t["ccl4"])

    tau_lo = (tb.major_lower_2(c.colh2o, c.colco2,
                               c.rat_h2oco2, c.rat_h2oco2_1)
              + tself + tfor + tb.s(c.colo3) * abso3 + tau_ccl4)
    pfrac_lo = tb.pfrac_eta("fracrefa", c.colh2o, c.colco2,
                            refrat_planck_a, 8)

    tau_hi = (tb.major_upper_2(c.colo3, c.colco2,
                               c.rat_o3co2, c.rat_o3co2_1) + tau_ccl4)
    pfrac_hi = tb.pfrac_eta("fracrefb", c.colo3, c.colco2,
                            refrat_planck_b, 4)

    return (tb.wg(tau_lo, tau_hi),
            tb.wg(pfrac_lo, pfrac_hi))


def band6(tb: _Band):
    """rrtm_taumol6.F90: H2O low (minor CO2, CFC11, CFC12); nothing high
    except CFCs."""
    c = tb.c
    tself, tfor = tb.self_for()
    adjcolco2 = _adjusted_column(c.colco2, c.coldry, tb.chi_ref(2),
                                 3.0, 2.0, 0.77)
    absco2 = tb.minor1("ka_mco2")
    tau_cfc = (tb.s(c.wx_cfc11) * tb.gvec(tb.t["cfc11adj"])
               + tb.s(c.wx_cfc12) * tb.gvec(tb.t["cfc12"]))
    tau_lo = (tb.s(c.colh2o) * tb.major_lower_1() + tself + tfor
              + tb.s(adjcolco2) * absco2 + tau_cfc)
    tau_hi = tau_cfc
    tau = tb.wg(tau_lo, tau_hi)
    pfrac = tb.bcast(tb.t["fracrefa"])
    return tau, pfrac


def band7(tb: _Band):
    """rrtm_taumol7.F90: H2O+O3 low (minor CO2 eta) / O3 high (minor
    CO2)."""
    c = tb.c
    tself, tfor = tb.self_for()
    refrat_planck_a = tb.chi_const(1, 3) / tb.chi_const(3, 3)
    refrat_m_a = tb.chi_const(1, 3) / tb.chi_const(3, 3)

    adj_lo = _adjusted_column(c.colco2, c.coldry, tb.chi_ref(2),
                              3.0, 3.0, 0.79)
    adj_hi = _adjusted_column(c.colco2, c.coldry, tb.chi_ref(2),
                              3.0, 2.0, 0.79)
    absco2_lo = tb.minor_eta("ka_mco2", c.colh2o, c.colo3, refrat_m_a)
    absco2_hi = tb.minor1("kb_mco2")

    tau_lo = (tb.major_lower_2(c.colh2o, c.colo3,
                               c.rat_h2oo3, c.rat_h2oo3_1)
              + tself + tfor + tb.s(adj_lo) * absco2_lo)
    pfrac_lo = tb.pfrac_eta("fracrefa", c.colh2o, c.colo3,
                            refrat_planck_a, 8)

    tau_hi = (tb.s(c.colo3) * tb.major_upper_1()
              + tb.s(adj_hi) * absco2_hi)
    ng = tau_hi.shape[-1]
    corr = np.ones(ng)
    corr[5:11] = [0.92, 0.88, 1.07, 1.1, 0.99, 0.855]
    tau_hi = tau_hi * tb.gvec(corr)
    pfrac_hi = tb.bcast(tb.t["fracrefb"])

    return (tb.wg(tau_lo, tau_hi),
            tb.wg(pfrac_lo, pfrac_hi))


def band8(tb: _Band):
    """rrtm_taumol8.F90: H2O low / O3 high; minor CO2,O3,N2O + CFCs."""
    c = tb.c
    tself, tfor = tb.self_for()
    adjcolco2 = _adjusted_column(c.colco2, c.coldry, tb.chi_ref(2),
                                 3.0, 2.0, 0.65)
    absco2_lo = tb.minor1("ka_mco2")
    abso3_lo = tb.minor1("ka_mo3")
    absn2o_lo = tb.minor1("ka_mn2o")
    absco2_hi = tb.minor1("kb_mco2")
    absn2o_hi = tb.minor1("kb_mn2o")
    tau_cfc = (tb.s(c.wx_cfc12) * tb.gvec(tb.t["cfc12"])
               + tb.s(c.wx_cfc22) * tb.gvec(tb.t["cfc22adj"]))

    tau_lo = (tb.s(c.colh2o) * tb.major_lower_1() + tself + tfor
              + tb.s(adjcolco2) * absco2_lo
              + tb.s(c.colo3) * abso3_lo
              + tb.s(c.coln2o) * absn2o_lo + tau_cfc)
    tau_hi = (tb.s(c.colo3) * tb.major_upper_1()
              + tb.s(adjcolco2) * absco2_hi
              + tb.s(c.coln2o) * absn2o_hi + tau_cfc)
    return (tb.wg(tau_lo, tau_hi),
            tb.wg(tb.bcast(tb.t["fracrefa"]),
                     tb.bcast(tb.t["fracrefb"])))


def band9(tb: _Band):
    """rrtm_taumol9.F90: H2O+CH4 low (minor N2O eta) / CH4 high (minor
    N2O)."""
    c = tb.c
    tself, tfor = tb.self_for()
    refrat_planck_a = tb.chi_const(1, 9) / tb.chi_const(6, 9)
    refrat_m_a = tb.chi_const(1, 3) / tb.chi_const(6, 3)

    adjcoln2o = _adjusted_column(c.coln2o, c.coldry, tb.chi_ref(4),
                                 1.5, 0.5, 0.65)
    absn2o_lo = tb.minor_eta("ka_mn2o", c.colh2o, c.colch4, refrat_m_a)
    absn2o_hi = tb.minor1("kb_mn2o")

    tau_lo = (tb.major_lower_2(c.colh2o, c.colch4,
                               c.rat_h2och4, c.rat_h2och4_1)
              + tself + tfor + tb.s(adjcoln2o) * absn2o_lo)
    pfrac_lo = tb.pfrac_eta("fracrefa", c.colh2o, c.colch4,
                            refrat_planck_a, 8)

    tau_hi = (tb.s(c.colch4) * tb.major_upper_1()
              + tb.s(adjcoln2o) * absn2o_hi)
    pfrac_hi = tb.bcast(tb.t["fracrefb"])

    return (tb.wg(tau_lo, tau_hi),
            tb.wg(pfrac_lo, pfrac_hi))


def band10(tb: _Band):
    """rrtm_taumol10.F90: H2O both."""
    c = tb.c
    tself, tfor = tb.self_for()
    tau_lo = tb.s(c.colh2o) * tb.major_lower_1() + tself + tfor
    tau_hi = tb.s(c.colh2o) * tb.major_upper_1() + tfor
    return (tb.wg(tau_lo, tau_hi),
            tb.wg(tb.bcast(tb.t["fracrefa"]),
                     tb.bcast(tb.t["fracrefb"])))


def band11(tb: _Band):
    """rrtm_taumol11.F90: H2O both, minor O2."""
    c = tb.c
    tself, tfor = tb.self_for()
    scaleo2 = c.colo2 * c.scaleminor
    tauo2_lo = tb.s(scaleo2) * tb.minor1("ka_mo2")
    tauo2_hi = tb.s(scaleo2) * tb.minor1("kb_mo2")
    tau_lo = (tb.s(c.colh2o) * tb.major_lower_1() + tself + tfor
              + tauo2_lo)
    tau_hi = (tb.s(c.colh2o) * tb.major_upper_1() + tfor + tauo2_hi)
    return (tb.wg(tau_lo, tau_hi),
            tb.wg(tb.bcast(tb.t["fracrefa"]),
                     tb.bcast(tb.t["fracrefb"])))


def band12(tb: _Band):
    """rrtm_taumol12.F90: H2O+CO2 low; nothing high."""
    c = tb.c
    tself, tfor = tb.self_for()
    refrat_planck_a = tb.chi_const(1, 10) / tb.chi_const(2, 10)
    tau_lo = (tb.major_lower_2(c.colh2o, c.colco2,
                               c.rat_h2oco2, c.rat_h2oco2_1)
              + tself + tfor)
    pfrac_lo = tb.pfrac_eta("fracrefa", c.colh2o, c.colco2,
                            refrat_planck_a, 8)
    zero = torch.zeros_like(tau_lo)
    return (tb.wg(tau_lo, zero),
            tb.wg(pfrac_lo, zero))


def band13(tb: _Band):
    """rrtm_taumol13.F90: H2O+N2O low (minor CO2 eta + CO eta[col=0]);
    high: minor O3 only."""
    c = tb.c
    tself, tfor = tb.self_for()
    refrat_planck_a = tb.chi_const(1, 5) / tb.chi_const(4, 5)
    refrat_m_a = tb.chi_const(1, 1) / tb.chi_const(4, 1)

    # CO2 adjustment against fixed chi = 3.55e-4 (rrtm_taumol13.F90:125+)
    rat = 1.0e20 * (c.colco2 / c.coldry) / 3.55e-4
    adjfac = 2.0 + torch.clamp(rat - 2.0, min=1e-30) ** 0.68
    adjcolco2 = torch.where(rat > 3.0,
                          adjfac * 3.55e-4 * c.coldry * 1.0e-20, c.colco2)

    absco2 = tb.minor_eta("ka_mco2", c.colh2o, c.coln2o, refrat_m_a)
    # CO column is zero in the IFS configuration (taumol13.F90:91,125) —
    # the KA_MCO term therefore vanishes and is omitted here.
    abso3_hi = tb.minor1("kb_mo3")

    tau_lo = (tb.major_lower_2(c.colh2o, c.coln2o,
                               c.rat_h2on2o, c.rat_h2on2o_1)
              + tself + tfor + tb.s(adjcolco2) * absco2)
    pfrac_lo = tb.pfrac_eta("fracrefa", c.colh2o, c.coln2o,
                            refrat_planck_a, 8)
    tau_hi = tb.s(c.colo3) * abso3_hi
    pfrac_hi = tb.bcast(tb.t["fracrefb"])
    return (tb.wg(tau_lo, tau_hi),
            tb.wg(pfrac_lo, pfrac_hi))


def band14(tb: _Band):
    """rrtm_taumol14.F90: CO2 both."""
    c = tb.c
    tself, tfor = tb.self_for()
    tau_lo = tb.s(c.colco2) * tb.major_lower_1() + tself + tfor
    tau_hi = tb.s(c.colco2) * tb.major_upper_1()
    return (tb.wg(tau_lo, tau_hi),
            tb.wg(tb.bcast(tb.t["fracrefa"]),
                     tb.bcast(tb.t["fracrefb"])))


def band15(tb: _Band):
    """rrtm_taumol15.F90: N2O+CO2 low (minor N2 eta); nothing high."""
    c = tb.c
    tself, tfor = tb.self_for()
    refrat_planck_a = tb.chi_const(4, 1) / tb.chi_const(2, 1)
    refrat_m_a = tb.chi_const(4, 1) / tb.chi_const(2, 1)
    scalen2 = c.colbrd * c.scaleminor
    absn2 = tb.minor_eta("ka_mn2", c.coln2o, c.colco2, refrat_m_a)
    taun2 = tb.s(scalen2) * absn2

    tau_lo = (tb.major_lower_2(c.coln2o, c.colco2,
                               c.rat_n2oco2, c.rat_n2oco2_1)
              + tself + tfor + taun2)
    pfrac_lo = tb.pfrac_eta("fracrefa", c.coln2o, c.colco2,
                            refrat_planck_a, 8)
    zero = torch.zeros_like(tau_lo)
    return (tb.wg(tau_lo, zero),
            tb.wg(pfrac_lo, zero))


def band16(tb: _Band):
    """rrtm_taumol16.F90: H2O+CH4 low / CH4 high."""
    c = tb.c
    tself, tfor = tb.self_for()
    refrat_planck_a = tb.chi_const(1, 6) / tb.chi_const(6, 6)
    tau_lo = (tb.major_lower_2(c.colh2o, c.colch4,
                               c.rat_h2och4, c.rat_h2och4_1)
              + tself + tfor)
    pfrac_lo = tb.pfrac_eta("fracrefa", c.colh2o, c.colch4,
                            refrat_planck_a, 8)
    tau_hi = tb.s(c.colch4) * tb.major_upper_1()
    pfrac_hi = tb.bcast(tb.t["fracrefb"])
    return (tb.wg(tau_lo, tau_hi),
            tb.wg(pfrac_lo, pfrac_hi))


_BAND_FNS = [band1, band2, band3, band4, band5, band6, band7, band8,
             band9, band10, band11, band12, band13, band14, band15, band16]


def gas_optical_depth_lw(tables: dict, cols: GasColumns):
    """All 16 bands -> (tau, pfrac), each (ncol, nlev, 140).

    Equivalent of ifsrrtm/rrtm_gas_optical_depth.F90 dispatch; output stays
    in top-down level order (no reversal needed downstream).
    """
    chi_host = tables["chi_mls"].cpu().numpy()
    taus, pfracs = [], []
    for b in range(1, 17):
        tau, pfrac = _BAND_FNS[b - 1](_Band(tables, cols, b, chi_host))
        taus.append(tau)
        pfracs.append(pfrac)
    return torch.cat(taus, dim=-1), torch.cat(pfracs, dim=-1)
