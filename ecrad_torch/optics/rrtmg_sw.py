"""RRTMG shortwave gas optical depths, Rayleigh scattering and solar
source (112 g-points over 14 bands).

Port of ``ecrad_tpu/optics/rrtmg_sw.py``: ifsrrtm/srtm_taumol16.F90 ...
srtm_taumol29.F90 + srtm_gas_optical_depth.F90 as torch gathers,
top-down level order, with the reference's bottom-up LAYSOLFR ("solar
source layer") search recast as masked index arithmetic.

SW band structure (susrtm.F90 WAVENUM comments, yoesrta* headers):
  16: 2600-3250  H2O,CH4 / CH4        23: 8050-12850  H2O / -
  17: 3250-4000  H2O,CO2 / H2O,CO2    24: 12850-16000 H2O,O2 / O2 (O3 m)
  18: 4000-4650  H2O,CH4 / CH4        25: 16000-22650 H2O (O3 m) / O3
  19: 4650-5150  H2O,CO2 / CO2        26: 22650-29000 - (Rayleigh only)
  20: 5150-6150  H2O (CH4 m) / H2O    27: 29000-38000 O3 / O3
  21: 6150-7700  H2O,CO2 / H2O,CO2    28: 38000-50000 O3,O2 / O3,O2
  22: 7700-8050  H2O,O2 / O2          29:   820-2600  H2O (CO2 m) / CO2
"""

from __future__ import annotations

import torch

from ecrad_torch.optics import rrtmg_interp as ri
from ecrad_torch.optics.rrtmg_prepare import GasColumns


def build_sw_tables(raw: dict) -> dict:
    t = {}
    for b in range(16, 30):
        p = f"sw{b:02d}/"
        for name, arr in raw.items():
            if not name.startswith(p):
                continue
            short = name[len(p):].lower()
            if short == "ka":
                t[f"{b}/ka"] = (ri.reshape_ka2(arr) if arr.ndim == 4
                                else ri.reshape_ka1(arr))
            elif short == "kb":
                t[f"{b}/kb"] = (ri.reshape_kb2(arr) if arr.ndim == 4
                                else ri.reshape_kb1(arr))
            else:
                t[f"{b}/{short}"] = arr
    return t


class _SwBand:
    def __init__(self, tables, cols: GasColumns, band: int):
        self.t = {k.split("/", 1)[1]: v for k, v in tables.items()
                  if k.startswith(f"{band}/")}
        self.c = cols
        self.band = band
        # topmost lower-atmosphere layer (top-down index), per column
        self.k_trop_top = torch.argmax(cols.tropo.to(torch.int64), dim=1)

    @staticmethod
    def s(x):
        return x[..., None]

    def wg(self, a, b):
        return torch.where(self.c.tropo[..., None], a, b)

    def gvec(self, vec):
        return torch.as_tensor(vec, dtype=self.c.colh2o.dtype,
                               device=self.c.colh2o.device)

    def zeros_g(self, ng):
        c2 = self.c.colh2o
        return torch.zeros(tuple(c2.shape) + (ng,), dtype=c2.dtype,
                           device=c2.device)

    @staticmethod
    def _shift_below(x):
        """Value at the layer below (top-down), duplicating the surface
        layer."""
        return torch.cat([x[:, 1:], x[:, -1:]], dim=1)

    # --- major absorption -------------------------------------------------
    def major_lower_1(self):
        c = self.c
        return ri.major_1(self.t["ka"], c.jp, c.jt, c.jt1,
                          c.fac00, c.fac01, c.fac10, c.fac11)

    def major_upper_1(self):
        c = self.c
        return ri.major_1(self.t["kb"], c.jp, c.jt, c.jt1,
                          c.fac00, c.fac01, c.fac10, c.fac11, jp_offset=12)

    def _major_2_shared_js(self, table, col1, col2, rat, n_eta, jp_offset):
        """SW 2-species interpolation: single js/fs shared by both
        pressure planes, no eta-edge corrections
        (srtm_taumol16.F90:50-103)."""
        c = self.c
        speccomb, _, js, fs = ri.spec_setup(n_eta, col1, col2, rat)
        njp, njs = table.shape[0], table.shape[2]
        flat = table.reshape((-1,) + tuple(table.shape[3:]))
        nfl = flat.shape[0]
        jp0 = torch.clamp(c.jp - jp_offset, 0, njp - 1)
        jp1 = torch.clamp(c.jp + 1 - jp_offset, 0, njp - 1)
        pairs = []
        for djs, fsw in ((0, speccomb * (1.0 - fs)), (1, speccomb * fs)):
            for jp_s, jt_s, fac in ((jp0, c.jt, c.fac00),
                                    (jp0, c.jt + 1, c.fac10),
                                    (jp1, c.jt1, c.fac01),
                                    (jp1, c.jt1 + 1, c.fac11)):
                idx = torch.clamp((jp_s * 5 + jt_s) * njs + js + djs, 0,
                                  nfl - 1)
                pairs.append((idx, fsw * fac))
        return ri.weighted_take(flat, pairs), js, fs

    def major_lower_2(self, col1, col2, strrat):
        return self._major_2_shared_js(self.t["ka"], col1, col2, strrat,
                                       8, 0)

    def major_upper_2(self, col1, col2, strrat):
        return self._major_2_shared_js(self.t["kb"], col1, col2, strrat,
                                       4, 12)

    # --- continua ---------------------------------------------------------
    def self_for(self):
        """colh2o * (self + foreign) — SW taumols multiply by colh2o
        explicitly (srtm_taumol16.F90:95-102)."""
        c = self.c
        tself = ri.self_continuum(self.t["selfref"], c.selffac, c.selffrac,
                                  c.indself)
        tfor = ri.foreign_continuum(self.t["forref"], c.forfac, c.forfrac,
                                    c.indfor)
        return self.s(c.colh2o) * (tself + tfor)

    def foreign_only(self):
        c = self.c
        tfor = ri.foreign_continuum(self.t["forref"], c.forfac, c.forfrac,
                                    c.indfor)
        return self.s(c.colh2o) * tfor

    # --- Rayleigh ---------------------------------------------------------
    def taur_const(self):
        ng = self.t["sfluxref"].shape[0]
        return self.s(self.c.colmol) * self.gvec(
            [float(self.t["rayl"])] * ng)

    def taur_per_g(self, key="rayl"):
        return self.s(self.c.colmol) * self.gvec(self.t[key])

    # --- solar source layer -----------------------------------------------
    def solfr_lower(self):
        """Top-down index of the solar-source layer for bands whose
        reference level is tropospheric (srtm_taumol18.F90 pattern)."""
        c = self.c
        layreffr = int(self.t["layreffr"])
        jp1b = c.jp + 1                       # 1-based jp
        jp_below = self._shift_below(jp1b)
        tropo_below = self._shift_below(c.tropo)
        cross = (tropo_below & (jp1b >= layreffr) & (jp_below < layreffr))
        k_cross = torch.argmax(cross.to(torch.int64), dim=1)
        has = torch.any(cross, dim=1)
        k = torch.where(has, k_cross, self.k_trop_top)
        # laysolfr = min(i+1, laytrop) bottom-up -> top-down clamp so the
        # source layer is never above the topmost tropospheric layer
        return torch.maximum(k, self.k_trop_top)

    def solfr_upper(self):
        """Solar-source layer for stratospheric reference bands
        (srtm_taumol16.F90:115-122)."""
        c = self.c
        layreffr = int(self.t["layreffr"])
        jp1b = c.jp + 1
        jp_below = self._shift_below(jp1b)
        cross = ((~c.tropo) & (jp1b >= layreffr) & (jp_below < layreffr))
        k_cross = torch.argmax(cross.to(torch.int64), dim=1)
        has = torch.any(cross, dim=1)
        return torch.where(has, k_cross, torch.zeros_like(k_cross))

    def sflux_const(self):
        ncol = self.c.colh2o.shape[0]
        sf = self.t["sfluxref"]
        return torch.broadcast_to(sf, (ncol,) + tuple(sf.shape))

    def sflux_eta(self, js, fs, k_sol):
        """Eta-interpolated solar source at the source layer.

        sfluxref (ng, n_eta+1); js/fs (ncol, nlev); k_sol (ncol,).
        Returns (ncol, ng)."""
        sf = self.t["sfluxref"]                      # (ng, njs)
        js_sol = torch.gather(js, 1, k_sol[:, None])[:, 0]
        fs_sol = torch.gather(fs, 1, k_sol[:, None])[:, 0]
        f0 = sf[:, js_sol].T
        f1 = sf[:, torch.clamp(js_sol + 1, 0, sf.shape[1] - 1)].T
        return f0 + fs_sol[..., None] * (f1 - f0)


# ---------------------------------------------------------------------------

def _band16(tb):
    c = tb.c
    tau_lo, _, _ = tb.major_lower_2(c.colh2o, c.colch4,
                                    float(tb.t["strrat1"]))
    tau_lo = tau_lo + tb.self_for()
    tau_hi = tb.s(c.colch4) * tb.major_upper_1()
    tau = tb.wg(tau_lo, tau_hi)
    return tau, tb.taur_const(), tb.sflux_const()


def _band17(tb):
    c = tb.c
    strrat = float(tb.t["strrat"])
    tau_lo, _, _ = tb.major_lower_2(c.colh2o, c.colco2, strrat)
    tau_lo = tau_lo + tb.self_for()
    tau_hi, js_hi, fs_hi = tb.major_upper_2(c.colh2o, c.colco2, strrat)
    tau_hi = tau_hi + tb.foreign_only()
    tau = tb.wg(tau_lo, tau_hi)
    sflux = tb.sflux_eta(js_hi, fs_hi, tb.solfr_upper())
    return tau, tb.taur_const(), sflux


def _band18(tb):
    c = tb.c
    tau_lo, js, fs = tb.major_lower_2(c.colh2o, c.colch4,
                                      float(tb.t["strrat"]))
    tau_lo = tau_lo + tb.self_for()
    tau_hi = tb.s(c.colch4) * tb.major_upper_1()
    tau = tb.wg(tau_lo, tau_hi)
    sflux = tb.sflux_eta(js, fs, tb.solfr_lower())
    return tau, tb.taur_const(), sflux


def _band19(tb):
    c = tb.c
    tau_lo, js, fs = tb.major_lower_2(c.colh2o, c.colco2,
                                      float(tb.t["strrat"]))
    tau_lo = tau_lo + tb.self_for()
    tau_hi = tb.s(c.colco2) * tb.major_upper_1()
    tau = tb.wg(tau_lo, tau_hi)
    sflux = tb.sflux_eta(js, fs, tb.solfr_lower())
    return tau, tb.taur_const(), sflux


def _band20(tb):
    c = tb.c
    absch4 = tb.gvec(tb.t["absch4"])
    tau_lo = (tb.s(c.colh2o) * tb.major_lower_1() + tb.self_for()
              + tb.s(c.colch4) * absch4)
    tau_hi = (tb.s(c.colh2o) * tb.major_upper_1() + tb.foreign_only()
              + tb.s(c.colch4) * absch4)
    tau = tb.wg(tau_lo, tau_hi)
    return tau, tb.taur_const(), tb.sflux_const()


def _band21(tb):
    c = tb.c
    strrat = float(tb.t["strrat"])
    tau_lo, js, fs = tb.major_lower_2(c.colh2o, c.colco2, strrat)
    tau_lo = tau_lo + tb.self_for()
    tau_hi, _, _ = tb.major_upper_2(c.colh2o, c.colco2, strrat)
    tau_hi = tau_hi + tb.foreign_only()
    tau = tb.wg(tau_lo, tau_hi)
    sflux = tb.sflux_eta(js, fs, tb.solfr_lower())
    return tau, tb.taur_const(), sflux


def _band22(tb):
    c = tb.c
    o2adj = 1.6
    strrat = float(tb.t["strrat"])
    o2cont = tb.s(4.35e-4 * c.colo2 / (350.0 * 2.0))
    tau_lo, js, fs = tb.major_lower_2(c.colh2o, c.colo2, o2adj * strrat)
    tau_lo = tau_lo + tb.self_for() + o2cont
    tau_hi = (tb.s(c.colo2) * o2adj * tb.major_upper_1() + o2cont)
    tau = tb.wg(tau_lo, tau_hi)
    sflux = tb.sflux_eta(js, fs, tb.solfr_lower())
    return tau, tb.taur_const(), sflux


def _band23(tb):
    c = tb.c
    givfac = float(tb.t["givfac"])
    tau_lo = (givfac * tb.s(c.colh2o) * tb.major_lower_1()
              + tb.self_for())
    tau_hi = torch.zeros_like(tau_lo)
    tau = tb.wg(tau_lo, tau_hi)
    return tau, tb.taur_per_g(), tb.sflux_const()


def _band24(tb):
    c = tb.c
    tau_lo, js, fs = tb.major_lower_2(c.colh2o, c.colo2,
                                      float(tb.t["strrat"]))
    tau_lo = (tau_lo + tb.s(c.colo3) * tb.gvec(tb.t["abso3a"])
              + tb.self_for())
    tau_hi = (tb.s(c.colo2) * tb.major_upper_1()
              + tb.s(c.colo3) * tb.gvec(tb.t["abso3b"]))
    tau = tb.wg(tau_lo, tau_hi)
    # Rayleigh: eta-dependent in lower (RAYLA (ng,9)), constant-g upper
    rayla = tb.t["rayla"].T                      # (9, ng)
    ray = ri.weighted_take(rayla, [
        (js, 1.0 - fs), (torch.clamp(js + 1, 0, 8), fs)])
    taur_lo = tb.s(c.colmol) * ray
    taur_hi = tb.s(c.colmol) * tb.gvec(tb.t["raylb"])
    taur = tb.wg(taur_lo, taur_hi)
    sflux = tb.sflux_eta(js, fs, tb.solfr_lower())
    return tau, taur, sflux


def _band25(tb):
    c = tb.c
    tau_lo = (tb.s(c.colh2o) * tb.major_lower_1()
              + tb.s(c.colo3) * tb.gvec(tb.t["abso3a"]))
    tau_hi = tb.s(c.colo3) * tb.gvec(tb.t["abso3b"])
    tau = tb.wg(tau_lo, tau_hi)
    return tau, tb.taur_per_g(), tb.sflux_const()


def _band26(tb):
    c = tb.c
    ng = tb.t["sfluxref"].shape[0]
    tau = tb.zeros_g(ng)
    return tau, tb.taur_per_g(), tb.sflux_const()


def _band27(tb):
    c = tb.c
    tau_lo = tb.s(c.colo3) * tb.major_lower_1()
    tau_hi = tb.s(c.colo3) * tb.major_upper_1()
    tau = tb.wg(tau_lo, tau_hi)
    sflux = tb.sflux_const() * float(tb.t["scalekur"])
    return tau, tb.taur_per_g(), sflux


def _band28(tb):
    c = tb.c
    strrat = float(tb.t["strrat"])
    tau_lo, _, _ = tb.major_lower_2(c.colo3, c.colo2, strrat)
    tau_hi, js_hi, fs_hi = tb.major_upper_2(c.colo3, c.colo2, strrat)
    tau = tb.wg(tau_lo, tau_hi)
    sflux = tb.sflux_eta(js_hi, fs_hi, tb.solfr_upper())
    return tau, tb.taur_const(), sflux


def _band29(tb):
    c = tb.c
    tau_lo = (tb.s(c.colh2o) * tb.major_lower_1() + tb.self_for()
              + tb.s(c.colco2) * tb.gvec(tb.t["absco2"]))
    tau_hi = (tb.s(c.colco2) * tb.major_upper_1()
              + tb.s(c.colh2o) * tb.gvec(tb.t["absh2o"]))
    tau = tb.wg(tau_lo, tau_hi)
    return tau, tb.taur_const(), tb.sflux_const()


_SW_BAND_FNS = {16: _band16, 17: _band17, 18: _band18, 19: _band19,
                20: _band20, 21: _band21, 22: _band22, 23: _band23,
                24: _band24, 25: _band25, 26: _band26, 27: _band27,
                28: _band28, 29: _band29}


def gas_optical_depth_sw(tables: dict, cols: GasColumns):
    """All 14 SW bands -> (taug, taur, sfluxzen): taug/taur
    (ncol, nlev, 112), sfluxzen (ncol, 112).  Equivalent of
    ifsrrtm/srtm_gas_optical_depth.F90 (od and ssa are formed in
    rrtmg.py)."""
    taugs, taurs, sfluxes = [], [], []
    for b in range(16, 30):
        taug, taur, sflux = _SW_BAND_FNS[b](_SwBand(tables, cols, b))
        taugs.append(taug)
        taurs.append(taur)
        sfluxes.append(sflux)
    return (torch.cat(taugs, dim=-1), torch.cat(taurs, dim=-1),
            torch.cat(sfluxes, dim=-1))
