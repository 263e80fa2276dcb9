"""RRTMG gas preparation + interpolation coefficients, vectorized in torch
(port of ``ecrad_tpu/optics/rrtmg_prepare.py``).

Reference: ifsrrtm/rrtm_prepare_gases.F90 (column amounts) and
ifsrrtm/rrtm_setcoef_140gp.F90 / ifsrrtm/srtm_setcoef.F90 (pressure/
temperature interpolation indices, continuum factors, binary-species
reference ratios).

Differences from the reference:
  * No bottom-up reordering: everything stays in ecRad's top-down level
    order. The reference's LAYTROP layer counter becomes a boolean mask
    (``tropo``: log(p_hPa) > 4.56), which is equivalent because pressure is
    monotonic in the vertical.
  * All indices are 0-based and returned clamped, ready for gathers.

Everything here is per-(col, lev) scalar math.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# RRTMG's own conversion constants (rrtm_prepare_gases.F90:85-97).  These
# deliberately differ in the last digits from radiation_gas_constants.F90 —
# each backend uses its own values, as in the reference.
AMD = 28.970
AMW = 18.0154
AMCO2 = 44.011
AMO = 47.9982
AMCH4 = 16.043
AMN2O = 44.013
AMC11 = 137.3686
AMC12 = 120.9140
AMC22 = 86.4690
AMCL4 = 153.8230
AVOGADRO = 6.02214e23
GRAV_CGS = 9.80665e2      # (RG/RPLRG)*1e2, yomdyncore RPLRG=1
O2_VMR = 0.209488         # hard-coded (rrtm_prepare_gases.F90:186)


class GasColumns(NamedTuple):
    """Per-(ncol, nlev) quantities from prepare_gases + setcoef."""
    pavel: torch.Tensor          # layer pressure, hPa
    tavel: torch.Tensor          # layer temperature, K
    coldry: torch.Tensor         # dry air column, molec/cm2
    colbrd: torch.Tensor         # broadening gas column * 1e-20
    colh2o: torch.Tensor         # gas columns * 1e-20 (as in setcoef)
    colco2: torch.Tensor
    colo3: torch.Tensor
    coln2o: torch.Tensor
    colch4: torch.Tensor
    colo2: torch.Tensor
    colmol: torch.Tensor         # coldry + h2o column (for Rayleigh), *1e-20
    wx_ccl4: torch.Tensor        # cross-section gas amounts (*1e-20)
    wx_cfc11: torch.Tensor
    wx_cfc12: torch.Tensor
    wx_cfc22: torch.Tensor
    tropo: torch.Tensor          # bool: lower-atmosphere (p > ~96 hPa) mask
    jp: torch.Tensor             # 0-based pressure index (0..57)
    jt: torch.Tensor             # 0-based temperature index at jp (0..3)
    jt1: torch.Tensor            # 0-based temperature index at jp+1
    fac00: torch.Tensor
    fac01: torch.Tensor
    fac10: torch.Tensor
    fac11: torch.Tensor
    selffac: torch.Tensor        # already scaled by colh2o
    selffrac: torch.Tensor
    indself: torch.Tensor        # 0-based (0..8)
    forfac: torch.Tensor         # already scaled by colh2o
    forfrac: torch.Tensor
    indfor: torch.Tensor         # 0-based (0..2)
    scaleminor: torch.Tensor
    scaleminorn2: torch.Tensor
    minorfrac: torch.Tensor
    indminor: torch.Tensor       # 0-based (0..17)
    # binary-species reference ratios at jp and jp+1
    rat_h2oco2: torch.Tensor
    rat_h2oco2_1: torch.Tensor
    rat_h2oo3: torch.Tensor
    rat_h2oo3_1: torch.Tensor
    rat_h2on2o: torch.Tensor
    rat_h2on2o_1: torch.Tensor
    rat_h2och4: torch.Tensor
    rat_h2och4_1: torch.Tensor
    rat_n2oco2: torch.Tensor
    rat_n2oco2_1: torch.Tensor
    rat_o3co2: torch.Tensor
    rat_o3co2_1: torch.Tensor
    chi_jp1: torch.Tensor        # chi_mls profiles at jp+1, (ncol,nlev,7)


def prepare_columns(pressure_hl, pressure_fl, temperature_fl,
                    h2o_mmr, co2_mmr, ch4_mmr, n2o_mmr, cfc11_mmr,
                    cfc12_mmr, hcfc22_mmr, ccl4_mmr, o3_mmr,
                    preflog, tref, chi_mls) -> GasColumns:
    """Compute all per-layer interpolation data.

    Gas inputs are mass mixing ratios on (ncol, nlev), top-down order,
    matching the reference contract (radiation_ifs_rrtm.F90:216-424 asserts
    IMassMixingRatio before calling RRTM_PREPARE_GASES).  preflog/tref
    (59,) and chi_mls (7, 59) are table tensors.
    """
    dtype = pressure_fl.dtype
    pavel = pressure_fl * 0.01                      # Pa -> hPa
    tavel = temperature_fl

    # VMRs with RRTMG constants; H2O floored at 1e-15 MMR
    wv = torch.clamp(h2o_mmr, min=1.0e-15) * (AMD / AMW)
    vco2 = co2_mmr * (AMD / AMCO2)
    vo3 = o3_mmr * (AMD / AMO)
    vn2o = n2o_mmr * (AMD / AMN2O)
    vch4 = ch4_mmr * (AMD / AMCH4)
    vo2 = torch.full_like(wv, O2_VMR)
    vccl4 = ccl4_mmr * (AMD / AMCL4)
    vcfc11 = cfc11_mmr * (AMD / AMC11)
    vcfc12 = cfc12_mmr * (AMD / AMC12)
    vcfc22 = hcfc22_mmr * (AMD / AMC22)

    # Dry column (molec/cm2): hydrostatic with moist-air molar mass
    dp_hpa = (pressure_hl[:, 1:] - pressure_hl[:, :-1]) * 0.01
    amm = (1.0 - wv) * AMD + wv * AMW
    coldry = dp_hpa * 1.0e3 * AVOGADRO / (GRAV_CGS * amm * (1.0 + wv))

    # Broadening gases: coldry * (1 - sum of major gas VMRs except H2O)
    summol = vco2 + vo3 + vn2o + vch4 + vo2
    wbrodl = coldry * (1.0 - summol)

    colh2o = 1.0e-20 * coldry * wv
    colco2 = 1.0e-20 * coldry * vco2
    colo3 = 1.0e-20 * coldry * vo3
    coln2o = 1.0e-20 * coldry * vn2o
    colch4 = 1.0e-20 * coldry * vch4
    colo2 = 1.0e-20 * coldry * vo2
    colbrd = 1.0e-20 * wbrodl
    colmol = 1.0e-20 * coldry + colh2o
    tiny_col = 1.0e-32 * coldry
    colco2 = torch.where(colco2 == 0.0, tiny_col, colco2)
    coln2o = torch.where(coln2o == 0.0, tiny_col, coln2o)
    colch4 = torch.where(colch4 == 0.0, tiny_col, colch4)

    wx_ccl4 = 1.0e-20 * coldry * vccl4
    wx_cfc11 = 1.0e-20 * coldry * vcfc11
    wx_cfc12 = 1.0e-20 * coldry * vcfc12
    wx_cfc22 = 1.0e-20 * coldry * vcfc22

    # --- setcoef (rrtm_setcoef_140gp.F90:82-258)
    plog = torch.log(pavel)
    tropo = plog > 4.56

    jp1b = torch.clamp(torch.floor(36.0 - 5.0 * (plog + 0.04))
                       .to(torch.int64), 1, 58)     # 1-based

    # every per-jp reference quantity, looked up at jp and jp+1: the
    # (59,)-row tables preflog/tref and the 7 chi_mls profiles packed
    # into one (59, 9) matrix
    refmat = torch.cat([preflog.to(dtype)[:, None], tref.to(dtype)[:, None],
                        chi_mls.to(dtype).T], dim=1)        # (59, 2 + 7)
    at_jp = refmat[jp1b - 1]
    at_jp1 = refmat[jp1b]

    fp = torch.clamp(5.0 * (at_jp[..., 0] - plog), -1.0, 1.0)
    tref_jp = at_jp[..., 1]
    tref_jp1 = at_jp1[..., 1]
    jtb = torch.clamp(torch.floor(3.0 + (tavel - tref_jp) / 15.0)
                      .to(torch.int64), 1, 4)
    ft = (tavel - tref_jp) / 15.0 - (jtb - 3)
    jt1b = torch.clamp(torch.floor(3.0 + (tavel - tref_jp1) / 15.0)
                       .to(torch.int64), 1, 4)
    ft1 = (tavel - tref_jp1) / 15.0 - (jt1b - 3)

    water = wv
    stpfac = 296.0 / 1013.0
    scalefac = pavel * stpfac / tavel

    forfac = scalefac / (1.0 + water)
    # Lower: indfor from temperature; upper: fixed index 3
    factor_lo = (332.0 - tavel) / 36.0
    indfor_lo = torch.clamp(torch.floor(factor_lo).to(torch.int64), 1, 2)
    forfrac_lo = factor_lo - indfor_lo
    factor_hi = (tavel - 188.0) / 36.0
    indfor = torch.where(tropo, indfor_lo, torch.full_like(indfor_lo, 3))
    forfrac = torch.where(tropo, forfrac_lo, factor_hi - 1.0)

    selffac = water * forfac
    factor_s = (tavel - 188.0) / 7.2
    indself = torch.clamp(torch.floor(factor_s).to(torch.int64) - 7, 1, 9)
    selffrac = factor_s - (indself + 7)

    scaleminor = pavel / tavel
    scaleminorn2 = scaleminor * (wbrodl / (coldry + coldry * wv))
    # NB reference: wbroad/(coldry + wkl1) where wkl1 = coldry*wv
    factor_m = (tavel - 180.8) / 7.2
    indminor = torch.clamp(torch.floor(factor_m).to(torch.int64), 1, 18)
    minorfrac = factor_m - indminor

    def rat(i, j):
        # chi_mls(i, jp)/chi_mls(j, jp) and at jp+1 (1-based species i,j)
        r0 = at_jp[..., 1 + i] / at_jp[..., 1 + j]
        r1 = at_jp1[..., 1 + i] / at_jp1[..., 1 + j]
        return r0, r1

    rat_h2oco2, rat_h2oco2_1 = rat(1, 2)
    rat_h2oo3, rat_h2oo3_1 = rat(1, 3)
    rat_h2on2o, rat_h2on2o_1 = rat(1, 4)
    rat_h2och4, rat_h2och4_1 = rat(1, 6)
    rat_n2oco2, rat_n2oco2_1 = rat(4, 2)
    rat_o3co2, rat_o3co2_1 = rat(3, 2)

    compfp = 1.0 - fp
    fac10 = compfp * ft
    fac00 = compfp * (1.0 - ft)
    fac11 = fp * ft1
    fac01 = fp * (1.0 - ft1)

    # NB: selffac/forfac are stored UNSCALED (srtm_setcoef.F90 convention);
    # the LW path multiplies by colh2o (rrtm_setcoef_140gp.F90:249-251
    # does so in place), the SW taumols multiply explicitly.

    return GasColumns(
        pavel=pavel, tavel=tavel, coldry=coldry, colbrd=colbrd,
        colh2o=colh2o, colco2=colco2, colo3=colo3, coln2o=coln2o,
        colch4=colch4, colo2=colo2, colmol=colmol,
        wx_ccl4=wx_ccl4, wx_cfc11=wx_cfc11, wx_cfc12=wx_cfc12,
        wx_cfc22=wx_cfc22,
        tropo=tropo, jp=jp1b - 1, jt=jtb - 1, jt1=jt1b - 1,
        fac00=fac00, fac01=fac01, fac10=fac10, fac11=fac11,
        selffac=selffac, selffrac=selffrac, indself=indself - 1,
        forfac=forfac, forfrac=forfrac, indfor=indfor - 1,
        scaleminor=scaleminor, scaleminorn2=scaleminorn2,
        minorfrac=minorfrac, indminor=indminor - 1,
        rat_h2oco2=rat_h2oco2, rat_h2oco2_1=rat_h2oco2_1,
        rat_h2oo3=rat_h2oo3, rat_h2oo3_1=rat_h2oo3_1,
        rat_h2on2o=rat_h2on2o, rat_h2on2o_1=rat_h2on2o_1,
        rat_h2och4=rat_h2och4, rat_h2och4_1=rat_h2och4_1,
        rat_n2oco2=rat_n2oco2, rat_n2oco2_1=rat_n2oco2_1,
        rat_o3co2=rat_o3co2, rat_o3co2_1=rat_o3co2_1,
        chi_jp1=at_jp1[..., 2:],
    )
