"""Shared interpolation primitives for the RRTMG taumol kernels
(port of ``ecrad_tpu/optics/rrtmg_interp.py``, gather form).

The reference accesses flattened ABSA/ABSB tables with precomputed flat
indices (e.g. ifsrrtm/rrtm_taumol1.F90:200-280, rrtm_taumol3.F90:95-310).
Tables are reshaped to explicit (jp, jt, js, g) axes at setup, and every
interpolation is a sum of weighted table rows gathered with per-(column,
level) indices.  Batch layout: index arrays (ncol, nlev), results
(ncol, nlev, ng).
"""

from __future__ import annotations

import numpy as np
import torch

ONEMINUS = 1.0 - 1.0e-6


# --- table reshaping (host-side, numpy, at setup) ------------------------

def reshape_ka1(kao: np.ndarray) -> np.ndarray:
    """KAO(5,13,ng) (jt,jp,g) -> (13,5,ng) (jp,jt,g)."""
    return np.ascontiguousarray(np.transpose(kao, (1, 0, 2)))


def reshape_kb1(kbo: np.ndarray) -> np.ndarray:
    """KBO(5,47,ng) (jt,jp,g) -> (47,5,ng) (jp,jt,g)."""
    return np.ascontiguousarray(np.transpose(kbo, (1, 0, 2)))


def reshape_ka2(kao: np.ndarray) -> np.ndarray:
    """KAO(9,5,13,ng) (js,jt,jp,g) -> (13,5,9,ng) (jp,jt,js,g)."""
    return np.ascontiguousarray(np.transpose(kao, (2, 1, 0, 3)))


def reshape_kb2(kbo: np.ndarray) -> np.ndarray:
    """KBO(5,5,47,ng) (js,jt,jp,g) -> (47,5,5,ng) (jp,jt,js,g)."""
    return np.ascontiguousarray(np.transpose(kbo, (2, 1, 0, 3)))


def reshape_minor2(kam: np.ndarray) -> np.ndarray:
    """KA_Mxxx(9,19,ng) (js,jt,g) -> (19,9,ng) (jt,js,g)."""
    return np.ascontiguousarray(np.transpose(kam, (1, 0, 2)))


# --- the gather primitive --------------------------------------------------

def weighted_take(table, pairs):
    """``sum_i w_i * table[idx_i]`` over a list of (idx, weight) pairs.

    table: (nrows, ng); idx: integer (ncol, nlev); weight: same shape or
    None (== 1).  Returns (ncol, nlev, ng)."""
    out = None
    for idx, w in pairs:
        t = table[idx]
        if w is not None:
            t = w[..., None] * t
        out = t if out is None else out + t
    return out


def take_bands(x, band_from_g):
    """Expand per-band values to per-g: x (..., nband) -> (..., ng)."""
    return x[..., band_from_g]


def major_1_pairs(njp, jp, jt, jt1, fac00, fac01, fac10, fac11,
                  jp_offset=0):
    """The 4 (row, weight) pairs of the 1-key-species interpolation."""
    jp0 = torch.clamp(jp - jp_offset, 0, njp - 1)
    jp1 = torch.clamp(jp + 1 - jp_offset, 0, njp - 1)
    return [
        (jp0 * 5 + jt, fac00),
        (jp0 * 5 + jt + 1, fac10),
        (jp1 * 5 + jt1, fac01),
        (jp1 * 5 + jt1 + 1, fac11),
    ]


def major_1(table, jp, jt, jt1, fac00, fac01, fac10, fac11, jp_offset=0):
    """1-key-species major absorption (e.g. rrtm_taumol1.F90:202-236).

    table: (njp, 5, ng) jp-major; jp_offset subtracted from jp first
    (upper-atmosphere tables start at jp index 12)."""
    njp = table.shape[0]
    flat = table.reshape((-1,) + tuple(table.shape[2:]))
    return weighted_take(flat, major_1_pairs(
        njp, jp, jt, jt1, fac00, fac01, fac10, fac11, jp_offset))


def spec_setup(n_eta, colgas1, colgas2, rat):
    """Binary species parameter setup (rrtm_taumol3.F90:119-124 pattern).

    n_eta: 8 for lower (9-point eta axis), 4 for upper (5-point).
    Returns (speccomb, specparm, js0, fs): js0 is the 0-based eta index.
    """
    speccomb = colgas1 + rat * colgas2
    specparm = torch.clamp(colgas1 / speccomb, max=ONEMINUS)
    specmult = n_eta * specparm
    js0 = specmult.to(torch.int64)            # 0-based (Fortran js-1)
    fs = specmult - js0
    return speccomb, specparm, js0, fs


def major_2_pairs(njp, njs, nfl, jp, jt, jt1, fac00, fac01, fac10, fac11,
                  speccomb, specparm, js, fs, speccomb1, specparm1, js1,
                  fs1, jp_offset=0, eta_edges=True):
    """The 12 (or 8) (row, weight) pairs of the 2-key-species
    interpolation (see :func:`major_2`)."""

    def side_pairs(jp_side, jt_side, facA, facB, speccomb_s, specparm_s,
                   js_s, fs_s):
        """facA = fac at jt, facB = fac at jt+1 (e.g. fac00, fac10)."""
        jp0 = torch.clamp(jp_side - jp_offset, 0, njp - 1)
        base = (jp0 * 5 + jt_side) * njs
        pairs = []
        if eta_edges:
            # three regimes on specparm
            p_lo = fs_s - 1.0
            p4_lo = p_lo ** 4
            fk0_lo, fk1_lo, fk2_lo = p4_lo, 1.0 - p_lo - 2.0 * p4_lo, \
                p_lo + p4_lo
            p_hi = -fs_s
            p4_hi = p_hi ** 4
            fk0_hi, fk1_hi, fk2_hi = p4_hi, 1.0 - p_hi - 2.0 * p4_hi, \
                p_hi + p4_hi

            lo = specparm_s < 0.125
            hi = specparm_s > 0.875
            # mid-regime uses (1-fs, fs) on (0,+1)
            fk0 = torch.where(lo, fk0_lo, torch.where(hi, fk0_hi,
                                                      1.0 - fs_s))
            fk1 = torch.where(lo, fk1_lo, torch.where(hi, fk1_hi, fs_s))
            fk2 = torch.where(lo, fk2_lo, torch.where(
                hi, fk2_hi, torch.zeros_like(fs_s)))
            # js offsets per regime: lo -> (0,1,2); hi -> (+1,0,-1);
            # mid -> (0,1,.)
            one = torch.ones_like(js_s)
            zero = torch.zeros_like(js_s)
            d0 = torch.where(hi, one, zero)
            d1 = torch.where(hi, zero, one)
            d2 = torch.where(hi, -one, 2 * one)
            for djt, fac in ((0, facA), (1, facB)):
                off = base + djt * njs + js_s
                for fk, d in ((fk0, d0), (fk1, d1), (fk2, d2)):
                    pairs.append((torch.clamp(off + d, 0, nfl - 1),
                                  speccomb_s * fac * fk))
        else:
            for djt, fac in ((0, facA), (1, facB)):
                off = base + djt * njs + js_s
                pairs.append((torch.clamp(off, 0, nfl - 1),
                              speccomb_s * fac * (1.0 - fs_s)))
                pairs.append((torch.clamp(off + 1, 0, nfl - 1),
                              speccomb_s * fac * fs_s))
        return pairs

    return (side_pairs(jp, jt, fac00, fac10, speccomb, specparm, js, fs)
            + side_pairs(jp + 1, jt1, fac01, fac11, speccomb1,
                         specparm1, js1, fs1))


def major_2(table, jp, jt, jt1, fac00, fac01, fac10, fac11,
            speccomb, specparm, js, fs, speccomb1, specparm1, js1, fs1,
            jp_offset=0, eta_edges=True):
    """2-key-species major absorption with eta interpolation, including the
    quartic eta-edge corrections for specparm < 0.125 / > 0.875
    (rrtm_taumol3.F90:170-289 pattern).

    table: (njp, 5, n_js, ng); js/js1 0-based.  Returns the
    speccomb-weighted sum over both jp planes."""
    njp, njs = table.shape[0], table.shape[2]
    flat = table.reshape((-1,) + tuple(table.shape[3:]))
    nfl = flat.shape[0]
    pairs = major_2_pairs(njp, njs, nfl, jp, jt, jt1, fac00, fac01,
                          fac10, fac11, speccomb, specparm, js, fs,
                          speccomb1, specparm1, js1, fs1, jp_offset,
                          eta_edges)
    return weighted_take(flat, pairs)


def self_continuum(selfref, selffac, selffrac, indself):
    """rrtm_taumol1.F90:219-222. selfref (10, ng)."""
    w1 = selffac * selffrac
    return weighted_take(selfref, [(indself, selffac - w1),
                                   (indself + 1, w1)])


def foreign_continuum(forref, forfac, forfrac, indfor):
    """rrtm_taumol1.F90:224-226. forref (3|4, ng)."""
    n = forref.shape[0]
    w1 = forfac * forfrac
    return weighted_take(forref, [
        (torch.clamp(indfor, 0, n - 1), forfac - w1),
        (torch.clamp(indfor + 1, 0, n - 1), w1)])


def minor_1(kminor, scale, minorfrac, indminor):
    """1-D minor-gas absorption (rrtm_taumol1.F90:228-231).
    kminor (19, ng)."""
    w1 = scale * minorfrac
    return weighted_take(kminor, [(indminor, scale - w1),
                                  (indminor + 1, w1)])


def minor_2(kminor, jm, fm, minorfrac, indminor):
    """Eta-dependent minor-gas absorption (rrtm_taumol3.F90:139-143 +
    225-232 pattern). kminor (19, 9, ng) (jt, js, g); jm 0-based.
    The bilinear stencil is expanded into 4 weighted rows."""
    flat = kminor.reshape((-1,) + tuple(kminor.shape[2:]))
    njs = kminor.shape[1]
    nfl = flat.shape[0]

    def at(jt, js):
        return torch.clamp(jt * njs + js, 0, nfl - 1)

    mf = minorfrac
    return weighted_take(flat, [
        (at(indminor, jm), (1.0 - mf) * (1.0 - fm)),
        (at(indminor, jm + 1), (1.0 - mf) * fm),
        (at(indminor + 1, jm), mf * (1.0 - fm)),
        (at(indminor + 1, jm + 1), mf * fm)])


def planck_frac_2(fracref, jpl, fpl):
    """Eta-interpolated Planck fraction (rrtm_taumol3.F90:300-303).
    fracref (ng, 9) (g, js); jpl 0-based."""
    tab = fracref.T                                   # (njs, ng)
    njs = tab.shape[0]
    return weighted_take(tab, [
        (jpl, 1.0 - fpl),
        (torch.clamp(jpl + 1, 0, njs - 1), fpl)])
