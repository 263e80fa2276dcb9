"""RRTMG taumol interpolation: the two CUDA kernels' wrappers, their
packed tables and their plain torch versions.

The kernels (``ecrad_torch/csrc/rrtmg_gas.cu``) replace no TPU kernel:
the JAX package leaves RRTMG gas optics to XLA.  ``lw_taumol`` covers
rrtm_taumol1-16 (140 g-points) and writes the LW optical depth, the
Planck function at half levels and the surface emission; ``sw_taumol``
covers srtm_taumol16-29 (112 g-points) and writes the SW optical depth,
single-scattering albedo and the solar source per column.  Both read the
per-(column, layer) fields of ``rrtmg_prepare.GasColumns``, which stays in
torch, and one packed buffer per band set that ``pack_tables`` builds at
set-up (``rrtmg.setup_tables``): every table, per-g constant vector and
chi_mls ratio the band functions read, each laid out with the g-points
last, at offsets listed in the table dict beside it.  The plain versions,
which CPU tensors run, are ``rrtmg_lw.gas_optical_depth_lw`` and
``rrtmg_sw.gas_optical_depth_sw`` with the clamps, the Planck function and
the albedo around them, as the gas optics compute them without a card.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ecrad_torch import kernels
from ecrad_torch.optics import rrtmg_data, rrtmg_lw, rrtmg_sw
from ecrad_torch.optics.rrtmg_interp import take_bands, weighted_take
from ecrad_torch.optics.rrtmg_prepare import GasColumns

FLUXFAC = np.pi * 1.0e4

# The GasColumns fields the kernels read, in the order of the kernels'
# FField and IField enums: the float fields, then the int64 indices, then
# the bool tropo mask.  chi_jp1, a strided view, is left out: the kernels
# look chi_mls up at jp + 1 in the packed tables.
INT_FIELDS = ("jp", "jt", "jt1", "indself", "indfor", "indminor")
FLOAT_FIELDS = tuple(f for f in GasColumns._fields
                     if f not in INT_FIELDS + ("tropo", "chi_jp1"))

# Where each band's tables come from.  A slot's source is a table key of
# the band ("ka": the band's table, g-points last), ("fill", key): a
# per-g vector of the scalar table, ("scalar", key, factor), ("ratio",
# (species, jp), (species, jp)): chi_mls(a) / chi_mls(b), 1-based as the
# band functions' chi_const, or ("vector", values): a per-g constant.
# The ratios are in the order the band functions compute them.  Slot
# names are the kernels' LwSlot and SwSlot enumerators.
_CONT = ("ka", "kb", "selfref", "forref")


def _ratio(a, b):
    return ("ratio", a, b)


_LW_CORR4 = (1.0,) * 7 + (0.92, 0.88, 1.07, 1.1, 0.99, 0.88, 0.943)
_LW_CORR7 = (1.0,) * 5 + (0.92, 0.88, 1.07, 1.1, 0.99, 0.855, 1.0)

LW_BANDS = {
    1: _CONT + ("ka_mn2", "kb_mn2", "fracrefa", "fracrefb"),
    2: _CONT + ("fracrefa", "fracrefb"),
    3: _CONT + ("ka_mn2o", "kb_mn2o", "fracrefa", "fracrefb",
                ("RP_A", _ratio((1, 9), (2, 9))),
                ("RP_B", _ratio((1, 13), (2, 13))),
                ("RM_A", _ratio((1, 3), (2, 3))),
                ("RM_B", _ratio((1, 13), (2, 13)))),
    4: _CONT + ("fracrefa", "fracrefb",
                ("RP_A", _ratio((1, 11), (2, 11))),
                ("RP_B", _ratio((3, 13), (2, 13))),
                ("CORR", ("vector", _LW_CORR4))),
    5: _CONT + ("ka_mo3", "ccl4", "fracrefa", "fracrefb",
                ("RP_A", _ratio((1, 5), (2, 5))),
                ("RP_B", _ratio((3, 43), (2, 43))),
                ("RM_A", _ratio((1, 7), (2, 7)))),
    6: ("ka", "selfref", "forref", "ka_mco2", "cfc11adj", "cfc12",
        "fracrefa"),
    7: _CONT + ("ka_mco2", "kb_mco2", "fracrefa", "fracrefb",
                ("RP_A", _ratio((1, 3), (3, 3))),
                ("RM_A", _ratio((1, 3), (3, 3))),
                ("CORR", ("vector", _LW_CORR7))),
    8: _CONT + ("ka_mco2", "ka_mo3", "ka_mn2o", "kb_mco2", "kb_mn2o",
                "cfc12", "cfc22adj", "fracrefa", "fracrefb"),
    9: _CONT + ("ka_mn2o", "kb_mn2o", "fracrefa", "fracrefb",
                ("RP_A", _ratio((1, 9), (6, 9))),
                ("RM_A", _ratio((1, 3), (6, 3)))),
    10: _CONT + ("fracrefa", "fracrefb"),
    11: _CONT + ("ka_mo2", "kb_mo2", "fracrefa", "fracrefb"),
    12: ("ka", "selfref", "forref", "fracrefa",
         ("RP_A", _ratio((1, 10), (2, 10)))),
    13: ("ka", "selfref", "forref", "ka_mco2", "kb_mo3", "fracrefa",
         "fracrefb", ("RP_A", _ratio((1, 5), (4, 5))),
         ("RM_A", _ratio((1, 1), (4, 1)))),
    14: _CONT + ("fracrefa", "fracrefb"),
    15: ("ka", "selfref", "forref", "ka_mn2", "fracrefa",
         ("RP_A", _ratio((4, 1), (2, 1))),
         ("RM_A", _ratio((4, 1), (2, 1)))),
    16: _CONT + ("fracrefa", "fracrefb",
                 ("RP_A", _ratio((1, 6), (6, 6)))),
}

_RAYL = ("RAYL", ("fill", "rayl"))
_ETA = ("sfluxref", _RAYL, "strrat", "layreffr")
SW_BANDS = {
    16: _CONT + ("sfluxref", _RAYL, "strrat1"),
    17: _CONT + _ETA,
    18: _CONT + _ETA,
    19: _CONT + _ETA,
    20: _CONT + ("sfluxref", "absch4", _RAYL),
    21: _CONT + _ETA,
    22: _CONT + ("sfluxref", _RAYL,
                 ("STRRAT", ("scalar", "strrat", 1.6)), "layreffr"),
    23: ("ka", "selfref", "forref", "sfluxref", "rayl", "givfac"),
    24: _CONT + ("sfluxref", "abso3a", "abso3b", "rayla", "raylb",
                 "strrat", "layreffr"),
    25: ("ka", "sfluxref", "rayl", "abso3a", "abso3b"),
    26: ("sfluxref", "rayl"),
    27: ("ka", "kb", "sfluxref", "rayl", "scalekur"),
    28: ("ka", "kb") + _ETA,
    29: _CONT + ("sfluxref", "absh2o", "absco2", _RAYL),
}

# The tables laid out (g, ...) in the band functions, which the kernels
# read transposed: g-points last
_G_FIRST = ("fracrefa", "fracrefb", "sfluxref", "rayla")
# The shapes the kernels take for granted
_NJP_A, _NJP_B, _NETA_A, _NETA_B, _NMINOR = 13, 47, 9, 5, 19


def _slots(bands, prefix):
    """[(slot name, band, source)] of a band set, in the kernel's order."""
    out = []
    for b, entries in bands.items():
        for e in entries:
            name, src = ((e.upper(), e) if isinstance(e, str) else e)
            out.append((f"{prefix}{b}_{name}", b, src))
    return out


LW_SLOTS = _slots(LW_BANDS, "L") + [("L_CHI_MLS", None, "chi_mls"),
                                     ("L_TOTPLNK", None, "totplnk"),
                                     ("L_PLANCK_SCALE", None,
                                      "planck_scale")]
SW_SLOTS = _slots(SW_BANDS, "S") + [("S_ONES", None, "ones")]


def _g_last(name, arr):
    arr = np.asarray(arr, dtype=np.float64)
    if name in _G_FIRST and arr.ndim == 2:
        return arr.T
    return arr


def _check_shape(key, arr, ng):
    """The kernels' fixed RRTMG shapes (rrtmg_gas.cu): 13 lower and 47
    upper pressures, 5 temperatures, 9 and 5 eta points, 19 minor-gas
    temperatures, the band's g-points last."""
    name = key.split("/", 1)[1]
    want = {"ka": ((_NJP_A, 5, ng), (_NJP_A, 5, _NETA_A, ng)),
            "kb": ((_NJP_B, 5, ng), (_NJP_B, 5, _NETA_B, ng))}.get(name)
    if name.startswith(("ka_m", "kb_m")):
        want = ((_NMINOR, ng), (_NMINOR, _NETA_A, ng),
                (_NMINOR, _NETA_B, ng))
    if want is not None and arr.shape not in want:
        raise ValueError(f"RRTMG table {key} has shape {arr.shape}; the "
                         f"kernels take {want}")
    if arr.ndim and arr.shape[-1] != ng:
        raise ValueError(f"RRTMG table {key} has {arr.shape[-1]} g-points "
                         f"last, its band {ng}")


def _slot_array(tables, band_set, b, src, ng):
    t = lambda key: tables[f"{band_set}:{b}/{key}"]  # noqa: E731
    if b is None:                   # a slot every band shares
        if src == "planck_scale":
            return FLUXFAC * np.asarray(tables["delwave"], dtype=np.float64)
        if src == "ones":
            return np.ones(max(ng.values()))
        return tables[src]          # chi_mls, totplnk
    if isinstance(src, str):
        arr = _g_last(src, t(src))
        _check_shape(f"{band_set}:{b}/{src}", arr, ng[b])
        return arr
    kind = src[0]
    if kind == "fill":
        return np.full(ng[b], float(np.asarray(t(src[1]))))
    if kind == "scalar":
        return np.array([float(np.asarray(t(src[1]))) * src[2]])
    if kind == "ratio":
        chi = np.asarray(tables["chi_mls"], dtype=np.float64)
        (s1, j1), (s2, j2) = src[1], src[2]
        return np.array([float(chi[s1 - 1][j1 - 1])
                         / float(chi[s2 - 1][j2 - 1])])
    if kind == "vector":
        return np.asarray(src[1], dtype=np.float64)
    raise ValueError(f"unknown slot source {src!r}")


def _band_sizes(tables, band_set):
    """{band: its g-points}; the kernels take each band's g-points
    contiguous and the bands in order, as the band functions concatenate
    them, and 140 LW or 112 SW g-points in all."""
    bands, ng = ((LW_BANDS, rrtmg_data.NG_LW) if band_set == "lw"
                 else (SW_BANDS, rrtmg_data.NG_SW))
    bog = np.asarray(tables[f"{band_set}_band_from_g"])
    if np.any(np.diff(bog) < 0) or bog.size != ng \
            or bog.max() >= len(bands):
        raise ValueError(f"{band_set}_band_from_g is not {ng} g-points of "
                         f"{len(bands)} bands in band order")
    counts = np.bincount(bog, minlength=len(bands))
    return {b: int(n) for b, n in zip(bands, counts)}


def pack_tables(tables) -> dict:
    """The kernels' packed buffers from ``rrtmg.setup_tables``' dict (numpy
    or torch leaves): for each band set, ``kernel:<set>`` the float64
    concatenation of its slots (LW_SLOTS, SW_SLOTS) and ``kernel:<set>_
    layout`` a tuple of ints: each slot's offset, the total, then each
    band's first g-point and the g-point count."""
    host = {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in tables.items()}
    out = {}
    for band_set, slots in (("lw", LW_SLOTS), ("sw", SW_SLOTS)):
        ng = _band_sizes(host, band_set)
        arrays = [np.ravel(_slot_array(host, band_set, b, src, ng))
                  for _, b, src in slots]
        offsets = np.concatenate([[0], np.cumsum([a.size for a in arrays])])
        gstart = np.concatenate([[0], np.cumsum(list(ng.values()))])
        out[f"kernel:{band_set}"] = np.concatenate(arrays)
        out[f"kernel:{band_set}_layout"] = tuple(
            int(x) for x in np.concatenate([offsets, gstart]))
    return out


# --- plain versions ----------------------------------------------------------

def _planck_interp_index(t):
    """TOTPLNK LUT index+fraction (radiation_ifs_rrtm.F90:672-690).

    Returns (0-based index, fraction)."""
    ind_mid = torch.floor(t - 159.0).to(torch.int64)
    frac_mid = t - torch.floor(t)
    ind = torch.where(t >= 339.0, torch.full_like(ind_mid, 180),
                      torch.where(t < 160.0, torch.ones_like(ind_mid),
                                  ind_mid))
    frac = torch.where(t >= 339.0, t - 339.0,
                       torch.where(t < 160.0, torch.zeros_like(t),
                                   frac_mid))
    return ind - 1, frac


def _planck_store(totplnk, delwave, temperature):
    """Planck flux per LW band at given temperatures: (...,) ->
    (..., nbands).  totplnk (181, 16)."""
    ind, frac = _planck_interp_index(temperature)
    p = weighted_take(totplnk, [(ind, 1.0 - frac),
                                (torch.clamp(ind + 1, 0, 180), frac)])
    return FLUXFAC * delwave * p


def lw_taumol_plain(tables, cols: GasColumns, temperature_hl,
                    skin_temperature, min_gas_od_lw):
    """(od_lw (ncol, nlev, 140) clamped at min_gas_od_lw, planck_hl
    (ncol, nlev+1, 140), lw_emission (ncol, 140) or None without a skin
    temperature) in torch: the 16 band functions
    (``rrtmg_lw.gas_optical_depth_lw``) and the Planck function at half
    levels, each paired with the Planck fraction of the layer above it
    and the top one with the top layer's (radiation_ifs_rrtm.F90:712-745),
    at the surface with the lowest layer's (:453)."""
    lw_tables = {k[3:]: v for k, v in tables.items() if k.startswith("lw:")}
    lw_tables["chi_mls"] = tables["chi_mls"]
    tau_lw, pfrac = rrtmg_lw.gas_optical_depth_lw(lw_tables, cols)
    od_lw = torch.clamp(tau_lw, min=min_gas_od_lw)
    band_from_g = tables["lw_band_from_g"]
    planck_g_hl = take_bands(_planck_store(tables["totplnk"],
                                           tables["delwave"],
                                           temperature_hl), band_from_g)
    pfrac_hl = torch.cat([pfrac[:, :1], pfrac], dim=1)
    emission = None
    if skin_temperature is not None:
        planck_g_surf = take_bands(_planck_store(tables["totplnk"],
                                                 tables["delwave"],
                                                 skin_temperature),
                                   band_from_g)
        emission = planck_g_surf * pfrac[:, -1]
    return od_lw, planck_g_hl * pfrac_hl, emission


def sw_taumol_plain(tables, cols: GasColumns, min_gas_od_sw):
    """(od_sw (ncol, nlev, 112) clamped at min_gas_od_sw, ssa_sw, the
    solar source sfluxzen (ncol, 112)) in torch: the 14 band functions
    (``rrtmg_sw.gas_optical_depth_sw``), od = Rayleigh + gas, ssa =
    Rayleigh / od."""
    sw_tables = {k[3:]: v for k, v in tables.items() if k.startswith("sw:")}
    taug, taur, sflux = rrtmg_sw.gas_optical_depth_sw(sw_tables, cols)
    od_sw = taur + taug
    return torch.clamp(od_sw, min=min_gas_od_sw), taur / od_sw, sflux


# --- kernel wrappers ---------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _layout_array(layout):
    return (ctypes.c_int * len(layout))(*layout)


def _kernel_inputs(name, tables, band_set, cols, extra):
    """Check what a launch reads and return (the column fields in the
    kernel's order, the packed buffer, its layout).  The fields must be
    (ncol, nlev) and contiguous, floats of the working dtype (float32 or
    float64), the indices int64 and tropo bool, on one CUDA device, like
    the ``extra`` {arg: (tensor, shape)}; the packed buffer
    (``pack_tables``) too.  Raises on anything else, the device last."""
    ref = cols.colh2o
    if ref.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: unsupported dtype {ref.dtype}")
    if ref.dim() != 2:
        raise ValueError(f"{name}: colh2o must be (ncol, nlev), not "
                         f"{tuple(ref.shape)}")
    ncol, nlev = ref.shape
    specs = {f: (getattr(cols, f), ref.dtype, (ncol, nlev))
             for f in FLOAT_FIELDS}
    specs.update({f: (getattr(cols, f), torch.int64, (ncol, nlev))
                  for f in INT_FIELDS})
    specs["tropo"] = (cols.tropo, torch.bool, (ncol, nlev))
    key = f"kernel:{band_set}"
    if key not in tables:
        raise ValueError(f"{name}: the tables hold no packed kernel "
                         f"buffers ({key}; rrtmg.setup_tables makes them)")
    layout = tables[f"{key}_layout"]
    slots = LW_SLOTS if band_set == "lw" else SW_SLOTS
    if len(layout) != len(slots) + 1 + len(LW_BANDS if band_set == "lw"
                                              else SW_BANDS) + 1:
        raise ValueError(f"{name}: {key}_layout does not match the "
                         f"kernel's slots")
    specs["pack"] = (tables[key], ref.dtype, (layout[len(slots)],))
    specs.update({k: (t, ref.dtype, s) for k, (t, s) in extra.items()})
    for arg, (t, dtype, shape) in specs.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != dtype or t.device != ref.device:
            raise ValueError(f"{name}: {arg} must be {dtype} on "
                             f"{ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
    if ref.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {ref.device}")
    if ncol * nlev * max(layout[len(slots) + 1:]) >= 2**31:
        raise ValueError(f"{name}: {ncol} x {nlev} rows exceed the "
                         f"kernel's int index")
    fields = [getattr(cols, f) for f in FLOAT_FIELDS + INT_FIELDS]
    return fields + [cols.tropo], tables[key], layout


def lw_taumol(tables, cols: GasColumns, temperature_hl, skin_temperature,
              min_gas_od_lw):
    """(od_lw, planck_hl, lw_emission) as ``lw_taumol_plain`` returns
    them.  CPU tensors run the plain version; CUDA tensors launch
    rrtmg_lw_taumol_kernel (csrc/rrtmg_gas.cu) or raise."""
    if cols.colh2o.device.type == "cpu":
        return lw_taumol_plain(tables, cols, temperature_hl,
                               skin_temperature, min_gas_od_lw)
    ncol, nlev = cols.colh2o.shape
    extra = {"temperature_hl": (temperature_hl, (ncol, nlev + 1))}
    if skin_temperature is not None:
        extra["skin_temperature"] = (skin_temperature, (ncol,))
    fields, pack, layout = _kernel_inputs("rrtmg_lw_taumol", tables, "lw",
                                          cols, extra)
    ng = layout[-1]
    e = lambda *shape: torch.empty(shape, dtype=pack.dtype,  # noqa: E731
                                   device=pack.device)
    od, planck_hl = e(ncol, nlev, ng), e(ncol, nlev + 1, ng)
    emission = None if skin_temperature is None else e(ncol, ng)
    if ncol == 0:
        return od, planck_hl, emission
    lib = kernels.library()
    fn = (lib.ecrad_rrtmg_lw_taumol_f32 if pack.dtype == torch.float32
          else lib.ecrad_rrtmg_lw_taumol_f64)
    ptrs = kernels.pointer_array(fields + [temperature_hl, skin_temperature,
                                           pack, od, planck_hl, emission])
    with torch.cuda.device(pack.device):
        code = fn(ptrs, _layout_array(layout), ncol, nlev,
                  float(min_gas_od_lw), kernels.stream_of(pack))
    kernels.check(code, "rrtmg_lw_taumol")
    lw_taumol.launches += 1
    return od, planck_hl, emission


lw_taumol.launches = 0


def sw_taumol(tables, cols: GasColumns, min_gas_od_sw):
    """(od_sw, ssa_sw, sfluxzen) as ``sw_taumol_plain`` returns them.  CPU
    tensors run the plain version; CUDA tensors launch
    rrtmg_sw_taumol_kernel (csrc/rrtmg_gas.cu) or raise."""
    if cols.colh2o.device.type == "cpu":
        return sw_taumol_plain(tables, cols, min_gas_od_sw)
    ncol, nlev = cols.colh2o.shape
    fields, pack, layout = _kernel_inputs("rrtmg_sw_taumol", tables, "sw",
                                          cols, {})
    ng = layout[-1]
    e = lambda *shape: torch.empty(shape, dtype=pack.dtype,  # noqa: E731
                                   device=pack.device)
    od, ssa, sflux = e(ncol, nlev, ng), e(ncol, nlev, ng), e(ncol, ng)
    if ncol == 0:
        return od, ssa, sflux
    lib = kernels.library()
    fn = (lib.ecrad_rrtmg_sw_taumol_f32 if pack.dtype == torch.float32
          else lib.ecrad_rrtmg_sw_taumol_f64)
    ptrs = kernels.pointer_array(fields + [pack, od, ssa, sflux])
    with torch.cuda.device(pack.device):
        code = fn(ptrs, _layout_array(layout), ncol, nlev,
                  float(min_gas_od_sw), kernels.stream_of(pack))
    kernels.check(code, "rrtmg_sw_taumol")
    sw_taumol.launches += 1
    return od, ssa, sflux


sw_taumol.launches = 0
