"""RRTMG k-distribution table loading.

Tables are extracted from the reference data files by
tools/extract_rrtmg.py into ``ecrad_tpu/data/rrtmg.npz``, which the port
reads by path (g-point-reduced:
140 LW g-points over 16 bands, 112 SW g-points over 14 bands — the
operational RRTMG-IFS configuration, ifsrrtm/yoerrtm.F90:58,
ifsrrtm/yoesrtm.F90:41).

At setup the tables become one flat dict of torch tensors on the chosen
device; band structure metadata lives in `RRTMGMeta` (static, hashable).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Tuple

import numpy as np

from benchmark.reference.data import DATA_DIR

_NPZ_PATH = os.path.join(DATA_DIR, "rrtmg.npz")

NBANDS_LW = 16
NBANDS_SW = 14
NG_LW = 140
NG_SW = 112

# LW band bounds in cm-1 (radiation_ifs_rrtm.F90:160-165
# allocate_bands_only call — RRTMG v4.85 band 1 spans 10-350)
LW_WAVENUM1 = np.array([10., 350., 500., 630., 700., 820., 980., 1080.,
                        1180., 1390., 1480., 1800., 2080., 2250., 2380.,
                        2600.])
LW_WAVENUM2 = np.array([350., 500., 630., 700., 820., 980., 1080., 1180.,
                        1390., 1480., 1800., 2080., 2250., 2380., 2600.,
                        3250.])
# SW band bounds in cm-1 (ifsrrtm/susrtm.F90 WAVENUM1/2 comments); band 14
# (index 13) is the 820-2600 cm-1 band that wraps around
SW_WAVENUM1 = np.array([2600., 3250., 4000., 4650., 5150., 6150., 7700.,
                        8050., 12850., 16000., 22650., 29000., 38000.,
                        820.])
SW_WAVENUM2 = np.array([3250., 4000., 4650., 5150., 6150., 7700., 8050.,
                        12850., 16000., 22650., 29000., 38000., 50000.,
                        2600.])


@dataclasses.dataclass(frozen=True)
class RRTMGMeta:
    """Static band-structure metadata (hashable; jit-static)."""
    ng_lw: int = NG_LW
    ng_sw: int = NG_SW
    nbands_lw: int = NBANDS_LW
    nbands_sw: int = NBANDS_SW
    # per-band g-point counts
    ngc_lw: Tuple[int, ...] = ()
    ngc_sw: Tuple[int, ...] = ()


@functools.lru_cache(maxsize=1)
def load_tables(path: str = _NPZ_PATH):
    """Load the extracted tables as a plain dict of numpy arrays."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@functools.lru_cache(maxsize=1)
def meta(path: str = _NPZ_PATH) -> RRTMGMeta:
    t = load_tables(path)
    return RRTMGMeta(
        ngc_lw=tuple(int(x) for x in t["lw_ngc"]),
        ngc_sw=tuple(int(x) for x in t["sw_ngc"]),
    )


def band_from_g_lw(path: str = _NPZ_PATH) -> np.ndarray:
    return load_tables(path)["lw_band_from_g"]


def band_from_g_sw(path: str = _NPZ_PATH) -> np.ndarray:
    return load_tables(path)["sw_band_from_g"]


# G-point reordering by approximately increasing gas optical depth, used by
# the SPARTACUS solvers so the 3D (matrix-exponential) treatment applies to
# an optically-thin prefix of the spectrum
# (radiation_ifs_rrtm.F90:51-67, RRTM_GPOINT_REORDERING_LW/SW; 0-based
# here: entry i gives the original g-point index of reordered point i).
RRTM_GPOINT_REORDERING_LW = np.array([
    89, 90, 139, 77, 137, 69, 131, 97, 91, 70, 78, 71, 53, 72, 123, 54,
    79, 98, 92, 55, 80, 132, 124, 81, 73, 56, 99, 82, 57, 23, 125, 100,
    24, 74, 93, 58, 25, 83, 126, 75, 26, 11, 101, 133, 59, 27, 76, 140,
    12, 84, 102, 94, 28, 127, 85, 13, 39, 60, 86, 103, 87, 109, 14, 29,
    115, 40, 95, 15, 61, 88, 41, 110, 104, 1, 116, 42, 30, 134, 128, 138,
    96, 62, 16, 43, 117, 63, 111, 44, 2, 64, 31, 65, 105, 17, 45, 66,
    118, 32, 3, 33, 67, 18, 129, 135, 46, 112, 34, 106, 68, 35, 4, 119,
    36, 47, 107, 19, 37, 38, 113, 48, 130, 5, 120, 49, 108, 20, 50, 51,
    114, 21, 121, 52, 136, 122, 6, 22, 7, 8, 9, 10], dtype=np.int32) - 1

RRTM_GPOINT_REORDERING_SW = np.array([
    35, 45, 19, 27, 36, 57, 20, 46, 58, 21, 28, 67, 55, 68, 37, 1, 69,
    22, 29, 59, 78, 101, 79, 77, 70, 76, 47, 75, 30, 81, 60, 102, 80,
    82, 23, 2, 83, 84, 85, 86, 103, 61, 31, 87, 56, 38, 71, 48, 88, 3,
    62, 89, 24, 7, 49, 32, 104, 72, 90, 63, 39, 4, 8, 50, 91, 64, 40,
    33, 25, 51, 95, 96, 73, 65, 9, 41, 97, 92, 105, 52, 5, 98, 10, 42,
    99, 100, 66, 11, 74, 34, 53, 26, 6, 106, 12, 43, 13, 54, 93, 44,
    107, 94, 14, 108, 15, 16, 109, 17, 18, 110, 111, 112],
    dtype=np.int32) - 1
