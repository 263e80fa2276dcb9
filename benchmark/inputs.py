"""The benchmark's inputs: the bundled meridian profiles, and a pool of
distinct calls drawn from them on the device from the run's seed.

Each column of a call is one of the 32 bundled meridian profiles
(thermodynamics, gases, clouds, aerosols, surface), drawn with
replacement; its cosine of the solar zenith angle is drawn uniformly on
[-1, 1) (the distribution over a uniformly sampled sphere: half the
columns are in night), or, where a mix puts every column in daylight
(``sun`` ``day``), on (0, 1] (over the sunlit hemisphere; ecRad counts a
cosine of 0 or less as night); and it gets a fresh McICA seed.  Both the
program and the reference are handed the same tensors.

Where a configuration file has a ``driver`` group, ecRad's
``&radiation_driver`` cloud-separation settings, each profile also
carries the cloud effective sizes that ecRad's offline driver derives
from them (``effective_sizes``), as the SPARTACUS solvers read them.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from scipy.io import netcdf_file

from benchmark.reference import constants

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MERIDIAN = os.path.join(REPO_ROOT, "ecrad_tpu", "data", "io",
                        "ecrad_meridian.nc")
# McICA seeds are drawn on [1, 2**31 - 1), the range of ecRad's integer
# seeds
SEED_HIGH = 2**31 - 1
# The keys of a configuration file's ``driver`` group, all required: the
# &radiation_driver settings from which ecRad's offline driver derives
# the cloud effective sizes (ecrad_driver_read_input.F90:290-465, where
# they take precedence over the sizes in the input file)
DRIVER_KEYS = ("cloud_separation_scale_toa", "cloud_separation_scale_surface",
               "cloud_separation_scale_power", "cloud_inhom_separation_factor")


def effective_sizes(pressure_hl, fraction, driver: dict):
    """The inverse cloud effective size and inverse inhomogeneity size
    (ncol, nlev) of each layer, from the half-level pressure (top first)
    and the cloud fraction before cropping, by ecRad's
    param_cloud_effective_separation_eta (radiation_cloud.F90:602-690):
    the cloud separation scale runs from the surface's to the top's as
    a + b exp(-eta^power) in eta, the mid-layer pressure over the
    surface's."""
    if set(driver) != set(DRIVER_KEYS):
        raise ValueError(f"a driver group has exactly {sorted(DRIVER_KEYS)};"
                         f" got {sorted(driver)}")
    toa = driver["cloud_separation_scale_toa"]
    surface = driver["cloud_separation_scale_surface"]
    p = np.asarray(pressure_hl, dtype=np.float64)
    f = np.asarray(fraction, dtype=np.float64)
    eta = 0.5 * (p[:, :-1] + p[:, 1:]) / p[:, -1:]
    b = (toa - surface) / (1.0 - np.exp(-1.0))
    a = toa - b
    separation = a + b * np.exp(-eta ** driver["cloud_separation_scale_power"])
    inv_cloud = 1.0 / (separation * np.sqrt(np.maximum(1.0e-5, f * (1.0 - f))))
    inv_inhom = 1.0 / (separation * driver["cloud_inhom_separation_factor"]
                       * np.sqrt(np.maximum(1.0e-5,
                                            0.5 * f * (1.0 - 0.5 * f))))
    return inv_cloud, inv_inhom


def read_profiles(path: str = MERIDIAN, driver: dict = None) -> dict:
    """The columns of an ecRad input file as float64 numpy arrays, levels
    top of atmosphere first, in the keyword layout of
    ``pipeline.radiation_blocked``: gases as mass mixing ratios in
    ``constants.GAS_NAMES`` order, the cloud and aerosol groups as dicts,
    and ``solar_irradiance`` a float.  With a configuration's ``driver``
    group the cloud group also holds ``inv_cloud_effective_size`` and
    ``inv_inhom_effective_size`` (``effective_sizes``)."""
    with netcdf_file(path, "r", mmap=False) as f:
        v = {k: np.array(x.data, dtype=np.float64)
             for k, x in f.variables.items()}
    if v["pressure_hl"][0, 0] > v["pressure_hl"][0, -1]:
        raise ValueError(f"{path}: levels must run from the top down")
    ncol, nlev = v["cloud_fraction"].shape
    gas = np.zeros((ncol, nlev, constants.NUM_GASES))
    gas[..., constants.GAS_INDEX["h2o"]] = v["q"]
    gas[..., constants.GAS_INDEX["o3"]] = v["o3_mmr"]
    for name in constants.GAS_NAMES:
        if f"{name}_vmr" in v:
            gas[..., constants.GAS_INDEX[name]] = (
                v[f"{name}_vmr"] * constants.MOLAR_MASS[name]
                / constants.MOLAR_MASS_DRY_AIR)
    cloud = dict(fraction=v["cloud_fraction"], q_liq=v["q_liquid"],
                 q_ice=v["q_ice"], re_liq=v["re_liquid"], re_ice=v["re_ice"],
                 overlap_param=v["overlap_param"],
                 fractional_std=v["fractional_std"])
    if driver is not None:
        cloud["inv_cloud_effective_size"], cloud["inv_inhom_effective_size"] \
            = effective_sizes(v["pressure_hl"], v["cloud_fraction"], driver)
    return dict(
        pressure_hl=v["pressure_hl"], temperature_hl=v["temperature_hl"],
        gas_mmr=gas, skin_temperature=v["skin_temperature"],
        sw_albedo=v["sw_albedo"], sw_albedo_direct=v["sw_albedo_direct"],
        lw_emissivity=v["lw_emissivity"], cloud=cloud,
        aerosol=dict(mixing_ratio=np.moveaxis(v["aerosol_mmr"], 1, 2)),
        solar_irradiance=float(v["solar_irradiance"]))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, x) for k, x in tree.items()}
    return fn(tree)


def profiles_on(profiles: dict, device, dtype) -> dict:
    """The profiles' arrays as tensors on ``device`` in ``dtype``."""
    return _map(lambda x: x if isinstance(x, float)
                else torch.as_tensor(x, dtype=dtype, device=device),
                profiles)


def make_pool(profiles: dict, seed: int, ncall: int, ncol: int,
              sun: str = "any") -> list:
    """``ncall`` distinct calls of ``ncol`` columns each, drawn from
    ``seed`` on the profiles' device: a list of the keyword inputs of
    ``pipeline.radiation_blocked`` (without ``solar_irradiance``).  With
    ``sun`` "any" the solar zenith cosines are uniform on [-1, 1), with
    "day" on (0, 1]; both take the same draws, in the same order, from
    the seed's generator."""
    base = {k: x for k, x in profiles.items() if k != "solar_irradiance"}
    device = base["pressure_hl"].device
    dtype = base["pressure_hl"].dtype
    nprof = base["pressure_hl"].shape[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    pool = []
    for _ in range(ncall):
        idx = torch.randint(0, nprof, (ncol,), generator=gen, device=device)
        call = _map(lambda x: x[idx], base)
        u = torch.rand(ncol, generator=gen, device=device,
                       dtype=torch.float64)
        call["cos_sza"] = (1.0 - u if sun == "day"
                           else 2.0 * u - 1.0).to(dtype)
        call["cloud"]["iseed"] = torch.randint(
            1, SEED_HIGH, (ncol,), generator=gen, device=device,
            dtype=torch.int64)
        pool.append(call)
    return pool


def columns(call: dict, cols) -> dict:
    """The inputs of the columns ``cols`` (an index tensor) of a call."""
    return _map(lambda x: x[cols.to(x.device)], call)


def cloudy_fraction(call: dict, fraction_threshold: float,
                    mixing_ratio_threshold: float) -> float:
    """The share of a call's (column, layer) pairs that hold cloud, by the
    thresholds of ecRad's crop_cloud_fraction."""
    c = call["cloud"]
    cloudy = ((c["fraction"] >= fraction_threshold)
              & (c["q_liq"] + c["q_ice"] >= mixing_ratio_threshold))
    return float(cloudy.double().mean())
