"""Debug output writers: input dump and radiative-property dump (port of
``ecrad_tpu/io/save_extras.py``).

Reference: radiation/radiation_save.F90 save_inputs (L1026-1313) and
save_radiative_properties (L716-1025) — used by the driver's
do_save_inputs / do_save_radiative_properties namelist options.
"""

from __future__ import annotations

import numpy as np

from ecrad_torch import constants
from ecrad_torch.config import Config
from ecrad_torch.containers import to_numpy
from ecrad_torch.io.netcdf import NcWriter


def save_inputs(path: str, config: Config, inp, lat=None, lon=None):
    """Write a RadiationInput back to NetCDF with the reference's
    variable names (radiation_save.F90:1026-1313), so the file can be
    re-run through the driver."""
    w = NcWriter(path)
    w.set_global_attr("title", "Radiation scheme inputs")
    arr = to_numpy
    phl = arr(inp.thermodynamics.pressure_hl)
    ncol, nhl = phl.shape

    w.write_scalar("solar_irradiance", float(inp.solar_irradiance),
                   units="W m-2")
    if lat is not None:
        w.write("lat", arr(lat), ("column",), units="degrees_north")
    if lon is not None:
        w.write("lon", arr(lon), ("column",), units="degrees_east")
    w.write("skin_temperature", arr(inp.skin_temperature), ("column",),
            units="K")
    w.write("cos_solar_zenith_angle", arr(inp.cos_sza), ("column",))
    w.write("sw_albedo", arr(inp.sw_albedo), ("column", "sw_albedo_band"))
    if inp.sw_albedo_direct is not None:
        w.write("sw_albedo_direct", arr(inp.sw_albedo_direct),
                ("column", "sw_albedo_band"))
    w.write("lw_emissivity", arr(inp.lw_emissivity),
            ("column", "lw_emissivity_band"))
    # float64: a float32 file would round seeds above 2**24 (the JAX
    # package's writer does), and a re-run would draw another sample
    w.write("iseed", arr(inp.iseed).astype(np.float64), ("column",),
            dtype="f8")
    w.write("pressure_hl", phl, ("column", "half_level"), units="Pa",
            dtype="f8")
    w.write("temperature_hl", arr(inp.thermodynamics.temperature_hl),
            ("column", "half_level"), units="K", dtype="f8")

    # gases: h2o as "q", o3 as "o3_mmr", the rest as "<gas>_vmr"
    # (radiation_save.F90 writes per the container units; the driver
    # reader accepts all three conventions)
    gm = arr(inp.gas_mmr)
    w.write("q", gm[:, :, constants.GAS_INDEX["h2o"]],
            ("column", "level"), units="kg kg-1", dtype="f8")
    w.write("o3_mmr", gm[:, :, constants.GAS_INDEX["o3"]],
            ("column", "level"), units="kg kg-1", dtype="f8")
    for name in ("co2", "ch4", "n2o", "co", "o2", "cfc11", "cfc12",
                 "hcfc22", "ccl4", "no2"):
        vmr = gm[:, :, constants.GAS_INDEX[name]] \
            * (constants.MOLAR_MASS_DRY_AIR / constants.MOLAR_MASS[name])
        w.write(f"{name}_vmr", vmr, ("column", "level"), units="1",
                dtype="f8")

    if config.do_clouds:
        w.write("cloud_fraction", arr(inp.cloud_fraction),
                ("column", "level"))
        w.write("q_liquid", arr(inp.cloud_mixing_ratio[:, :, 0]),
                ("column", "level"), units="kg kg-1")
        w.write("q_ice", arr(inp.cloud_mixing_ratio[:, :, 1]),
                ("column", "level"), units="kg kg-1")
        w.write("re_liquid", arr(inp.cloud_effective_radius[:, :, 0]),
                ("column", "level"), units="m")
        w.write("re_ice", arr(inp.cloud_effective_radius[:, :, 1]),
                ("column", "level"), units="m")
        w.write("overlap_param", arr(inp.overlap_param),
                ("column", "level_interface"))
        w.write("fractional_std", arr(inp.fractional_std),
                ("column", "level"))
        if inp.inv_cloud_effective_size is not None:
            w.write("inv_cloud_effective_size",
                    arr(inp.inv_cloud_effective_size),
                    ("column", "level"), units="m-1")
        if inp.inv_inhom_effective_size is not None:
            w.write("inv_inhom_effective_size",
                    arr(inp.inv_inhom_effective_size),
                    ("column", "level"), units="m-1")
    if config.use_aerosols and inp.aerosol_mmr is not None:
        # file layout (col, type, lev) as the reference reads it
        w.write("aerosol_mmr", np.moveaxis(arr(inp.aerosol_mmr), 2, 1),
                ("column", "aerosol_type", "level"), units="kg kg-1")
    w.close()


def save_radiative_properties(path: str, config: Config, props: dict):
    """Write the per-g-point optical property dump
    (radiation_save.F90:716-1025).  props from
    interface.compute_radiative_properties; spectral axes last here,
    written with gpoint/band dimensions."""
    w = NcWriter(path)
    w.set_global_attr("title", "Radiative properties")
    arr = to_numpy
    dims3_lw = ("column", "level", "gpoint_lw")
    dims3_sw = ("column", "level", "gpoint_sw")
    name_map = {
        "od_lw": dims3_lw, "ssa_lw": dims3_lw, "asymmetry_lw": dims3_lw,
        "od_sw": dims3_sw, "ssa_sw": dims3_sw, "asymmetry_sw": dims3_sw,
        "planck_hl": ("column", "half_level", "gpoint_lw"),
        "lw_emission": ("column", "gpoint_lw"),
        "lw_emissivity": ("column", "gpoint_lw"),
        "incoming_sw": ("column", "gpoint_sw"),
        "sw_albedo": ("column", "gpoint_sw"),
        "sw_albedo_direct": ("column", "gpoint_sw"),
        "cloud_fraction": ("column", "level"),
        "od_lw_cloud": ("column", "level", "band_lw"),
        "ssa_lw_cloud": ("column", "level", "band_lw"),
        "asymmetry_lw_cloud": ("column", "level", "band_lw"),
        "od_sw_cloud": ("column", "level", "band_sw"),
        "ssa_sw_cloud": ("column", "level", "band_sw"),
        "asymmetry_sw_cloud": ("column", "level", "band_sw"),
    }
    for name, dims in name_map.items():
        v = props.get(name)
        if v is not None:
            w.write(name, arr(v), dims, dtype="f8")
    w.close()
