"""The flagship configuration as a ready-to-run step: RRTMG gas optics,
McICA SW and LW, IFS general aerosols with RH growth, SOCRATES liquid
and Fu ice, LW derivatives and canopy fluxes, absorption-only LW
aerosols (the CY49R1 operational setup), on the bundled 32-column,
137-level meridian slice tiled to any column count.  The other named
configurations change the solvers:

* ``tripleclouds_rrtmg``: Tripleclouds SW and LW;
* ``cloudless_rrtmg``: Cloudless SW and LW (no cloud optics, no sample);
* ``homogeneous_rrtmg``: Homogeneous SW and LW with LW aerosol scattering
  on (ecRad's default), so LW takes the unfused adding sweeps;
* ``spartacus_3d``: SPARTACUS SW and LW with 3D effects (Explicit
  entrapment, LW side emissivity) and no SW delta scaling with gases;
* ``tripleclouds_ecckd``: Tripleclouds SW and LW on ecCKD gas optics (32
  g-points in each band set) with general cloud optics per g-point,
  Planck-weighted LW emissivities and no aerosols;
* ``ecckd_mcica``: the same on the McICA solvers;
* ``spartacus_ecckd``: ``spartacus_3d``'s solvers on ``tripleclouds_ecckd``'s
  optics (ecCKD at 32 g-points, general cloud optics, no aerosols): the
  SPARTACUS kernels at one warp per block;
* ``tripleclouds_baran2016``: Tripleclouds SW and LW with Slingo liquid
  (Slingo SW, Lindner-Li LW) and Baran2016 ice, the band-wise cloud optics
  models other than SOCRATES/Fu, with the flagship's aerosols;
* ``mcica_rrtmg_spectral``: the flagship with spectral flux profiles per
  band (do_save_spectral_flux, as the CY49R1 namelist sets it) and TOA
  fluxes per band (do_toa_spectral_flux): the McICA kernels write their
  per-g planes, projected onto the 14 SW / 16 LW bands;
* ``tripleclouds_ecckd_gpoint``: ``tripleclouds_ecckd`` with flux
  profiles per g-point (do_save_gpoint_flux): the Tripleclouds kernels
  write their per-g planes at 32 g-points;
* ``cloudless_rrtmg_spectral``, ``homogeneous_rrtmg_spectral``:
  ``cloudless_rrtmg`` and ``homogeneous_rrtmg`` with flux profiles and TOA
  fluxes per band: the adding sweeps (and the McICA SW kernel of the
  Homogeneous path) write their per-g planes;
* ``monochromatic_homogeneous``: monochromatic gas and cloud optics (one
  g-point in each band set; column optical depths 1.0 LW and 0.2 SW, as
  tests/test_monochromatic.py) with Homogeneous SW and LW and no
  aerosols, on the meridian slice's clouds: every kernel of the path at
  ng = 1.

The fields a configuration's Flux sets (``Flux.fields()``) depend on it:
the spectral ones only with the flags above.

Mirrors ``__graft_entry__._build`` of the JAX package with the same
``nam_overrides``: the same Config, cloud-separation settings and tiling
(for ``tripleclouds_rrtmg``, ``spartacus_3d`` and the two ecCKD
configurations, the overrides of ``tools/bench_matrix.py`` CONFIGS),
including the cloud sizes that SPARTACUS reads.
"""

from __future__ import annotations

import numpy as np
import torch

from ecrad_torch import pipeline
from ecrad_torch.config import (GAS_MODEL_NAMES, ICE_MODEL_NAMES,
                                LIQUID_MODEL_NAMES, SOLVER_NAMES, Config,
                                GasModel, IceModel, LiquidModel, Solver)
from ecrad_torch.data import DATA_DIR, MERIDIAN_INPUT
from ecrad_torch.interface import setup_radiation
from ecrad_torch.io.input import DriverConfig, read_input

ARG_ORDER = ("pressure_hl", "temperature_hl", "gas_mmr", "cos_sza",
             "skin_temperature", "sw_albedo", "sw_albedo_direct",
             "lw_emissivity", "cloud", "aerosol")


# ecCKD gas optics in both band sets, with general cloud optics and
# without aerosols
ECCKD = dict(gas_model_sw=GasModel.ECCKD, gas_model_lw=GasModel.ECCKD,
             use_general_cloud_optics=True,
             do_nearest_spectral_lw_emiss=False, use_aerosols=False,
             n_aerosol_types=0, i_aerosol_type_map=())
# SPARTACUS in both band sets with 3D effects and no SW delta scaling with
# gases
SPARTACUS_3D = dict(sw_solver=Solver.SPARTACUS, lw_solver=Solver.SPARTACUS,
                    do_3d_effects=True, do_sw_delta_scaling_with_gases=False)

# Named configurations: Config fields over the flagship's
CONFIGS = {
    "mcica_rrtmg": {},
    "tripleclouds_rrtmg": dict(sw_solver=Solver.TRIPLECLOUDS,
                               lw_solver=Solver.TRIPLECLOUDS),
    "cloudless_rrtmg": dict(sw_solver=Solver.CLOUDLESS,
                            lw_solver=Solver.CLOUDLESS),
    "homogeneous_rrtmg": dict(sw_solver=Solver.HOMOGENEOUS,
                              lw_solver=Solver.HOMOGENEOUS,
                              do_lw_aerosol_scattering=True),
    "spartacus_3d": SPARTACUS_3D,
    "tripleclouds_ecckd": dict(sw_solver=Solver.TRIPLECLOUDS,
                               lw_solver=Solver.TRIPLECLOUDS,
                               **ECCKD),
    "ecckd_mcica": ECCKD,
    "spartacus_ecckd": dict(**SPARTACUS_3D, **ECCKD),
    "tripleclouds_baran2016": dict(sw_solver=Solver.TRIPLECLOUDS,
                                   lw_solver=Solver.TRIPLECLOUDS,
                                   liquid_model=LiquidModel.SLINGO,
                                   ice_model=IceModel.BARAN2016),
    "mcica_rrtmg_spectral": dict(do_save_spectral_flux=True,
                                 do_toa_spectral_flux=True),
    "tripleclouds_ecckd_gpoint": dict(sw_solver=Solver.TRIPLECLOUDS,
                                      lw_solver=Solver.TRIPLECLOUDS,
                                      do_save_gpoint_flux=True, **ECCKD),
    "cloudless_rrtmg_spectral": dict(sw_solver=Solver.CLOUDLESS,
                                     lw_solver=Solver.CLOUDLESS,
                                     do_save_spectral_flux=True,
                                     do_toa_spectral_flux=True),
    "homogeneous_rrtmg_spectral": dict(sw_solver=Solver.HOMOGENEOUS,
                                       lw_solver=Solver.HOMOGENEOUS,
                                       do_lw_aerosol_scattering=True,
                                       do_save_spectral_flux=True,
                                       do_toa_spectral_flux=True),
    "monochromatic_homogeneous": dict(
        gas_model_sw=GasModel.MONOCHROMATIC,
        gas_model_lw=GasModel.MONOCHROMATIC,
        sw_solver=Solver.HOMOGENEOUS, lw_solver=Solver.HOMOGENEOUS,
        mono_lw_total_od=1.0, mono_sw_total_od=0.2, use_aerosols=False,
        n_aerosol_types=0, i_aerosol_type_map=()),
}


# The flagship's Config fields (__graft_entry__._build)
_FLAGSHIP_FIELDS = dict(
    liquid_model=LiquidModel.SOCRATES, ice_model=IceModel.FU,
    # the CY49R1 operational namelist runs absorption-only LW aerosols
    # (test/ifs/configCY49R1.nam:45)
    do_lw_aerosol_scattering=False,
    do_lw_derivatives=True, do_canopy_fluxes_sw=True,
    do_canopy_fluxes_lw=True, do_nearest_spectral_lw_emiss=True,
    i_lw_emiss_index=(1, 2, 1),
    lw_emiss_wavelength_bound=(8.0e-6, 13.0e-6),
    i_sw_albedo_index=(1, 2, 3, 4, 5, 6),
    sw_albedo_wavelength_bound=(0.25e-6, 0.44e-6, 0.69e-6, 1.19e-6,
                                2.38e-6),
    use_aerosols=True, n_aerosol_types=12,
    i_aerosol_type_map=(-1, -2, -3, 7, 8, 9, -4, 10, 11, 11, -5, 14),
    use_general_cloud_optics=False)
# The flagship's &radiation_driver settings: the cloud separation scales
# from which read_input derives the cloud effective sizes
DRIVER_SETTINGS = dict(cloud_separation_scale_toa=14000.0,
                       cloud_separation_scale_surface=2500.0,
                       cloud_separation_scale_power=3.5,
                       cloud_inhom_separation_factor=0.75)
# Config enum fields -> (namelist key, its names)
_NAMELIST_ENUMS = {
    "sw_solver": ("sw_solver_name", SOLVER_NAMES),
    "lw_solver": ("lw_solver_name", SOLVER_NAMES),
    "gas_model_sw": ("sw_gas_model_name", GAS_MODEL_NAMES),
    "gas_model_lw": ("lw_gas_model_name", GAS_MODEL_NAMES),
    "liquid_model": ("liquid_model_name", LIQUID_MODEL_NAMES),
    "ice_model": ("ice_model_name", ICE_MODEL_NAMES),
}


def _namelist_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return f'"{v}"'
    if isinstance(v, tuple):
        return ", ".join(_namelist_value(x) for x in v)
    return repr(v)


def namelist_text(config_name: str = "mcica_rrtmg",
                  data_dir: str = DATA_DIR, **driver) -> str:
    """A namelist file's text for a named configuration (CONFIGS), for
    the drivers: a &radiation group with its Config fields (enums by
    their namelist names) and ``directory_name``, and a
    &radiation_driver group with DRIVER_SETTINGS and ``driver``'s
    entries.  Config.from_namelist reads it back as
    flagship_config(..., config_name) with that directory_name."""
    config = flagship_config("float64", config_name)
    fields = {**_FLAGSHIP_FIELDS, **CONFIGS[config_name]}
    lines = ["&radiation", f'directory_name = "{data_dir}",']
    for name in fields:
        if name == "dtype_name" or getattr(config, name) == ():
            continue
        value = getattr(config, name)
        if name in _NAMELIST_ENUMS:
            key, names = _NAMELIST_ENUMS[name]
            label = next(k for k, v in names.items() if v == value)
            lines.append(f'{key} = "{label}",')
        else:
            lines.append(f"{name} = {_namelist_value(value)},")
    lines += ["/", "&radiation_driver"]
    lines += [f"{k} = {_namelist_value(v)},"
              for k, v in {**DRIVER_SETTINGS, **driver}.items()]
    return "\n".join(lines + ["/", ""])


def flagship_config(dtype_name: str,
                    config_name: str = "mcica_rrtmg") -> Config:
    """The Config of a named configuration before setup
    (__graft_entry__._build with that configuration's overrides)."""
    if config_name not in CONFIGS:
        raise ValueError(f"unknown configuration {config_name!r}; "
                         f"known: {sorted(CONFIGS)}")
    return Config(**{**_FLAGSHIP_FIELDS, **CONFIGS[config_name],
                     "dtype_name": dtype_name})


def build(ncol=32, dtype=torch.float32, device="cuda", block_size=None,
          config_name="mcica_rrtmg"):
    """Build the step of a named configuration (CONFIGS) and its example
    inputs, on the card unless ``device`` says otherwise.

    Returns ``(step, args)``: ``step(*args)`` runs
    ``pipeline.radiation_step`` (or ``radiation_blocked`` when
    block_size is given) and returns a Flux; ``args`` are tensors on
    ``device`` in ``dtype`` in ARG_ORDER.  ``step.config``,
    ``step.tables`` and ``step.solar`` carry the consolidated setup."""
    device = torch.device(device)
    dtype_name = "float64" if dtype == torch.float64 else "float32"
    config, tables = setup_radiation(
        flagship_config(dtype_name, config_name), device, dtype,
        data_dir=DATA_DIR)
    inp = read_input(MERIDIAN_INPUT, DriverConfig(**DRIVER_SETTINGS))
    inputs = inputs_from(inp, dtype, device, ncol)
    solar = float(inp.solar_irradiance)

    def step(*args) -> "pipeline.Flux":
        kw = dict(zip(ARG_ORDER, args))
        if block_size is not None:
            return pipeline.radiation_blocked(
                config, tables, solar_irradiance=solar,
                block_size=block_size, **kw)
        return pipeline.radiation_step(config, tables,
                                       solar_irradiance=solar, **kw)

    step.config, step.tables, step.solar = config, tables, solar
    return step, inputs


def inputs_from(inp, dtype, device, ncol=None):
    """A step's arguments (ARG_ORDER) from a RadiationInput
    (io/input.read_input), as tensors on ``device`` in ``dtype`` (the seeds
    int64), its columns tiled up or down to ncol when given."""

    def tile(x, dt=dtype):
        x = np.asarray(x)
        if ncol is not None:
            reps = (ncol + x.shape[0] - 1) // x.shape[0]
            x = np.concatenate([x] * reps, axis=0)[:ncol]
        return torch.as_tensor(x, device=device).to(dt)

    cloud = {
        "fraction": tile(inp.cloud_fraction),
        "q_liq": tile(inp.cloud_mixing_ratio[:, :, 0]),
        "q_ice": tile(inp.cloud_mixing_ratio[:, :, 1]),
        "re_liq": tile(inp.cloud_effective_radius[:, :, 0]),
        "re_ice": tile(inp.cloud_effective_radius[:, :, 1]),
        "overlap_param": tile(inp.overlap_param),
        "fractional_std": tile(inp.fractional_std),
        "iseed": tile(inp.iseed, torch.int64),
    }
    if inp.inv_cloud_effective_size is not None:
        # SPARTACUS 3D geometry inputs (separation-eta chain)
        cloud["inv_cloud_effective_size"] = tile(inp.inv_cloud_effective_size)
        if inp.inv_inhom_effective_size is not None:
            cloud["inv_inhom_effective_size"] = tile(
                inp.inv_inhom_effective_size)
    inputs = dict(
        pressure_hl=tile(inp.thermodynamics.pressure_hl),
        temperature_hl=tile(inp.thermodynamics.temperature_hl),
        gas_mmr=tile(inp.gas_mmr),
        cos_sza=tile(inp.cos_sza),
        skin_temperature=tile(inp.skin_temperature),
        sw_albedo=tile(inp.sw_albedo),
        sw_albedo_direct=tile(inp.sw_albedo_direct),
        lw_emissivity=tile(inp.lw_emissivity),
        cloud=cloud,
        aerosol={"mixing_ratio": tile(inp.aerosol_mmr)},
    )
    return tuple(inputs[k] for k in ARG_ORDER)
