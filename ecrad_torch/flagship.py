"""The flagship configuration as a ready-to-run step: RRTMG gas optics,
McICA SW and LW, IFS general aerosols with RH growth, SOCRATES liquid
and Fu ice, LW derivatives and canopy fluxes, absorption-only LW
aerosols (the CY49R1 operational setup), on the bundled 32-column,
137-level meridian slice tiled to any column count.  The named
configuration ``tripleclouds_rrtmg`` is the same with Tripleclouds SW
and LW solvers.

Mirrors ``__graft_entry__._build`` of the JAX package: the same Config
overrides, cloud-separation settings and tiling (for
``tripleclouds_rrtmg``, the overrides of ``tools/bench_matrix.py``
CONFIGS["tripleclouds_rrtmg"]).
"""

from __future__ import annotations

import numpy as np
import torch

from ecrad_torch import pipeline
from ecrad_torch.config import Config, IceModel, LiquidModel, Solver
from ecrad_torch.data import DATA_DIR, MERIDIAN_INPUT
from ecrad_torch.interface import setup_radiation
from ecrad_torch.io.input import DriverConfig, read_input

ARG_ORDER = ("pressure_hl", "temperature_hl", "gas_mmr", "cos_sza",
             "skin_temperature", "sw_albedo", "sw_albedo_direct",
             "lw_emissivity", "cloud", "aerosol")


# Named configurations: Config fields over the flagship's
CONFIGS = {
    "mcica_rrtmg": {},
    "tripleclouds_rrtmg": dict(sw_solver=Solver.TRIPLECLOUDS,
                               lw_solver=Solver.TRIPLECLOUDS),
}


def flagship_config(dtype_name: str,
                    config_name: str = "mcica_rrtmg") -> Config:
    """The Config of a named configuration before setup
    (__graft_entry__._build with that configuration's overrides)."""
    if config_name not in CONFIGS:
        raise ValueError(f"unknown configuration {config_name!r}; "
                         f"known: {sorted(CONFIGS)}")
    return Config(
        liquid_model=LiquidModel.SOCRATES, ice_model=IceModel.FU,
        # the CY49R1 operational namelist runs absorption-only LW
        # aerosols (test/ifs/configCY49R1.nam:45)
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
        use_general_cloud_optics=False,
        dtype_name=dtype_name, **CONFIGS[config_name])


def build(ncol=32, dtype=torch.float32, device="cpu", block_size=None,
          config_name="mcica_rrtmg"):
    """Build the step of a named configuration (CONFIGS) and its example
    inputs.

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
    dc = DriverConfig(cloud_separation_scale_toa=14000.0,
                      cloud_separation_scale_surface=2500.0,
                      cloud_separation_scale_power=3.5,
                      cloud_inhom_separation_factor=0.75)
    inp = read_input(MERIDIAN_INPUT, dc)

    def tile(x, dt=dtype):
        """Tile the 32-column meridian slice up/down to ncol columns."""
        x = np.asarray(x)
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
    return step, tuple(inputs[k] for k in ARG_ORDER)
