"""Column-blocked execution of the radiation scheme (port of
``ecrad_tpu/pipeline.py``: the cloud generator followed by
``interface.radiation``, per step or per column block).

The stochastic McICA sample is generated on the device inside the step
(threefry keyed per column via ``cloud["iseed"]``), so the result does
not depend on the blocking.
"""

from __future__ import annotations

import torch

from ecrad_torch.config import Config, Solver
from ecrad_torch.containers import Flux
from ecrad_torch.interface import Tables, radiation
from ecrad_torch.solvers.cloud_generator import cloud_generator_device

# Offset decorrelating the LW stochastic sample from the SW one (the
# reference draws SW and LW samples from one RNG stream sequentially,
# radiation_cloud_generator.F90:37+; with counter-based keys we offset)
LW_SEED_OFFSET = 997


def add_cloud_sample(config: Config, tables: Tables, cloud: dict) -> dict:
    """Attach the stochastic cloud sample (od_scaling (ncol, nlev, ng) +
    total_cloud_cover per band set) to the cloud dict."""
    if cloud is None or not config.do_clouds:
        return cloud
    pdf = tables.pdf_sampler
    out = dict(cloud)
    if config.do_sw and config.sw_solver == Solver.MCICA:
        out["od_scaling_sw"], out["total_cloud_cover_sw"] = \
            cloud_generator_device(
                config, pdf, cloud["iseed"], cloud["fraction"],
                cloud["overlap_param"], cloud["fractional_std"],
                config.n_g_sw)
    if config.do_lw and config.lw_solver == Solver.MCICA:
        out["od_scaling_lw"], out["total_cloud_cover_lw"] = \
            cloud_generator_device(
                config, pdf, cloud["iseed"] + LW_SEED_OFFSET,
                cloud["fraction"], cloud["overlap_param"],
                cloud["fractional_std"], config.n_g_lw)
    return out


def radiation_step(config: Config, tables: Tables, *, solar_irradiance,
                   cloud=None, aerosol=None, **inputs) -> Flux:
    """Cloud generator + radiation() — the full per-block step."""
    cloud_in = add_cloud_sample(config, tables, cloud)
    return radiation(config, tables, solar_irradiance=solar_irradiance,
                     cloud=cloud_in, aerosol=aerosol, **inputs)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _pad_columns(tree, ncol: int, target: int):
    """Pad the leading (column) axis to ``target`` by repeating the last
    column — physically valid values, results are sliced off after."""
    def pad(x):
        if not torch.is_tensor(x) or x.dim() == 0 or x.shape[0] != ncol:
            return x
        reps = x[-1:].expand((target - ncol,) + tuple(x.shape[1:]))
        return torch.cat([x, reps], dim=0)

    return _map(pad, tree)


def radiation_blocked(config: Config, tables: Tables, *, solar_irradiance,
                      block_size: int, cloud=None, aerosol=None,
                      **inputs) -> Flux:
    """NPROMA-style column blocking: radiation_step over column blocks in
    turn, bounding device temporaries to one block
    (driver/ecrad_driver.F90:339-384)."""
    ncol = inputs["pressure_hl"].shape[0]
    if block_size >= ncol:
        return radiation_step(config, tables,
                              solar_irradiance=solar_irradiance,
                              cloud=cloud, aerosol=aerosol, **inputs)
    nblocks = -(-ncol // block_size)
    tree = dict(inputs, cloud=cloud, aerosol=aerosol)
    tree = _pad_columns(tree, ncol, nblocks * block_size)
    fluxes = []
    for b in range(nblocks):
        sl = slice(b * block_size, (b + 1) * block_size)
        block = _map(lambda x: x[sl] if torch.is_tensor(x)
                     and x.dim() > 0 else x, tree)
        cl = block.pop("cloud")
        aer = block.pop("aerosol")
        fluxes.append(radiation_step(config, tables,
                                     solar_irradiance=solar_irradiance,
                                     cloud=cl, aerosol=aer, **block))
    return Flux(**{name: torch.cat([f.fields()[name] for f in fluxes],
                                   dim=0)[:ncol]
                   for name in fluxes[0].fields()})
