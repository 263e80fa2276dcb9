"""Column-blocked and column-parallel execution of the radiation scheme
(port of ``ecrad_tpu/pipeline.py``: the cloud generator followed by
``interface.radiation``, per step, per column block, or per slab of
columns on each device of a mesh).

The stochastic McICA sample is generated on the device inside the step
(threefry keyed per column via ``cloud["iseed"]``), and every column is
computed on its own, so the result does not depend on the blocking or on
the number of devices.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ecrad_torch import profiling
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
    with profiling.scope("ecrad.generator"):
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
                   cloud=None, aerosol=None, spectral_solar_scaling=None,
                   **inputs) -> Flux:
    """Cloud generator + radiation() — the full per-block step.
    spectral_solar_scaling: the (n_bands_sw,) per-band solar scaling of
    use_spectral_solar_scaling, shared by all columns."""
    with profiling.scope("ecrad.step"):
        cloud_in = add_cloud_sample(config, tables, cloud)
        return radiation(config, tables, solar_irradiance=solar_irradiance,
                         cloud=cloud_in, aerosol=aerosol,
                         spectral_solar_scaling=spectral_solar_scaling,
                         **inputs)


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


def _column_blocks(tree, ncol: int, block_size: int) -> list:
    """The trees of the column blocks of ``tree`` (block_size columns
    each, the last padded by repeating the last column); ``[tree]`` when
    one block holds every column."""
    if block_size >= ncol:
        return [tree]
    nblocks = -(-ncol // block_size)
    padded = _pad_columns(tree, ncol, nblocks * block_size)
    return [_map(lambda x, b=b: x[b * block_size:(b + 1) * block_size]
                 if torch.is_tensor(x) and x.dim() > 0 else x, padded)
            for b in range(nblocks)]


def radiation_blocked(config: Config, tables: Tables, *, solar_irradiance,
                      block_size: int, cloud=None, aerosol=None,
                      spectral_solar_scaling=None, **inputs) -> Flux:
    """NPROMA-style column blocking: radiation_step over column blocks in
    turn, bounding device temporaries to one block
    (driver/ecrad_driver.F90:339-384).  spectral_solar_scaling has no
    column axis: every block gets all of it."""
    ncol = inputs["pressure_hl"].shape[0]
    with profiling.scope("ecrad.blocking"):
        blocks = _column_blocks(dict(inputs, cloud=cloud, aerosol=aerosol),
                                ncol, block_size)
    fluxes = [radiation_step(config, tables,
                             solar_irradiance=solar_irradiance,
                             spectral_solar_scaling=spectral_solar_scaling,
                             **block)
              for block in blocks]
    if len(fluxes) == 1:
        return fluxes[0]
    with profiling.scope("ecrad.blocking"):
        return Flux(**{name: torch.cat([f.fields()[name] for f in fluxes],
                                       dim=0)[:ncol]
                       for name in fluxes[0].fields()})


# --- column parallelism over devices ------------------------------------

def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Tuple[torch.device, ...]:
    """The devices columns are split over (the analogue of the JAX
    package's 1-D ``columns`` mesh): the given ``devices``, or every CUDA
    device, the first ``n_devices`` of them when given.  Raises when no
    card is present and no devices are named; a device may repeat (e.g.
    ``(torch.device("cpu"),) * 8``, or one card three times)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; name the devices "
                               "(e.g. devices=[torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if n_devices is not None:
        if not 1 <= n_devices <= len(mesh):
            raise ValueError(f"make_mesh: {n_devices} devices asked for, "
                             f"{len(mesh)} present")
        mesh = mesh[:n_devices]
    return mesh


def _to_device(x, device):
    """A tree of tensors (dicts, lists, tuples, NamedTuples) with every
    tensor moved to ``device``; other leaves unchanged."""
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to_device(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_device(v, device) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_device(v, device) for v in x)
    return x


def shard_inputs(mesh, tree, ncol: int):
    """The column slabs of ``tree`` for the devices of ``mesh``: every
    tensor whose leading axis is the ncol columns, padded to a multiple of
    the mesh size by repeating the last column, cut into len(mesh) equal
    contiguous slabs, slab i on mesh[i]; every other tensor copied to each
    device.  Returns a list of trees, one per device."""
    n = len(mesh)
    per = -(-ncol // n)
    padded = _pad_columns(tree, ncol, per * n)

    def slab(x, i):
        if not torch.is_tensor(x):
            return x
        if x.dim() > 0 and x.shape[0] == per * n:
            x = x[i * per:(i + 1) * per]
        return x.to(mesh[i])

    return [_map(lambda x, i=i: slab(x, i), padded) for i in range(n)]


def radiation_sharded(config: Config, tables: Tables, mesh, *,
                      solar_irradiance, block_size: Optional[int] = None,
                      cloud=None, aerosol=None, spectral_solar_scaling=None,
                      **inputs) -> Flux:
    """Column parallelism over the devices of ``mesh`` (make_mesh): the
    columns padded to a multiple of the mesh size and cut into contiguous
    slabs (shard_inputs), each slab run through radiation_step (or
    radiation_blocked with block_size) on its device with the tables moved
    there once per device, and the fluxes gathered on mesh[0] and cropped
    to the ncol columns.  Each slab is issued in turn from this thread;
    on distinct cards their kernels run asynchronously on each card.  Every
    column is computed on its own and the McICA sample is keyed per
    column, so the result equals radiation_blocked's over the same column
    blocks bit for bit (a slab of each device), and radiation_step's over
    all columns to the last bits of torch's CPU elementwise kernels, which
    round a tensor's vectorised body and its tail differently."""
    ncol = inputs["pressure_hl"].shape[0]
    slabs = shard_inputs(mesh, dict(inputs, cloud=cloud, aerosol=aerosol),
                         ncol)
    on_device = {}
    fluxes = []
    for device, slab in zip(mesh, slabs):
        if device not in on_device:
            on_device[device] = _to_device(tables, device)
        cl, aer = slab.pop("cloud"), slab.pop("aerosol")
        kw = dict(solar_irradiance=solar_irradiance, cloud=cl, aerosol=aer,
                  spectral_solar_scaling=_to_device(spectral_solar_scaling,
                                                    device), **slab)
        if block_size is None:
            fluxes.append(radiation_step(config, on_device[device], **kw))
        else:
            fluxes.append(radiation_blocked(config, on_device[device],
                                            block_size=block_size, **kw))
    home = mesh[0]
    return Flux(**{name: torch.cat([f.fields()[name].to(home)
                                    for f in fluxes], dim=0)[:ncol]
                   for name in fluxes[0].fields()})
