"""Column parallelism over processes (port of ``ecrad_tpu/distributed.py``).

The reference's distributed layer is MPI-lite: rank 0 reads setup files
and broadcasts (utilities/easy_netcdf_read_mpi.F90:1-60,
ifsaux/mpl_module.F90:29-67); the compute itself is embarrassingly
parallel over columns.  Here:

* ``initialize()`` sets up ``torch.distributed`` from the standard
  environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) or from its
  arguments, and does nothing in a single-process run.
* The lookup tables are set up by every process (they are small and
  local: the reference's broadcast without a broadcast).
* Columns are split into one contiguous slab per rank (``column_slab``);
  each rank reads only its slab of the input file
  (``read_input_distributed``, through io/netcdf.NcFile's col_range), runs
  it on its own device (``global_mesh``: a card, or the CPU when the
  caller names it) and keeps only its slab of the fluxes
  (``local_flux``).  There is no collective in the hot path.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ecrad_torch.io.input import DriverConfig, read_input
from ecrad_torch.io.netcdf import NcFile
from ecrad_torch.pipeline import _map, _pad_columns


def _env_int(name):
    v = os.environ.get(name)
    return int(v) if v else None


def _card_per_rank(world_size: int) -> bool:
    """Whether every rank of this host has a card of its own."""
    return torch.cuda.is_available() and \
        torch.cuda.device_count() >= world_size


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> bool:
    """Initialise torch.distributed when a multi-process run is configured;
    returns True when running multi-process.

    Unset arguments come from the environment: WORLD_SIZE and RANK, and
    the rendezvous ``tcp://MASTER_ADDR:MASTER_PORT``.  A single-process
    run (no world size, or 1) returns False without touching
    torch.distributed.  The backend is NCCL when each rank has a card of
    its own (rank r uses cuda:r), gloo otherwise."""
    if world_size is None:
        world_size = _env_int("WORLD_SIZE")
    if rank is None:
        rank = _env_int("RANK")
    if world_size in (None, 1):
        return False
    if init_method is None:
        init_method = (f"tcp://{os.environ.get('MASTER_ADDR', 'localhost')}"
                       f":{os.environ['MASTER_PORT']}")
    backend = "nccl" if _card_per_rank(world_size) else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return dist.get_world_size() > 1


def _world() -> Tuple[int, int]:
    """(world size, rank), (1, 0) without torch.distributed."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def global_mesh() -> Tuple[torch.device, ...]:
    """One device per rank, in rank order: card r modulo the cards of the
    host (ranks share cards when there are fewer cards than ranks).  Rank
    r runs its slab on entry r.  Raises when no card is present: the CPU
    is reached only by naming it (make_global_inputs(..., device="cpu"))."""
    if not torch.cuda.is_available():
        raise RuntimeError("global_mesh: no CUDA device; name the device "
                           "(e.g. make_global_inputs(..., device='cpu'))")
    world, _ = _world()
    n = torch.cuda.device_count()
    return tuple(torch.device("cuda", r % n) for r in range(world))


def local_device() -> torch.device:
    """This rank's entry of global_mesh(); raises without a card."""
    return global_mesh()[_world()[1]]


def column_slab(ncol: int) -> Tuple[int, int, int]:
    """This rank's contiguous column slab (start, stop, ncol_padded):
    ncol is padded up to a multiple of the world size so that every rank
    owns an equal share; the padding columns (copies of the last column,
    make_global_inputs) are dropped after the run."""
    world, rank = _world()
    per = -(-ncol // world)
    start = rank * per
    return min(start, ncol), min(start + per, ncol), per * world


def read_input_distributed(path: str,
                           driver_config: Optional[DriverConfig] = None,
                           dtype=np.float64):
    """Each rank reads only its column slab of the input file.  Returns
    (inp, (start, stop, ncol)): a RadiationInput of the local columns and
    the slab of the ncol columns of the file."""
    with NcFile(path) as f:
        ncol = f.dimensions().get("column")
        if not ncol:  # record dims read as None in NetCDF3
            ncol = f.get("pressure_hl").shape[0]
    start, stop, _ = column_slab(ncol)
    inp = read_input(path, driver_config, dtype=dtype,
                     col_range=(start, stop))
    return inp, (start, stop, ncol)


def make_global_inputs(tree, ncol_local: int, ncol_global: int,
                       device=None):
    """The local slab (a tree of tensors, e.g. flagship.inputs_from's) as
    the rank's share of the padded global columns: every tensor whose
    leading axis is the ncol_local columns padded to the equal share by
    repeating its last column, on ``device`` (local_device() by default,
    which raises without a card).  Returns (tree, ncol_padded)."""
    device = local_device() if device is None else torch.device(device)
    world, _ = _world()
    per = -(-ncol_global // world)
    tree = _map(lambda x: x.to(device) if torch.is_tensor(x) else x, tree)
    return _pad_columns(tree, ncol_local, per), per * world


def local_flux(flux, start: int, stop: int) -> dict:
    """This rank's slab of a Flux (padding dropped) as numpy arrays, by
    field name."""
    return {k: v[:stop - start].cpu().numpy()
            for k, v in flux.fields().items()}
