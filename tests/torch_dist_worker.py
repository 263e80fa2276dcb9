"""One rank of a multi-process run of the port (ecrad_torch.distributed):
it joins the process group, reads only its column slab of the input
file, runs the flagship on it and saves its slab of the fluxes.

    python tests/torch_dist_worker.py RANK WORLD PORT INPUT OUTDIR DEVICE
        DTYPE BLOCK

DEVICE is "cpu" or "local" (the rank's entry of
distributed.global_mesh(), a card; it raises without one); DTYPE float32 or float64; BLOCK the column
block of radiation_blocked (0: one radiation_step).  Writes
OUTDIR/shard<RANK>.npz with the slab's start and stop and every Flux
field.  The CPU uses one thread, so that a one-process run with one thread
computes each slab in the same order.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from ecrad_torch import distributed, flagship, pipeline  # noqa: E402
from ecrad_torch.data import DATA_DIR  # noqa: E402
from ecrad_torch.interface import setup_radiation  # noqa: E402
from ecrad_torch.io.input import DriverConfig  # noqa: E402


def main(rank, world, port, path, outdir, device, dtype_name, block):
    torch.set_num_threads(1)
    assert distributed.initialize(init_method=f"tcp://localhost:{port}",
                                  world_size=world, rank=rank)
    device = (distributed.local_device() if device == "local"
              else torch.device(device))
    dtype = getattr(torch, dtype_name)
    # every rank sets the tables up itself (no broadcast)
    config, tables = setup_radiation(
        flagship.flagship_config(dtype_name), device, dtype,
        data_dir=DATA_DIR)
    inp, (start, stop, ncol) = distributed.read_input_distributed(
        path, DriverConfig(**flagship.DRIVER_SETTINGS))
    assert inp.ncol == stop - start
    tree = dict(zip(flagship.ARG_ORDER,
                    flagship.inputs_from(inp, dtype, device)))
    tree, _ = distributed.make_global_inputs(tree, stop - start, ncol,
                                             device)
    kw = dict(solar_irradiance=float(inp.solar_irradiance), **tree)
    flux = (pipeline.radiation_blocked(config, tables, block_size=block,
                                       **kw) if block
            else pipeline.radiation_step(config, tables, **kw))
    np.savez(os.path.join(outdir, f"shard{rank}.npz"), start=start,
             stop=stop, **distributed.local_flux(flux, start, stop))
    dist.destroy_process_group()
    print(f"rank {rank}: columns [{start}, {stop}) of {ncol}", flush=True)


if __name__ == "__main__":
    a = sys.argv[1:]
    main(int(a[0]), int(a[1]), a[2], a[3], a[4], a[5], a[6], int(a[7]))
