"""NPROMA-blocked IFS driver path (port of ``ecrad_tpu/ifs/blocking.py``).

Reference: driver/ifs_blocking.F90:16-589 + ecrad_ifs_driver_blocked.F90
— the IFS gathers every per-column input into one ``ZRGP(nproma,
nfields, ngpblks)`` super-array with computed field offsets
(ifs_config_type L24-37, ifs_setup_indices L55,
ifs_copy_inputs_to_blocked L275, nproma/ngpblks math L328-330), runs
the radiation scheme block by block, and scatters the fluxes back.

Host numpy, as in the JAX package: the super-array is ``(ngpblks,
nproma, nfld)`` (blocks leading so one block is a contiguous (nproma,
nfld) slab), the offset table is derived from the actual keyword arrays,
and the caller runs ``radiation_scheme`` on each block in turn (the
analog of the reference's OpenMP loop over ngpblks).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def ifs_setup_indices(kwargs: Dict[str, np.ndarray], ncol: int
                      ) -> List[Tuple[str, int, int, tuple]]:
    """Field offset table (reference ifs_config_type /
    ifs_setup_indices, driver/ifs_blocking.F90:24-37,55): for every
    per-column array argument, (name, offset, width, trailing_shape)."""
    table = []
    off = 0
    for name in sorted(kwargs):
        x = kwargs[name]
        if x is None or np.ndim(x) == 0 or np.shape(x)[0] != ncol:
            continue
        trail = tuple(np.shape(x)[1:])
        width = int(np.prod(trail)) if trail else 1
        table.append((name, off, width, trail))
        off += width
    return table


def copy_inputs_to_blocked(kwargs: Dict[str, np.ndarray], ncol: int,
                           nproma: int):
    """Pack per-column arguments into the blocked super-array
    (ifs_copy_inputs_to_blocked, driver/ifs_blocking.F90:275).

    Returns (zrgp (ngpblks, nproma, nfld), table, scalars) — the last
    block is padded by replicating the final column (dropped on
    unpack)."""
    table = ifs_setup_indices(kwargs, ncol)
    ngpblks = -(-ncol // nproma)            # L328-330 nproma/ngpblks math
    padded = ngpblks * nproma
    nfld = sum(w for _, _, w, _ in table)
    zrgp = np.zeros((padded, nfld))
    for name, off, width, _ in table:
        x = np.asarray(kwargs[name], np.float64).reshape(ncol, width)
        zrgp[:ncol, off:off + width] = x
        zrgp[ncol:, off:off + width] = x[-1:]
    scalars = {k: v for k, v in kwargs.items()
               if all(k != n for n, _, _, _ in table)}
    return zrgp.reshape(ngpblks, nproma, nfld), table, scalars


def block_kwargs(zrgp_block: np.ndarray, table, scalars, dtype=None):
    """Unpack one (nproma, nfld) block back into radiation_scheme
    keyword arrays."""
    out = dict(scalars)
    for name, off, width, trail in table:
        x = zrgp_block[:, off:off + width]
        x = x.reshape((zrgp_block.shape[0],) + trail) if trail \
            else x[:, 0]
        out[name] = x if dtype is None else np.asarray(x, dtype)
    return out


def copy_fluxes_from_blocked(block_outputs: List[Dict], ncol: int
                             ) -> Dict[str, np.ndarray]:
    """Concatenate per-block scheme outputs and drop padding columns
    (ifs_copy_fluxes_from_blocked, driver/ifs_blocking.F90:499)."""
    out = {}
    for key in block_outputs[0]:
        if key.startswith("_"):
            continue
        parts = [np.asarray(b[key]) for b in block_outputs]
        if parts[0].ndim == 0:
            out[key] = parts[0]
            continue
        out[key] = np.concatenate(parts, axis=0)[:ncol]
    return out
