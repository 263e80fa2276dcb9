"""Small debug utilities (port of ``ecrad_tpu/utils.py``).

print_matrix — the equivalent of the reference's debug matrix printer
(driver/print_matrix_mod.F90:1-75): pretty-print a matrix, a vector or
a batch of small matrices (e.g. SPARTACUS Gamma matrices per g-point)
with a label, in a fixed-width layout suitable for diffing.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def print_matrix(x, name: str = "matrix", file=None, fmt: str = "%12.5g",
                 max_batch: int = 4):
    """Print a (n, m) matrix, (n,) vector, or (batch, n, m) stack, given
    as a tensor (any device) or an array.

    Mirrors print_matrix_mod.F90's layout: one labelled block per
    matrix, rows on lines; batched inputs print the first
    ``max_batch`` slices with their batch index."""
    file = file or sys.stdout
    a = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    if a.ndim == 1:
        print(f"{name} ({a.shape[0]}):", file=file)
        print("  " + " ".join(fmt % v for v in a), file=file)
        return
    if a.ndim == 2:
        print(f"{name} ({a.shape[0]}x{a.shape[1]}):", file=file)
        for row in a:
            print("  " + " ".join(fmt % v for v in row), file=file)
        return
    lead = int(np.prod(a.shape[:-2]))
    flat = a.reshape(lead, a.shape[-2], a.shape[-1])
    for i in range(min(lead, max_batch)):
        print_matrix(flat[i], f"{name}[{i}]", file=file, fmt=fmt)
    if lead > max_batch:
        print(f"{name}: ... ({lead - max_batch} more slices)", file=file)
