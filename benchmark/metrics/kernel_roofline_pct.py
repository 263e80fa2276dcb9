"""The hand-written kernels' share of their roofline: over their launches
in the traced stretch, the sum of each launch's least time (its work,
counted from the cell's shapes by ``benchmark/work/<kernel>.py``, at the
H100's published peaks) over the sum of their device times.

A kernel's launches are matched to its work in launch order, block by
block (each block's shape, with its own cloudy share, in
``run.block_shapes``).  A kernel whose launch count is not its per-block
count times the traced blocks cannot be matched: the share is then not
read (and the kernel named on standard error), as it is where no known
kernel was launched.
"""

import sys

from benchmark import peaks


def read(run):
    if run.issue_rate is None:
        return None
    least = device = 0.0
    for kernel, work in run.work.items():
        launches = sorted((k for k in run.trace.kernels
                           if work.KERNEL in k[0]
                           and run.lo <= k[1] < run.hi),
                          key=lambda k: k[1])
        if not launches:
            continue
        works = [w for shape in run.block_shapes
                 for w in work.block_launches(shape)]
        if len(launches) != len(works):
            print(f"kernel_roofline_pct: {kernel}: {len(launches)} launches,"
                  f" its work counts {len(works)} over "
                  f"{len(run.block_shapes)} blocks; not read",
                  file=sys.stderr)
            return None
        for w, k in zip(works, launches):
            least += peaks.least_seconds(w, run.issue_rate)
            device += k[2] * 1e-6
    if device == 0.0:
        return None
    return 100.0 * least / device
