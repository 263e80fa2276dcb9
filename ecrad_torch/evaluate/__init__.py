"""ecRad's evaluation layer on the port's NetCDF reader (the reference's
``practical/`` compare and plot scripts; the JAX package's
``tools/compare_output.py`` and ``tools/plot_input.py``):

* ``python -m ecrad_torch.evaluate.compare_output out.nc ref.nc`` -
  tabulated differences, heating rates, ecRad's pass/fail thresholds and
  optional comparison figures;
* ``python -m ecrad_torch.evaluate.plot_input in.nc --out file.png`` -
  cross-sections or one column of an input file.

Host tools on files: numpy and scipy only, and matplotlib only for a
figure (imported when one is asked for).
"""

import numpy as np

from ecrad_torch.io.netcdf import NcFile


def column_coordinate(path, ncol):
    """(coordinate, label) of a figure's column axis: the latitude of the
    input file at path when it has one per column, else the column index
    (also when path is None)."""
    if path is not None:
        with NcFile(path) as f:
            if f.exists("latitude"):
                lat = f.get("latitude", np.float64)
                if lat.shape[0] == ncol:
                    return lat, "latitude [deg]"
    return np.arange(ncol), "column"


def pyplot():
    """matplotlib.pyplot on the Agg backend; raises a RuntimeError that
    says so when matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError(
            "a figure needs matplotlib, which is not installed; the "
            "tabulated and threshold modes run without it") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt
