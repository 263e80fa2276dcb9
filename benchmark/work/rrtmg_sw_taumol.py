"""The work of the RRTMG SW gas optics kernel (``rrtmg_sw_taumol_kernel``
in ``csrc/rrtmg_gas.cu``): the 14 bands' taumol interpolation of one
block into the SW optical depth and single-scattering albedo per g-point,
and the solar source per column.

Counted from the shapes, whatever implements it; one launch per block on
RRTMG gas optics.
* Float operations per (column, layer, g-point): a multiply-add per term
  of the band's formulation, ~10 on the meridian state (optical depth and
  Rayleigh), and the clamp and the albedo's division, 23.
* Bytes: every field of the gas columns once (as the LW kernel's), the
  band set's packed tables once (``TABLE``, its length, fixed by RRTMG's
  data), and the outputs once.
"""

from benchmark.work.rrtmg_lw_taumol import column_bytes

KERNEL = "rrtmg_sw_taumol_kernel"
TABLE = 87469
OPS = 23


def block_launches(shape: dict) -> list:
    n, l, g, s = (shape["ncol"], shape["nlev"], shape["ng_sw"],
                  shape["itemsize"])
    reads = column_bytes(n, l, s) + s * TABLE
    writes = s * (2 * n * l * g + n * g)
    return [dict(flops=OPS * n * l * g, int_ops=0, bytes=reads + writes)]
