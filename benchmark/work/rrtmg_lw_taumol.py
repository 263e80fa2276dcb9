"""The work of the RRTMG LW gas optics kernel (``rrtmg_lw_taumol_kernel``
in ``csrc/rrtmg_gas.cu``): the 16 bands' taumol interpolation of one
block into the LW optical depth, the Planck function at half-levels and
the surface emission, per g-point.

Counted from the shapes, whatever implements it; one launch per block on
RRTMG gas optics.
* Float operations per (column, layer, g-point): a multiply-add per term
  of the band's formulation, ~16 on the meridian state (optical depth and
  Planck fraction), and the clamp and the Planck product, 35.
* Bytes: every field of the gas columns once (38 floats, 6 int64 indices
  and the bool troposphere flag per column and layer), the temperatures
  at half-levels and of the skin, the band set's packed tables once
  (``TABLE``, its length: every table, per-g vector and ratio the band
  functions read, fixed by RRTMG's data), and the outputs once.
"""

KERNEL = "rrtmg_lw_taumol_kernel"
FLOAT_FIELDS, INT64_FIELDS = 38, 6
TABLE = 145552
OPS = 35


def column_bytes(n: int, l: int, s: int) -> int:
    """The gas columns' fields of ``n`` columns of ``l`` layers."""
    return (s * FLOAT_FIELDS + 8 * INT64_FIELDS + 1) * n * l


def block_launches(shape: dict) -> list:
    n, l, g, s = (shape["ncol"], shape["nlev"], shape["ng_lw"],
                  shape["itemsize"])
    reads = column_bytes(n, l, s) + s * (n * (l + 1) + n + TABLE)
    writes = s * (n * l * g + n * (l + 1) * g + n * g)
    return [dict(flops=OPS * n * l * g, int_ops=0, bytes=reads + writes)]
