"""The work of the McICA generator's draw-and-scan kernel
(``generator_draw_scan_kernel`` in ``csrc/generator_scan.cu``): for each
column and g-point, the threefry draws of the JAX generator's sample and
the overlap scan down the levels, giving the CDF plane.

Counted from the shapes, whatever implements it.  Launches per block:
SW, then LW.
* Integer instructions, at the least: a Threefry-2x32 hash of 20 rounds
  takes 3 a round (an add, a rotate, an xor) and 7 key injections, 67; a
  uniform draw adds 3 for the mantissa, 70.  The work is 3 draws per
  (column, layer, g-point), the trigger's draw per (column, g-point) and
  the 4 key splits per column.
* Float operations: the scan's selections and compares, and the exact
  "- 1" of each of the three draws, 23 per (column, layer, g-point).
* Bytes: the seed and the total cloud cover of each column, four
  per-level fields (fraction, cumulative cover, pair cover, inhomogeneity
  overlap) read once, the CDF written once.
"""

KERNEL = "generator_draw_scan_kernel"
HASH_INSTR = 20 * 3 + 7
DRAW_INSTR = HASH_INSTR + 3


def one(ncol: int, nlev: int, ng: int, itemsize: int) -> dict:
    return dict(
        flops=23 * ncol * nlev * ng,
        int_ops=(ncol * ng * (nlev * 3 + 1) * DRAW_INSTR
                 + ncol * 4 * HASH_INSTR),
        bytes=itemsize * (2 * ncol + 4 * ncol * nlev + ncol * nlev * ng))


def block_launches(shape: dict) -> list:
    n, l, s = shape["ncol"], shape["nlev"], shape["itemsize"]
    return [one(n, l, shape["ng_sw"], s), one(n, l, shape["ng_lw"], s)]
