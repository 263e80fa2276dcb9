"""The work of the SPARTACUS SW sweeps (``spartacus_sw_kernel`` in
``csrc/spartacus_sw.cu``): the up sweep of the regions' diffuse and
direct albedo matrices with the Explicit entrapment and the clear sky's,
and the down sweep of the fluxes, of one block.

Counted from the shapes, whatever implements it; one launch per block.
* Float operations per (column, layer, g-point): 700, the 3x3 region
  adding (matrix products, an LU factorisation and its solves), the
  overlap and entrapment mixes and the clear-sky sweeps, done once.
* Bytes, those these inputs need: the five 3x3 layer matrices (R, T,
  Rdir, Tdiff, Tdir) of every cloudy (column, layer, g-point), and in a
  clear layer the entries the sweeps use there ([0][0] of each, and
  [1][0] and [2][0] of Tdir), the cloudy share from the block's shape;
  the five clear-sky coefficients per (column, layer, g-point); per
  (column, layer) the three 3x3 overlap matrices, four and two 0/1 masks
  and the thirteen entrapment scalars; per (column, g-point) the two
  surface albedo matrices, the two clear-sky albedos, the three regions'
  incoming beam and the incoming flux; read once.  Written once: the
  diffuse top albedo matrix, the clear-sky top albedos and six fluxes at
  every layer's base.
"""

KERNEL = "spartacus_sw_kernel"
OPS = 700
# entries of the five layer matrices read in a cloudy and a clear layer
CLOUDY_ENTRIES, CLEAR_ENTRIES = 5 * 9, 1 + 1 + 1 + 1 + 3


def block_launches(shape: dict) -> list:
    n, l, g = shape["ncol"], shape["nlev"], shape["ng_sw"]
    s, f = shape["itemsize"], shape["cloudy"]
    elements = n * l * g
    reads = ((CLOUDY_ENTRIES * f + CLEAR_ENTRIES * (1.0 - f) + 5) * elements
             + (3 * 9 + 4 + 2 + 13) * n * l + (2 * 9 + 2 + 3 + 1) * n * g)
    writes = (9 + 2 + 6 * l) * n * g
    return [dict(flops=OPS * elements, int_ops=0,
                 bytes=s * (reads + writes))]
