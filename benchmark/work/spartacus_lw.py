"""The work of the SPARTACUS LW sweeps (``spartacus_lw_kernel`` in
``csrc/spartacus_lw.cu``): the up sweep of the regions' albedo matrices
and sources and the clear sky's, and the down sweep of the fluxes, of one
block, without multilayer 3D effects (the benchmark's configuration).

Counted from the shapes, whatever implements it; one launch per block.
* Float operations per (column, layer, g-point): 400, the 3x3 region
  adding of albedos and sources (matrix products, an LU factorisation
  and its solves), the overlap mixes and the clear-sky sweeps, done once.
* Bytes, those these inputs need: the 3x3 layer matrices R and T and the
  sources up and down of the three regions of every cloudy (column,
  layer, g-point), and in a clear layer region 0's ([0][0] and [0]), the
  cloudy share from the block's shape; the four clear-sky coefficients
  per (column, layer, g-point); per (column, layer) the three 3x3
  overlap matrices and two and two 0/1 masks; per (column, g-point) the
  surface albedo matrix, the three regions' surface emission, the
  surface albedo and emission; read once.  Written once: the regions'
  and the clear sky's upward flux at the top and four fluxes at every
  layer's base.
"""

KERNEL = "spartacus_lw_kernel"
OPS = 400
# entries of R, T, SU and SD read in a cloudy and a clear layer
CLOUDY_ENTRIES, CLEAR_ENTRIES = 9 + 9 + 3 + 3, 1 + 1 + 1 + 1


def block_launches(shape: dict) -> list:
    n, l, g = shape["ncol"], shape["nlev"], shape["ng_lw"]
    s, f = shape["itemsize"], shape["cloudy"]
    elements = n * l * g
    reads = ((CLOUDY_ENTRIES * f + CLEAR_ENTRIES * (1.0 - f) + 4) * elements
             + (3 * 9 + 2 + 2) * n * l + (9 + 3 + 1 + 1) * n * g)
    writes = (3 + 1 + 4 * l) * n * g
    return [dict(flops=OPS * elements, int_ops=0,
                 bytes=s * (reads + writes))]
