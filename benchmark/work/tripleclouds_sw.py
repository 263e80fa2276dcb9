"""The work of the fused Tripleclouds SW kernel (``tripleclouds_sw_kernel``
in ``csrc/tripleclouds_sw.cu``): the clear sky's and the three regions'
two-stream coefficients, the direct beam down, the up sweep of diffuse
and direct albedos and the down sweep of diffuse fluxes, the regions
mixed through the overlap matrices, of one block, without delta-Eddington
scaling of the gases (the benchmark's configurations leave it off).

Counted from the shapes, whatever implements it; one launch per block.
* Float operations per (column, layer, g-point), as ``chip_smoke.py``
  counts them: 157 in every layer (the clear Meador-Weaver coefficients
  105, the clear sky's and region 0's sweeps 2 x 26), and per cloudy one
  354 more (the two regions' cloud merge and coefficients 242, their
  sweeps 52, the mixes 60), each add, multiply, divide, compare, select,
  exp and sqrt one operation.
* Bytes: the inputs once (the gas optical depth, albedo and asymmetry per
  g-point, the band-wise cloud properties, the two cloudy regions' od
  scalings per layer, a clear flag per layer, the v overlap matrix at
  every interface, mu0, the incoming flux, the three regions' incoming
  beam, the clear sky's and the three regions' two surface albedos, the
  band of each g-point) and the outputs once (six broadband profiles, the
  clear sky's and the three regions' direct albedo at the top, four
  surface planes per g-point), and in the build for spectral flux output
  (``planes`` in the block's shape) its six per-g planes at every
  half-level.  The kernel's scratch (the albedos below each layer and the
  layer coefficients) is not counted: the work does not need it.
"""

KERNEL = "tripleclouds_sw_kernel"


def block_launches(shape: dict) -> list:
    n, l, g, b = (shape["ncol"], shape["nlev"], shape["ng_sw"],
                  shape["nband_sw"])
    s, f = shape["itemsize"], shape["cloudy"]
    reads = (s * (3 * n * l * g + 3 * n * l * b + 2 * n * l
                  + 9 * n * (l + 1) + n + 12 * n * g)
             + n * l + 4 * g)
    writes = s * (6 * n * l + 8 * n * g)
    if shape.get("planes"):
        writes += s * 6 * n * (l + 1) * g
    return [dict(flops=(157 + 354 * f) * n * l * g, int_ops=0,
                 bytes=reads + writes)]
