"""The work of the fused Tripleclouds LW kernel (``tripleclouds_lw_kernel``
in ``csrc/tripleclouds_lw.cu``): the clear-sky no-scattering sweeps, the
three regions' up sweep of albedos and sources and down sweep of fluxes,
mixed through the overlap matrices, and the region-coupled LW derivatives
of one block, with derivatives (the benchmark's configurations have them
on).

Counted from the shapes, whatever implements it; one launch per block.
* Float operations per (column, layer, g-point), as ``chip_smoke.py``
  counts them: 97 in every layer (the clear no-scattering coefficients
  15, the clear sweeps 6, region 0's up and down steps 24, the
  derivatives 4, the other two regions' steps 48), and per cloudy one
  174 more (the two regions' cloud merge and two-stream coefficients
  108, the up, down and derivative mixes 66), each add, multiply, divide,
  compare, select, exp and sqrt one operation.
* Bytes: the inputs once (the gas optical depth per g-point, the
  band-wise cloud optical depth, albedo and asymmetry, the two cloudy
  regions' od scalings and the three region fractions per layer, a clear
  flag per layer, the u and v overlap matrices at every interface, the
  Planck function at half-levels, the surface emission and albedo, the
  three regions' surface source, the band of each g-point) and the
  outputs once (four broadband profiles and the derivatives, five
  surface and TOA planes per g-point and the three regions' TOA source),
  and in the build for spectral flux output (``planes`` in the block's
  shape) its four per-g planes at every half-level.  The kernel's scratch
  (the albedos and sources below each layer) is not counted: the work
  does not need it.
"""

KERNEL = "tripleclouds_lw_kernel"


def block_launches(shape: dict) -> list:
    n, l, g, b = (shape["ncol"], shape["nlev"], shape["ng_lw"],
                  shape["nband_lw"])
    s, f = shape["itemsize"], shape["cloudy"]
    reads = (s * (n * l * g + 3 * n * l * b + 5 * n * l
                  + 2 * 9 * n * (l + 1) + n * (l + 1) * g + 5 * n * g)
             + n * l + 4 * g)
    writes = s * (5 * n * l + 8 * n * g)
    if shape.get("planes"):
        writes += s * 4 * n * (l + 1) * g
    return [dict(flops=(97 + 174 * f) * n * l * g, int_ops=0,
                 bytes=reads + writes)]
