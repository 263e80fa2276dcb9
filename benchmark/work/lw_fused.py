"""The work of the fused McICA LW kernel (``lw_fused_kernel`` in
``csrc/lw_fused.cu``): the clear-sky no-scattering sweeps, the total-sky
adding sweeps and the LW derivatives of one block.

Counted from the shapes, whatever implements it; one launch per block.
* Float operations per (column, layer, g-point): the clear layer 15, the
  sweeps 3 + 3 + 12 + 12, the derivatives 4, and per cloudy one the cloud
  merge and the two-stream coefficients, 54 (each add, multiply, divide,
  compare, select, exp and sqrt one operation).
* Bytes: the inputs once (gas optical depth and cloud scaling per
  g-point, the band-wise cloud optical depth, albedo and asymmetry, a
  cloudy flag per layer, the Planck function at half-levels, the surface
  emission and albedo) and the outputs once (four broadband profiles, six
  surface and TOA planes per g-point, two derivative profiles), and in
  the build for spectral flux output (``planes`` in the block's shape)
  its four per-g planes at every half-level, the clear and total-sky up
  and down fluxes.
"""

KERNEL = "lw_fused_kernel"


def block_launches(shape: dict) -> list:
    n, l, g, b = (shape["ncol"], shape["nlev"], shape["ng_lw"],
                  shape["nband_lw"])
    s, f = shape["itemsize"], shape["cloudy"]
    reads = s * (2 * n * l * g + 3 * n * l * b + n * (l + 1) * g
                 + 2 * n * g) + n * l
    writes = s * (4 * n * l + 6 * n * g + 2 * n * l)
    if shape.get("planes"):
        writes += s * 4 * n * (l + 1) * g
    return [dict(flops=(49 + 54 * f) * n * l * g, int_ops=0,
                 bytes=reads + writes)]
