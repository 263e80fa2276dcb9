"""The work of the fused McICA SW kernel (``sw_fused_kernel`` in
``csrc/sw_fused.cu``): the clear-sky and total-sky two-stream
coefficients and adding sweeps of one block, without delta-Eddington
scaling of the gases (the benchmark's configurations leave it off).

Counted from the shapes, whatever implements it; one launch per block.
* Float operations per (column, layer, g-point): the clear Meador-Weaver
  coefficients 105 and the two scenes' sweeps 2 x 29, and per cloudy one
  the cloud merge and the coefficients again, 121.
* Bytes: the inputs once (gas optical depth, albedo and asymmetry and the
  cloud scaling per g-point, the band-wise cloud properties, a cloudy
  flag per layer, mu0, the incoming flux and the two surface albedos per
  g-point) and the outputs once (per scene three broadband profiles and
  three surface and TOA planes per g-point), and in the build for
  spectral flux output (``planes`` in the block's shape) its six per-g
  planes at every half-level, per scene the up, diffuse down and direct
  fluxes.
"""

KERNEL = "sw_fused_kernel"


def block_launches(shape: dict) -> list:
    n, l, g, b = (shape["ncol"], shape["nlev"], shape["ng_sw"],
                  shape["nband_sw"])
    s, f = shape["itemsize"], shape["cloudy"]
    reads = s * (4 * n * l * g + 3 * n * l * b + n + 3 * n * g) + n * l
    writes = s * 2 * (3 * n * l + 3 * n * g)
    if shape.get("planes"):
        writes += s * 6 * n * (l + 1) * g
    return [dict(flops=(163 + 121 * f) * n * l * g, int_ops=0,
                 bytes=reads + writes)]
