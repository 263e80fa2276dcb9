"""The SPARTACUS route: ecRad's 3D cloud solvers
(``solvers/spartacus_sw.py``, ``solvers/spartacus_lw.py``) in both band
sets, on the columns' cloud effective sizes (``inv_cloud_effective_size``
and ``inv_inhom_effective_size`` in ``cloud``, which the benchmark's inputs
derive from a configuration's ``driver`` group).  No McICA sample.

Each band set is solved in ecRad's SPARTACUS g order: RRTMG's g-points
sorted by roughly increasing gas optical depth
(radiation_ifs_rrtm.F90:117-134, ``RRTM_GPOINT_REORDERING_SW`` / ``_LW``
of ``optics/rrtmg_data.py``), so that the solvers' 3D exponential, taken
on the g-points before the first optically thick one (``use_expm``,
ecRad's ng3D), covers the thin part of the spectrum; other gas models
(ecCKD) keep their own order.  The g-resolved inputs and the band map are
taken in that order, and the solvers' per-g outputs (``*_g``) are put
back in the gas model's order for the surface, band and canopy sums.
"""

from __future__ import annotations

import torch

from benchmark.reference.config import Config, GasModel
from benchmark.reference.optics.rrtmg_data import (RRTM_GPOINT_REORDERING_LW,
                                                   RRTM_GPOINT_REORDERING_SW)
from benchmark.reference.solvers.spartacus_lw import solver_spartacus_lw
from benchmark.reference.solvers.spartacus_sw import solver_spartacus_sw

NEEDS_SAMPLE = False


def check_supported(config: Config):
    """Three regions, broadband flux output, the SW gases not
    delta-scaled."""
    if (config.nregions != 3 or config.do_save_spectral_flux
            or config.do_save_gpoint_flux
            or config.do_sw_delta_scaling_with_gases):
        raise NotImplementedError("the reference's SPARTACUS route takes "
                                  "three regions and broadband output, "
                                  "without delta scaling of the SW gases")


def g_order(gas_model, reordering, device):
    """A band set's SPARTACUS g order: the index of the gas model's
    g-point at each place (RRTMG's reordering), or None where the gas
    model's own order stands."""
    if gas_model != GasModel.RRTMG:
        return None
    return torch.as_tensor(reordering, dtype=torch.int64, device=device)


def take(x, order):
    """x with its last (g) axis in ``order``."""
    return x if order is None else x[..., order]


def restore(out, order):
    """The solvers' output with its per-g fields (``*_g``) back in the gas
    model's order."""
    if order is None:
        return out
    inverse = torch.argsort(order)
    return out._replace(**{
        f: getattr(out, f)[..., inverse] for f in out._fields
        if f.endswith("_g") and getattr(out, f) is not None})


def solve(config: Config, tables, op, cloud, cos_sza):
    """(LwFluxes, SwFluxes) of both band sets."""
    go, frac, cl = op["go"], op["frac"], op["cl"]
    geometry = (frac, cloud["fractional_std"], cloud["overlap_param"],
                cloud["inv_cloud_effective_size"],
                cloud.get("inv_inhom_effective_size"),
                op["pressure_hl"], op["temperature_hl"])
    lw_order = g_order(config.gas_model_lw, RRTM_GPOINT_REORDERING_LW,
                       tables.band_from_g_lw.device)
    sw_order = g_order(config.gas_model_sw, RRTM_GPOINT_REORDERING_SW,
                       tables.band_from_g_sw.device)
    lw_albedo_g = op["lw_albedo_g"]
    lw = solver_spartacus_lw(
        config, take(op["od_lw"], lw_order), take(op["ssa_lw"], lw_order),
        take(op["g_lw_arr"], lw_order), cl["od_lw"], cl["ssa_lw"],
        cl["g_lw"], take(tables.band_from_g_lw, lw_order), *geometry,
        take(go.planck_hl, lw_order),
        take(go.lw_emission * (1.0 - lw_albedo_g), lw_order),
        take(lw_albedo_g, lw_order))
    sw = solver_spartacus_sw(
        config, take(op["od_sw"], sw_order), take(op["ssa_sw"], sw_order),
        take(op["g_sw_arr"], sw_order), cl["od_sw"], cl["ssa_sw"],
        cl["g_sw"], take(tables.band_from_g_sw, sw_order), *geometry,
        take(go.incoming_sw, sw_order), cos_sza,
        take(op["sw_albedo_diffuse_g"], sw_order),
        take(op["sw_albedo_direct_g"], sw_order))
    return restore(lw, lw_order), restore(sw, sw_order)
