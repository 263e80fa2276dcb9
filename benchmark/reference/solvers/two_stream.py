"""Two-stream layer coefficients (reference: radiation_two_stream.F90).

Elementwise over tensors shaped ``(..., nlev, ng)``; the dtype follows
the input.  Same formulas as ``ecrad_tpu/solvers/two_stream.py``; the
SW coefficients use ``expm1`` directly (the JAX package's cubic series
exists only because Pallas on the TPU lacks it).
"""

from __future__ import annotations

import torch

from benchmark.reference.constants import LW_DIFFUSIVITY


def _k_min(dtype):
    # Meador-Weaver Eq 18 guard: 1e-12 in dp, 1e-6 in sp
    return 1.0e-12 if dtype == torch.float64 else 1.0e-6


def delta_eddington(od, ssa, g):
    """Delta-Eddington scaling (radiation_delta_eddington.h:24-42).

    Returns scaled (od, ssa, g)."""
    f = g * g
    od_new = od * (1.0 - ssa * f)
    ssa_new = ssa * (1.0 - f) / (1.0 - ssa * f)
    g_new = g / (1.0 + g)
    return od_new, ssa_new, g_new


def lw_gammas(ssa, g):
    """LW two-stream gammas, Fu et al. (1997) Eqs 2.9-2.10
    (radiation_two_stream.F90:51-90)."""
    factor = (LW_DIFFUSIVITY * 0.5) * ssa
    gamma1 = LW_DIFFUSIVITY - factor * (1.0 + g)
    gamma2 = factor * (1.0 - g)
    return gamma1, gamma2


def sw_gammas(mu0, ssa, g):
    """SW Zdunkowski PIFM gammas (radiation_two_stream.F90:96-140); mu0
    broadcasts against ssa/g."""
    factor = 0.75 * g
    gamma1 = 2.0 - ssa * (1.25 + factor)
    gamma2 = ssa * (0.75 - factor)
    gamma3 = 0.5 - mu0 * factor
    return gamma1, gamma2, gamma3


def lw_ref_trans(od, ssa, g, planck_top, planck_bot):
    """LW diffuse reflectance/transmittance + linear-in-tau Planck sources
    (radiation_two_stream.F90:246-334 calc_ref_trans_lw).

    Returns (reflectance, transmittance, source_up, source_dn)."""
    gamma1, gamma2 = lw_gammas(ssa, g)
    k = torch.sqrt(torch.clamp((gamma1 - gamma2) * (gamma1 + gamma2),
                               min=_k_min(od.dtype)))
    # Guard od to keep the thin branch finite before select
    od_safe = torch.clamp(od, min=1.0e-30)
    exponential = torch.exp(-k * od_safe)
    exponential2 = exponential * exponential
    reftrans_factor = 1.0 / (k + gamma1 + (k - gamma1) * exponential2)
    ref_thick = gamma2 * (1.0 - exponential2) * reftrans_factor
    trans_thick = 2.0 * k * exponential * reftrans_factor

    # Stackhouse & Stephens (1991) Eqs 5 & 12: linear-in-tau emission
    coeff = (planck_bot - planck_top) / (od_safe * (gamma1 + gamma2))
    coeff_up_top = coeff + planck_top
    coeff_up_bot = coeff + planck_bot
    coeff_dn_top = -coeff + planck_top
    coeff_dn_bot = -coeff + planck_bot
    src_up_thick = (coeff_up_top - ref_thick * coeff_dn_top
                    - trans_thick * coeff_up_bot)
    src_dn_thick = (coeff_dn_bot - ref_thick * coeff_up_bot
                    - trans_thick * coeff_dn_top)

    # Thin limit (od <= 1e-3): linearized forms
    ref_thin = gamma2 * od
    trans_thin = (1.0 - k * od) / (1.0 + od * (gamma1 - k))
    src_thin = (1.0 - ref_thin - trans_thin) * 0.5 * (planck_top
                                                      + planck_bot)

    thick = od > 1.0e-3
    reflectance = torch.where(thick, ref_thick, ref_thin)
    transmittance = torch.where(thick, trans_thick, trans_thin)
    source_up = torch.where(thick, src_up_thick, src_thin)
    source_dn = torch.where(thick, src_dn_thick, src_thin)
    return reflectance, transmittance, source_up, source_dn


def lw_no_scattering_trans(od, planck_top, planck_bot):
    """LW no-scattering transmittance + sources
    (radiation_two_stream.F90:342-409 calc_no_scattering_transmittance_lw).

    Returns (transmittance, source_up, source_dn)."""
    coeff0 = LW_DIFFUSIVITY * od
    transmittance = torch.exp(-coeff0)
    coeff = (planck_bot - planck_top) / torch.clamp(coeff0, min=1.0e-30)
    src_up_thick = (coeff + planck_top) - transmittance * (coeff
                                                           + planck_bot)
    src_dn_thick = (-coeff + planck_bot) - transmittance * (-coeff
                                                            + planck_top)
    src_thin = coeff0 * 0.5 * (planck_top + planck_bot)
    thick = od > 1.0e-3
    source_up = torch.where(thick, src_up_thick, src_thin)
    source_dn = torch.where(thick, src_dn_thick, src_thin)
    return transmittance, source_up, source_dn


def sw_ref_trans(mu0, od, ssa, g):
    """SW Meador & Weaver (1980) reflectance/transmittance
    (radiation_two_stream.F90:563-775 calc_ref_trans_sw), in the
    regrouped form of ``ecrad_tpu/solvers/two_stream.sw_ref_trans``
    (k^2 from the PIFM identity; every bracket a sum of O(k) terms).

    mu0 broadcasts against od/ssa/g.  Returns (ref_diff, trans_diff,
    ref_dir, trans_dir_diff, trans_dir_dir); direct quantities are
    normalized to the flux in the beam cross-section."""
    eps = torch.finfo(od.dtype).eps

    trans_dir_dir = torch.exp(torch.clamp(-torch.clamp(od / mu0, min=0.0),
                                          min=-1000.0))

    factor = 0.75 * g
    gamma1 = 2.0 - ssa * (1.25 + factor)
    gamma2 = ssa * (0.75 - factor)
    gamma3 = 0.5 - mu0 * factor
    gamma4 = 1.0 - gamma3
    alpha1 = gamma1 * gamma4 + gamma2 * gamma3     # MW Eq. 16
    alpha2 = gamma1 * gamma3 + gamma2 * gamma4     # MW Eq. 17
    ksq = (2.0 * (1.0 - ssa)) * (2.0 - ssa * (0.5 + 1.5 * g))
    k = torch.sqrt(torch.clamp(ksq, min=1.0e-12))

    exponential = torch.exp(-k * od)
    exponential2 = exponential * exponential
    one_minus_exp2 = -torch.expm1(-2.0 * k * od)
    k_mu0 = k * mu0
    one_minus_kmu0_sqr = (1.0 - k_mu0) * (1.0 + k_mu0)
    k_2_exponential = 2.0 * k * exponential
    reftrans_factor = 1.0 / (k * (1.0 + exponential2)
                             + gamma1 * one_minus_exp2)

    # MW Eq. 25 / 26
    ref_diff = gamma2 * one_minus_exp2 * reftrans_factor
    trans_diff = torch.minimum(
        torch.clamp(k_2_exponential * reftrans_factor, min=0.0),
        1.0 - ref_diff)

    # Direct beam: singularity guard at k*mu0 == 1 as in the reference
    denom = torch.where(torch.abs(one_minus_kmu0_sqr) > eps,
                        one_minus_kmu0_sqr,
                        torch.full_like(one_minus_kmu0_sqr, eps))
    reftrans_dir = mu0 * ssa * reftrans_factor / denom

    ref_dir = reftrans_dir * (
        alpha2 * (one_minus_exp2 - k_mu0 * (1.0 + exponential2))
        + k * gamma3 * ((1.0 - k_mu0) + (1.0 + k_mu0) * exponential2)
        - k_2_exponential * (gamma3 - alpha2 * mu0) * trans_dir_dir)
    trans_dir_diff = reftrans_dir * (
        k_2_exponential * (gamma4 + alpha1 * mu0)
        - trans_dir_dir * (
            alpha1 * (one_minus_exp2 + k_mu0 * (1.0 + exponential2))
            + k * gamma4 * ((1.0 + k_mu0) + (1.0 - k_mu0)
                            * exponential2)))

    max_dir = mu0 * (1.0 - trans_dir_dir)
    ref_dir = torch.minimum(torch.clamp(ref_dir, min=0.0), max_dir)
    trans_dir_diff = torch.minimum(torch.clamp(trans_dir_diff, min=0.0),
                                   max_dir - ref_dir)
    return ref_diff, trans_diff, ref_dir, trans_dir_diff, trans_dir_dir


def sw_direct_trans(mu0, od):
    """Direct-beam transmittance only (cloudless fast path)."""
    return torch.exp(torch.clamp(-torch.clamp(od / mu0, min=0.0),
                                 min=-1000.0))
