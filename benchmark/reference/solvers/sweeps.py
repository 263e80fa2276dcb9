"""The generic adding sweeps: CUDA kernel wrappers and their plain torch
versions.

Replaces ``ecrad_tpu/solvers/pallas_adding.py`` (``lw_noscat_sweeps``,
``scat_sweeps``, ``sw_sweeps``); the kernels are
``ecrad_torch/csrc/adding_sweeps.cu``, one launch per function.  Each
function returns the outputs of its TPU counterpart, by name, in the
port's layout: layer planes ``(ncol, nlev, ng)`` in, surface planes
``(ncol, ng)`` and per-level broadband sums ``(ncol, nlev)`` out.  The
level conventions are the TPU's: ``lw_noscat_sweeps`` sums the up flux at
half-levels 0..nlev-1 (TOA first; the surface is ``fup_surf``), the other
two sum both fluxes at half-levels 1..nlev (TOA is ``src_top``).  On
request (``planes=True``) the plain versions also return their per-g
fluxes at every half-level, ``(ncol, nlev+1, ng)``, TOA first: ``dn_g`` and
``up_g``, and for ``sw_sweeps_plain`` the direct flux ``dir_g`` (normal to
the beam, as ``dir_bb``) beside the diffuse ``dn_g``.  The kernels write
the same planes from their build with planes (the wrappers' ``planes=True``,
one launch as without); the broadband outputs do not change.  The fused
kernels' plain versions are built from these plain versions.
"""

from __future__ import annotations

import torch



def _stack(xs):
    return torch.stack(xs, dim=1)                       # (ncol, nlev)


def _planes(out, planes, **levels):
    """out, with each of ``levels`` (lists of the nlev + 1 half-levels'
    (ncol, ng) fluxes, kept only when planes is asked for) stacked into a
    (ncol, nlev+1, ng) plane."""
    if planes:
        out.update({k: _stack(v) for k, v in levels.items()})
    return out


def keeper(planes):
    """append(list, x) when planes is asked for, else a no-op: the per-g
    fluxes of every level are kept only for the planes."""
    return list.append if planes else (lambda lst, x: None)


def lw_noscat_sweeps_plain(trans, s_up, s_dn, emission, albedo,
                           planes=False):
    """The two affine LW sweeps without scattering
    (radiation_adding_ica_lw.F90:272-334) as torch loops over levels."""
    nlev = trans.shape[1]
    keep = keeper(planes)
    fdn = torch.zeros_like(emission)
    dn_bb, dn_g, up_g = [], [fdn], []
    for l in range(nlev):
        fdn = trans[:, l] * fdn + s_dn[:, l]
        dn_bb.append(fdn.sum(-1))
        keep(dn_g, fdn)
    fup_surf = emission + albedo * fdn
    fup = fup_surf
    up_bb = [None] * nlev
    keep(up_g, fup_surf)
    for l in range(nlev - 1, -1, -1):
        fup = trans[:, l] * fup + s_up[:, l]
        up_bb[l] = fup.sum(-1)
        keep(up_g, fup)
    up_g.reverse()
    return _planes(dict(dn_bb=_stack(dn_bb), fdn_surf=fdn,
                        up_bb=_stack(up_bb), fup_toa=fup, fup_surf=fup_surf),
                   planes, dn_g=dn_g, up_g=up_g)


def _moebius_up(refl, trans, s_up, s_dn, alb, src):
    """The up sweep of the adding method, surface -> TOA: the albedo and
    source of the atmosphere below each layer, and the source at TOA."""
    nlev = refl.shape[1]
    alb_below, src_below = [None] * nlev, [None] * nlev
    for l in range(nlev - 1, -1, -1):
        alb_below[l], src_below[l] = alb, src
        inv = 1.0 / (1.0 - alb * refl[:, l])
        alb, src = (refl[:, l] + trans[:, l] * trans[:, l] * alb * inv,
                    s_up(l) + trans[:, l] * (src + alb * s_dn(l)) * inv)
    return alb_below, src_below, src


def _affine_down(refl, trans, s_dn, alb_below, src_below, fdn, dn_g, up_g,
                 keep):
    """The down sweep of the adding method, TOA -> surface, with the
    per-level broadband down and up fluxes; keep(list, x) collects the per-g
    ones at half-levels 1..nlev into dn_g and up_g."""
    dn_bb, up_bb = [], []
    for l in range(refl.shape[1]):
        inv = 1.0 / (1.0 - alb_below[l] * refl[:, l])
        fdn = (trans[:, l] * fdn + refl[:, l] * src_below[l]
               + s_dn(l)) * inv
        fup = alb_below[l] * fdn + src_below[l]
        dn_bb.append(fdn.sum(-1))
        up_bb.append(fup.sum(-1))
        keep(dn_g, fdn)
        keep(up_g, fup)
    return _stack(dn_bb), _stack(up_bb), fdn


def scat_sweeps_plain(refl, trans, s_up, s_dn, alb0, src0, planes=False):
    """Moebius up sweep, then affine down sweep (the scattering adding
    method, radiation_adding_ica_lw.F90:32-134) as torch loops."""
    alb_below, src_below, src_top = _moebius_up(
        refl, trans, lambda l: s_up[:, l], lambda l: s_dn[:, l], alb0, src0)
    zero = torch.zeros_like(alb0)
    dn_g, up_g = [zero], [src_top]
    dn_bb, up_bb, fdn_surf = _affine_down(
        refl, trans, lambda l: s_dn[:, l], alb_below, src_below, zero, dn_g,
        up_g, keeper(planes))
    return _planes(dict(dn_bb=dn_bb, up_bb=up_bb, src_top=src_top,
                        fdn_surf=fdn_surf), planes, dn_g=dn_g, up_g=up_g)


def sw_sweeps_plain(refl, trans, rdir, tdd, tdirdir, incoming, alb0_dif,
                    alb0_dir_x_mu0, planes=False):
    """The three SW sweeps (radiation_adding_ica_sw.F90:24-153) as torch
    loops: direct beam down, Moebius up with the scattered direct beam as
    source, diffuse down.  tdd is the direct-to-diffuse transmittance;
    alb0_dir_x_mu0 the direct surface albedo times mu0."""
    nlev = refl.shape[1]
    fdir = incoming
    ftop, dir_bb = [], []
    for l in range(nlev):
        ftop.append(fdir)
        fdir = tdirdir[:, l] * fdir
        dir_bb.append(fdir.sum(-1))
    alb_below, src_below, src_top = _moebius_up(
        refl, trans, lambda l: rdir[:, l] * ftop[l],
        lambda l: tdd[:, l] * ftop[l], alb0_dif, alb0_dir_x_mu0 * fdir)
    zero = torch.zeros_like(incoming)
    dn_g, up_g = [zero], [src_top]
    dn_bb, up_bb, fdn_surf = _affine_down(
        refl, trans, lambda l: tdd[:, l] * ftop[l], alb_below, src_below,
        zero, dn_g, up_g, keeper(planes))
    return _planes(dict(dir_bb=_stack(dir_bb), dn_bb=dn_bb, up_bb=up_bb,
                        fdir_surf=fdir, fdn_surf=fdn_surf, src_top=src_top),
                   planes, dir_g=ftop + [fdir], dn_g=dn_g, up_g=up_g)
