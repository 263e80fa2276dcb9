"""The SPARTACUS adding sweeps and layer matrices: CUDA kernel wrappers and
their plain torch versions.

The sweeps replace ``ecrad_tpu/solvers/pallas_spartacus.py``
(``sw_sweeps``, ``lw_sweeps``, two ``pallas_call``s each); the kernels are
``ecrad_torch/csrc/spartacus_sw.cu`` and ``spartacus_lw.cu``, one launch
per function.  The layer matrices (``sw_layer_mats``, ``lw_layer_mats``)
replace no TPU kernel (XLA builds them there); their kernels are
``ecrad_torch/csrc/spartacus_layer_mats.cu``, a build pass and a refine
pass per call from the band set's raw optics, which also write the
clear-sky planes the sweeps read, and their plain versions
``spartacus._sw_layer_mats`` and ``_lw_layer_mats``.  The sweeps'
arguments and results are those of the TPU functions, in their layout:
layer matrices ``(nlev, 9, ncol, ng)`` (k = 3*i + j) or
``(nlev, 3, ncol, ng)``, clear-sky planes ``(nlev, ncol, ng)``, per-column
data ``(nlev, ncol, K)`` (interface matrices, 0/1 masks, the 13
entrapment scalars), surface planes ``(9|3, ncol, ng)`` and ``(ncol, ng)``.

The plain versions loop over levels and call the step cores of
``solvers/spartacus.py``, as the JAX package's ``lax.scan`` path does;
the kernels do the same arithmetic per (column, g-point) thread.
"""

from __future__ import annotations

import torch

from ecrad_torch import kernels
from ecrad_torch.solvers import spartacus as sp

NREG = 3
# g-points the SW kernel takes: one thread each, in blocks of at most 128
# threads (csrc/spartacus_sw.cu kMaxThreads; RRTMG's SW has 112)
SW_MAX_G = 128
# values the LW up sweep hands the down sweep per (column, level, g-point)
# (csrc/spartacus_lw.cu kHand)
LW_HAND = 14


def _b(x):
    """(ncol, K) per-column values -> (K, ncol, 1), broadcast-ready."""
    return x.T[..., None]


def _sw_mats(mats, l):
    return tuple(sp._m3(x[l]) for x in mats)


def _sw_up_plain(opts, mats, cl5, u9c, v9top, msk_up, ent13, alb0, albd0,
                 albc0, albdc0):
    """The SW up sweep as a torch loop over levels.  Returns the final
    carry and, per level, the entry carry (alb (3, 3, ncol, ng), albd,
    alb_c, albd_c): the albedos of the atmosphere below each layer."""
    nlev, _, ncol, ng = mats[0].shape
    zero3 = alb0.new_zeros((NREG, ncol, ng))
    carry = (sp._m3(alb0), sp._m3(albd0), albc0, albdc0, zero3, zero3)
    below = [None] * nlev
    for l in range(nlev - 1, -1, -1):
        below[l] = carry[:4]
        m = msk_up[l] != 0.0
        e = ent13[l]
        ent = (_b(e[:, 0:3]), _b(e[:, 3:6]), _b(e[:, 6:9]), e[:, 9, None],
               e[:, 10, None], e[:, 11, None], e[:, 12, None])
        carry = sp._sw_up_core(
            carry, _sw_mats(mats, l), tuple(c[l] for c in cl5), _b(u9c[l]),
            _b(v9top[l]), tuple(m[:, k, None] for k in range(4)), ent, opts)
    return carry, below


def _sw_dn_plain(mats, cl5, below, v9bot, msk_dn, ddn0, incoming):
    """The SW down sweep as a torch loop over levels, from the up sweep's
    entry carries.  Returns (fup, fdn, fdir, fup_c, fdn_c, fdir_c), each
    (nlev, ncol, ng)."""
    nlev, _, ncol, ng = mats[0].shape
    state = (ddn0.new_zeros((NREG, ncol, ng)), ddn0,
             torch.zeros_like(incoming), incoming)
    ys = []
    for l in range(nlev):
        m = msk_dn[l] != 0.0
        state, y = sp._sw_dn_core(
            state, _sw_mats(mats, l), tuple(c[l] for c in cl5), below[l],
            _b(v9bot[l]), (m[:, 0, None], m[:, 1, None]))
        ys.append(y)
    return tuple(torch.stack(x) for x in zip(*ys))


def sw_sweeps_plain(opts, Rs, Ts, Rds, Tdds, Tdirs, cl5, u9c, v9top, v9bot,
                    msk_up, msk_dn, ent13, alb0, albd0, albc0, albdc0, ddn0,
                    incoming):
    """Both SW sweeps as torch loops over levels.  Returns (albd_f (9,
    ncol, ng), alb_c_f, albd_c_f, (fup, fdn, fdir, fup_c, fdn_c, fdir_c)
    each (nlev, ncol, ng))."""
    mats = (Rs, Ts, Rds, Tdds, Tdirs)
    carry, below = _sw_up_plain(opts, mats, cl5, u9c, v9top, msk_up, ent13,
                                alb0, albd0, albc0, albdc0)
    albd_f, alb_c_f, albd_c_f = carry[1:4]
    dn = _sw_dn_plain(mats, cl5, below, v9bot, msk_dn, ddn0, incoming)
    return albd_f.reshape(NREG * NREG, *albd_f.shape[2:]), alb_c_f, \
        albd_c_f, dn


# The entries k = 3*i + j of R, T, Rd, Tdd and Tdir that the SW kernel
# reads in a clear layer (csrc/spartacus_sw.cu says why these): [0][0],
# and for Tdir also [1][0] and [2][0], which multiply the region-0 beam.
SW_CLEAR_ENTRIES = ((0,), (0,), (0,), (0,), (0, 3, 6))


def _needed_bytes(mats, clear_entries, msk_dn, others, n_out_planes):
    """The bytes a sweep kernel must move: each of the tensors ``others``
    read once, ``n_out_planes`` (ncol, ng) planes written once, and the
    stacked layer matrices ``mats`` (nlev, K, ncol, ng) read once, where
    in clear layers (msk_dn[..., 0]) only their entries clear_entries."""
    nlev, _, ncol, ng = mats[0].shape
    item = mats[0].element_size()
    n_all = nlev * ncol * ng
    n_clear = int((msk_dn[..., 0] != 0.0).sum()) * ng
    read = sum(m.shape[1] * (n_all - n_clear) + len(k) * n_clear
               for m, k in zip(mats, clear_entries)) * item
    read += sum(t.numel() * t.element_size() for t in others)
    return read + n_out_planes * ncol * ng * item


def sw_needed_bytes(opts, Rs, Ts, Rds, Tdds, Tdirs, cl5, u9c, v9top, v9bot,
                    msk_up, msk_dn, ent13, alb0, albd0, albc0, albdc0, ddn0,
                    incoming):
    """The bytes the SW sweeps must move on these inputs: each input read
    once and each output written once, where the five layer matrices count
    in clear layers (msk_dn[..., 0]) only the entries SW_CLEAR_ENTRIES."""
    nlev = Rs.shape[0]
    return _needed_bytes(
        (Rs, Ts, Rds, Tdds, Tdirs), SW_CLEAR_ENTRIES, msk_dn,
        (*cl5, u9c, v9top, v9bot, msk_up, msk_dn, ent13, alb0, albd0,
         albc0, albdc0, ddn0, incoming), 9 + 2 + 6 * nlev)


# The entries of R, T (k = 3*i + j) and of SU, SD that the LW kernel reads
# in a clear layer (csrc/spartacus_lw.cu says why these): [0][0] and [0].
LW_CLEAR_ENTRIES = ((0,), (0,), (0,), (0,))


def lw_needed_bytes(opts, Rs, Ts, SUs, SDs, cl4, u9c, v9top, v9bot, msk_up,
                    msk_dn, alb0, src0, albc0, srcc0):
    """The bytes the LW sweeps must move on these inputs: each input read
    once and each output written once, where the four layer matrices count
    in clear layers (msk_dn[..., 0]) only the entries LW_CLEAR_ENTRIES."""
    nlev = Rs.shape[0]
    return _needed_bytes(
        (Rs, Ts, SUs, SDs), LW_CLEAR_ENTRIES, msk_dn,
        (*cl4, u9c, v9top, v9bot, msk_up, msk_dn, alb0, src0, albc0,
         srcc0), NREG + 1 + 4 * nlev)


def lw_sweeps_plain(opts, Rs, Ts, SUs, SDs, cl4, u9c, v9top, v9bot, msk_up,
                    msk_dn, alb0, src0, albc0, srcc0):
    """Both LW sweeps as torch loops over levels.  Returns (src_f (3,
    ncol, ng), src_c_f (ncol, ng), (fup, fdn, fup_c, fdn_c) each (nlev,
    ncol, ng))."""
    nlev, _, ncol, ng = Rs.shape

    def lmats(l):
        return sp._m3(Rs[l]), sp._m3(Ts[l]), SUs[l], SDs[l]

    carry = (sp._m3(alb0), src0, albc0, srcc0)
    below = [None] * nlev
    for l in range(nlev - 1, -1, -1):
        alb, src, alb_c, src_c = carry
        below[l] = (src, alb, src_c, alb_c)
        m = msk_up[l] != 0.0
        carry = sp._lw_up_core(
            carry, lmats(l), tuple(c[l] for c in cl4), _b(u9c[l]),
            _b(v9top[l]), (m[:, 0, None], m[:, 1, None]), opts)
    src_f, src_c_f = carry[1], carry[3]

    state = (src0.new_zeros((NREG, ncol, ng)), torch.zeros_like(srcc0))
    ys = []
    for l in range(nlev):
        m = msk_dn[l] != 0.0
        state, y = sp._lw_dn_core(
            state, lmats(l), tuple(c[l] for c in cl4), below[l],
            _b(v9bot[l]), (m[:, 0, None], m[:, 1, None]))
        ys.append(y)
    return src_f, src_c_f, tuple(torch.stack(x) for x in zip(*ys))


def _launch(fn_name, ref, tensors, *params):
    """Launch ``ecrad_<fn_name>_{f32,f64}`` on the tensors' pointers and
    the params, on ref's device and stream."""
    lib = kernels.library()
    fn = getattr(lib, f"ecrad_{fn_name}_"
                 + ("f32" if ref.dtype == torch.float32 else "f64"))
    with torch.cuda.device(ref.device):
        code = fn(kernels.pointer_array(tensors), *params,
                  kernels.stream_of(ref))
    kernels.check(code, fn_name)


def sw_sweeps(opts, Rs, Ts, Rds, Tdds, Tdirs, cl5, u9c, v9top, v9bot,
              msk_up, msk_dn, ent13, alb0, albd0, albc0, albdc0, ddn0,
              incoming):
    """Both SPARTACUS SW sweeps.  CPU tensors run sw_sweeps_plain; CUDA
    tensors launch the kernel (csrc/spartacus_sw.cu) or raise."""
    if Rs.device.type == "cpu":
        return sw_sweeps_plain(opts, Rs, Ts, Rds, Tdds, Tdirs, cl5, u9c,
                               v9top, v9bot, msk_up, msk_dn, ent13, alb0,
                               albd0, albc0, albdc0, ddn0, incoming)
    nlev, _, ncol, ng = Rs.shape
    mat, lev, sfc = (nlev, 9, ncol, ng), (nlev, ncol, ng), (ncol, ng)
    specs = {f"mats[{i}]": (t, mat)
             for i, t in enumerate((Rs, Ts, Rds, Tdds, Tdirs))}
    specs.update({f"cl5[{i}]": (t, lev) for i, t in enumerate(cl5)})
    specs.update(
        u9c=(u9c, (nlev, ncol, 9)), v9top=(v9top, (nlev, ncol, 9)),
        v9bot=(v9bot, (nlev, ncol, 9)), msk_up=(msk_up, (nlev, ncol, 4)),
        msk_dn=(msk_dn, (nlev, ncol, 2)), ent13=(ent13, (nlev, ncol, 13)),
        alb0=(alb0, (9, ncol, ng)), albd0=(albd0, (9, ncol, ng)),
        albc0=(albc0, sfc), albdc0=(albdc0, sfc),
        ddn0=(ddn0, (NREG, ncol, ng)), incoming=(incoming, sfc))
    kernels.check_inputs("spartacus sw_sweeps", Rs, specs)
    if ng > SW_MAX_G:
        raise ValueError(f"spartacus sw_sweeps: the kernel takes at most "
                         f"{SW_MAX_G} g-points, got {ng}")
    e = lambda *shape: Rs.new_empty(shape)  # noqa: E731
    albd_f, alb_c_f, albd_c_f = e(9, ncol, ng), e(*sfc), e(*sfc)
    dn = tuple(e(*lev) for _ in range(6))
    if ncol == 0:
        return albd_f, alb_c_f, albd_c_f, dn
    # the entry carry of the up sweep at each level: the diffuse and
    # direct albedos below each layer, regions and clear sky
    scratch = (e(*mat), e(*mat), e(*lev), e(*lev))
    _launch("spartacus_sw", Rs,
            (Rs, Ts, Rds, Tdds, Tdirs, *cl5, u9c, v9top, v9bot, msk_up,
             msk_dn, ent13, alb0, albd0, albc0, albdc0, ddn0, incoming,
             albd_f, alb_c_f, albd_c_f, *dn, *scratch),
            ncol, nlev, ng, int(opts.mode), int(bool(opts.do_3d)),
            float(opts.overhang_factor),
            float(opts.cloud_fraction_threshold), float(opts.max_cloud_od))
    sw_sweeps.launches += 1
    return albd_f, alb_c_f, albd_c_f, dn


sw_sweeps.launches = 0


def lw_sweeps(opts, Rs, Ts, SUs, SDs, cl4, u9c, v9top, v9bot, msk_up,
              msk_dn, alb0, src0, albc0, srcc0):
    """Both SPARTACUS LW sweeps.  CPU tensors run lw_sweeps_plain; CUDA
    tensors launch the kernel (csrc/spartacus_lw.cu) or raise."""
    if Rs.device.type == "cpu":
        return lw_sweeps_plain(opts, Rs, Ts, SUs, SDs, cl4, u9c, v9top,
                               v9bot, msk_up, msk_dn, alb0, src0, albc0,
                               srcc0)
    nlev, _, ncol, ng = Rs.shape
    lev, sfc = (nlev, ncol, ng), (ncol, ng)
    specs = {"Rs": (Rs, (nlev, 9, ncol, ng)), "Ts": (Ts, (nlev, 9, ncol, ng)),
             "SUs": (SUs, (nlev, NREG, ncol, ng)),
             "SDs": (SDs, (nlev, NREG, ncol, ng))}
    specs.update({f"cl4[{i}]": (t, lev) for i, t in enumerate(cl4)})
    specs.update(
        u9c=(u9c, (nlev, ncol, 9)), v9top=(v9top, (nlev, ncol, 9)),
        v9bot=(v9bot, (nlev, ncol, 9)), msk_up=(msk_up, (nlev, ncol, 2)),
        msk_dn=(msk_dn, (nlev, ncol, 2)), alb0=(alb0, (9, ncol, ng)),
        src0=(src0, (NREG, ncol, ng)), albc0=(albc0, sfc),
        srcc0=(srcc0, sfc))
    kernels.check_inputs("spartacus lw_sweeps", Rs, specs)
    e = lambda *shape: Rs.new_empty(shape)  # noqa: E731
    src_f, src_c_f = e(NREG, ncol, ng), e(*sfc)
    dn = tuple(e(*lev) for _ in range(4))
    if ncol == 0:
        return src_f, src_c_f, dn
    # the entry carry of the up sweep at each level: the albedo and source
    # of the atmosphere below each layer, regions and clear sky
    scratch = e(ncol, nlev, LW_HAND, ng)
    _launch("spartacus_lw", Rs,
            (Rs, Ts, SUs, SDs, *cl4, u9c, v9top, v9bot, msk_up, msk_dn,
             alb0, src0, albc0, srcc0, src_f, src_c_f, *dn, scratch),
            ncol, nlev, ng, int(bool(opts.multilayer)))
    lw_sweeps.launches += 1
    return src_f, src_c_f, dn


lw_sweeps.launches = 0


def _check_masks(name, ref, specs):
    """Raise unless each specs entry {arg: (tensor, shape)} is a contiguous
    bool tensor of that shape on ref's device."""
    for arg, (t, shape) in specs.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != ref.device or t.dtype != torch.bool:
            raise ValueError(f"{name}: {arg} must be bool on {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")


def _elements(name, od):
    """(ncol, nlev, ng) of the gas od; raise on another rank or on more
    elements than an int32 index takes."""
    if od.dim() != 3:
        raise ValueError(f"{name}: od has shape {tuple(od.shape)}, "
                         f"expected (ncol, nlev, ng)")
    ncol, nlev, ng = od.shape
    if ncol * nlev * ng >= 2**31:
        raise ValueError(f"{name}: {ncol * nlev * ng} elements exceed an "
                         f"int32 index")
    return ncol, nlev, ng


def _optics_specs(name, od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b,
                  band_from_g, od_scaling):
    """The kernels' checks of a band set's raw optics (the first eight
    arguments of both wrappers): check_inputs' specs of the float tensors,
    and the number of bands; raise on ssa without g or the reverse, and on
    a band map that is not int32 (ng,) on od's device."""
    ncol, nlev, ng = od.shape
    if (ssa is None) != (g is None):
        raise ValueError(f"{name}: ssa and g are both given or both None")
    if od_cloud_b.dim() != 3:
        raise ValueError(f"{name}: od_cloud_b has shape "
                         f"{tuple(od_cloud_b.shape)}, expected (ncol, nlev, "
                         f"nband)")
    nband = od_cloud_b.shape[-1]
    if tuple(band_from_g.shape) != (ng,) or band_from_g.dtype != torch.int32 \
            or band_from_g.device != od.device \
            or not band_from_g.is_contiguous():
        raise ValueError(f"{name}: band_from_g must be contiguous int32 of "
                         f"shape ({ng},) on {od.device}")
    lev, band = (ncol, nlev, ng), (ncol, nlev, nband)
    specs = dict(od=(od, lev), od_cloud_b=(od_cloud_b, band),
                 ssa_cloud_b=(ssa_cloud_b, band), g_cloud_b=(g_cloud_b, band),
                 od_scaling=(od_scaling, (ncol, nlev, NREG - 1)))
    if ssa is not None:
        specs.update(ssa=(ssa, lev), g=(g, lev))
    return specs, nband


def _refine_list(wrapper, ref, n, refine):
    """The refine pass's scratch and counter: the refined elements' indices
    (n int32 at most), their count, zeroed, and the wrapper's running total
    of refined elements, to which the refine pass adds the count on the
    card; Nones without a refinement."""
    if not refine:
        return None, None, None
    return (torch.empty(n, dtype=torch.int32, device=ref.device),
            torch.zeros(1, dtype=torch.int32, device=ref.device),
            _refined_total(wrapper, ref.device))


def _refined_total(wrapper, device):
    """wrapper.refined as a one-element int64 tensor on device, filled
    there (no copy from the host) where it is still an int, as after a
    reset."""
    total = wrapper.refined
    if not (torch.is_tensor(total) and total.device == device):
        total = torch.full((1,), int(total), dtype=torch.int64,
                           device=device)
        wrapper.refined = total
    return total


def _count_plain(wrapper, use_expm, any_expm):
    """The plain build's count of refined elements, on wrapper.refined."""
    if any_expm:
        wrapper.refined = wrapper.refined + int(use_expm.sum())


def sw_layer_mats(od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b,
                  band_from_g, od_scaling, max_cloud_od, mu0, tr_diff, tr_dir,
                  use_expm, clear_layer, any_expm):
    """The SPARTACUS SW region matrices (R, T, Rd, Tdd, Tdir), each (nlev,
    9, ncol, ng), and the clear-sky planes cl5 (five (nlev, ncol, ng):
    sw_ref_trans of the gas) of spartacus._sw_layer_mats's arguments, the
    band set's raw optics: returns (R, T, Rd, Tdd, Tdir, cl5).  CPU tensors
    run that plain version; CUDA tensors launch the kernels
    (csrc/spartacus_layer_mats.cu: the region optics, the two-stream build
    and the clear-sky planes, then, when any_expm, the refinement of the
    use_expm elements) or raise.  band_from_g is int32.  Counts its launch
    sets in .launches and the elements it refines in .refined (an int, or
    on the card a one-element tensor; reset both to 0)."""
    if od.device.type == "cpu":
        out = sp._sw_layer_mats(od, ssa, g, od_cloud_b, ssa_cloud_b,
                                g_cloud_b, band_from_g, od_scaling,
                                max_cloud_od, mu0, tr_diff, tr_dir, use_expm,
                                clear_layer, any_expm)
        _count_plain(sw_layer_mats, use_expm, any_expm)
        return out
    return _sw_layer_mats_kernel(od, ssa, g, od_cloud_b, ssa_cloud_b,
                                 g_cloud_b, band_from_g, od_scaling,
                                 max_cloud_od, mu0, tr_diff, tr_dir,
                                 use_expm, clear_layer, any_expm)


def _sw_layer_mats_kernel(od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b,
                          band_from_g, od_scaling, max_cloud_od, mu0,
                          tr_diff, tr_dir, use_expm, clear_layer, any_expm):
    """sw_layer_mats off the CPU: checks, outputs, scratch, the launch
    set and its counts."""
    name = "spartacus sw_layer_mats"
    ncol, nlev, ng = _elements(name, od)
    if ssa is None:
        raise ValueError(f"{name}: ssa and g are required")
    _check_masks(name, od, dict(use_expm=(use_expm, (ncol, nlev, ng)),
                                clear_layer=(clear_layer, (ncol, nlev))))
    specs, nband = _optics_specs(name, od, ssa, g, od_cloud_b, ssa_cloud_b,
                                 g_cloud_b, band_from_g, od_scaling)
    rate = (ncol, nlev, NREG, NREG)
    kernels.check_inputs(name, od, dict(
        specs, mu0=(mu0, (ncol,)), tr_diff=(tr_diff, rate),
        tr_dir=(tr_dir, rate)))
    mats = [od.new_empty((nlev, NREG * NREG, ncol, ng)) for _ in range(5)]
    cl5 = tuple(od.new_empty((nlev, ncol, ng)) for _ in range(5))
    n = ncol * nlev * ng
    if n == 0:
        return (*mats, cl5)
    refine = bool(any_expm)
    _launch("spartacus_sw_mats", od,
            (od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b, band_from_g,
             od_scaling, mu0, tr_diff, tr_dir, use_expm, clear_layer, *mats,
             *cl5, *_refine_list(sw_layer_mats, od, n, refine)),
            ncol, nlev, ng, nband, int(refine), float(max_cloud_od))
    sw_layer_mats.launches += 1
    return (*mats, cl5)


sw_layer_mats.launches = 0
sw_layer_mats.refined = 0


def lw_layer_mats(od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b,
                  band_from_g, od_scaling, max_cloud_od, tr, aspect,
                  reg_fracs, clear_layer, pl_top, pl_bot, use_expm,
                  any_expm):
    """The SPARTACUS LW region matrices R, T (nlev, 9, ncol, ng), sources
    SU, SD (nlev, 3, ncol, ng) and clear-sky planes cl4 (four (nlev, ncol,
    ng): lw_ref_trans of the gas with the unscaled Planck terms) of
    spartacus._lw_layer_mats's arguments: returns (R, T, SU, SD, cl4).  ssa
    and g are None for an absorbing gas; aspect (ncol, nlev) is the cloud
    aspect ratio where the side emissivity applies, 0 where it is 1.  CPU
    tensors run that plain version; CUDA
    tensors launch the kernels (csrc/spartacus_layer_mats.cu, the
    refinement in float64) or raise.  pl_top and pl_bot may be views with a
    column stride (planck_hl[:, :-1] and [:, 1:]): (ncol, nlev, ng) of
    strides (s, ng, 1), the same s.  Counters .launches and .refined as
    sw_layer_mats'."""
    if od.device.type == "cpu":
        out = sp._lw_layer_mats(od, ssa, g, od_cloud_b, ssa_cloud_b,
                                g_cloud_b, band_from_g, od_scaling,
                                max_cloud_od, tr, aspect, reg_fracs,
                                clear_layer, pl_top, pl_bot, use_expm,
                                any_expm)
        _count_plain(lw_layer_mats, use_expm, any_expm)
        return out
    return _lw_layer_mats_kernel(od, ssa, g, od_cloud_b, ssa_cloud_b,
                                 g_cloud_b, band_from_g, od_scaling,
                                 max_cloud_od, tr, aspect, reg_fracs,
                                 clear_layer, pl_top, pl_bot, use_expm,
                                 any_expm)


def _lw_layer_mats_kernel(od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b,
                          band_from_g, od_scaling, max_cloud_od, tr, aspect,
                          reg_fracs, clear_layer, pl_top, pl_bot, use_expm,
                          any_expm):
    """lw_layer_mats off the CPU: checks, outputs, scratch, the launch
    set and its counts."""
    name = "spartacus lw_layer_mats"
    ncol, nlev, ng = _elements(name, od)
    _check_masks(name, od, dict(use_expm=(use_expm, (ncol, nlev, ng)),
                                clear_layer=(clear_layer, (ncol, nlev))))
    for arg, t in (("pl_top", pl_top), ("pl_bot", pl_bot)):
        if tuple(t.shape) != (ncol, nlev, ng) or t.device != od.device \
                or t.dtype != od.dtype:
            raise ValueError(f"{name}: {arg} must be {od.dtype} of shape "
                             f"{(ncol, nlev, ng)} on {od.device}")
        if t.stride()[1:] != (ng, 1) or t.stride(0) != pl_top.stride(0) \
                or t.stride(0) < nlev * ng or t.stride(0) >= 2**31:
            raise ValueError(f"{name}: {arg} has strides {t.stride()}, "
                             f"expected (s, {ng}, 1) as pl_top's")
    specs, nband = _optics_specs(name, od, ssa, g, od_cloud_b, ssa_cloud_b,
                                 g_cloud_b, band_from_g, od_scaling)
    specs.update(tr=(tr, (ncol, nlev, NREG, NREG)),
                 aspect=(aspect, (ncol, nlev)),
                 reg_fracs=(reg_fracs, (ncol, nlev, NREG)))
    kernels.check_inputs(name, od, specs)
    R9, T9 = (od.new_empty((nlev, NREG * NREG, ncol, ng)) for _ in range(2))
    SU, SD = (od.new_empty((nlev, NREG, ncol, ng)) for _ in range(2))
    cl4 = tuple(od.new_empty((nlev, ncol, ng)) for _ in range(4))
    n = ncol * nlev * ng
    if n == 0:
        return R9, T9, SU, SD, cl4
    refine = bool(any_expm)
    _launch("spartacus_lw_mats", od,
            (od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b, band_from_g,
             od_scaling, tr, aspect, reg_fracs, clear_layer, pl_top, pl_bot,
             use_expm, R9, T9, SU, SD, *cl4,
             *_refine_list(lw_layer_mats, od, n, refine)),
            ncol, nlev, ng, nband, pl_top.stride(0), int(refine),
            float(max_cloud_od))
    lw_layer_mats.launches += 1
    return R9, T9, SU, SD, cl4


lw_layer_mats.launches = 0
lw_layer_mats.refined = 0
