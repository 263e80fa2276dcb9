"""The port's SPARTACUS step cores and plain sweeps against the JAX
package (CPU, f64, seeded inputs).

* ``two_stream.sw_gammas`` against the JAX function.
* The four step cores (``_sw_up_core``, ``_sw_dn_core``, ``_lw_up_core``,
  ``_lw_dn_core``) against the JAX cores on the same planes, for every
  entrapment mode with 3D on and off, and LW multilayer on and off; the
  masks vary across columns so that every branch is taken.
* ``cuda_spartacus.sw_sweeps_plain`` / ``lw_sweeps_plain`` against the
  Pallas functions themselves (``pallas_spartacus.sw_sweeps`` /
  ``lw_sweeps``) under ``pltpu.force_tpu_interpret_mode()``, on the
  sweep inputs the port builds for seeded atmospheres at 128 columns (the
  Pallas column block needs ``ncol % 128 == 0``), 6 levels and 14
  g-points, for every entrapment mode and multilayer on and off.
* The kernel wrappers take their plain version for CPU tensors only.
* What the kernels skip in clear layers (``SW_CLEAR_ENTRIES``,
  ``LW_CLEAR_ENTRIES``) does not move the plain sweeps' outputs, and
  ``sw_needed_bytes`` / ``lw_needed_bytes`` count the bytes they must move.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ecrad_tpu import config as jconfig
from ecrad_tpu.solvers import pallas_spartacus
from ecrad_tpu.solvers import spartacus as jsp
from ecrad_tpu.solvers import two_stream as jts
from ecrad_torch import config as tconfig
from ecrad_torch.solvers import cuda_spartacus
from ecrad_torch.solvers import spartacus as tsp
from ecrad_torch.solvers import two_stream as tts

torch.set_num_threads(2)

NCOL, NG = 8, 5
# Same formulas in the same order: f64 roundoff (the cores' 3x3 solves
# and the exchange exponentials, a few operations deep)
RTOL_CORE = 1e-12
# The plain sweeps and the Pallas functions run the same cores over 6
# levels: f64 roundoff
RTOL_SWEEP = 1e-12
MODES = ["ZERO", "EDGE_ONLY", "EXPLICIT", "EXPLICIT_NON_FRACTAL", "MAXIMUM"]


def _close(got, ref, rtol, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(ref).max()),
                               err_msg=what)


def _tree_close(got, ref, rtol, what="out"):
    """Port tensors (matrices (3, 3, ...), vectors (3, ...)) against the
    JAX package's nested plane lists."""
    if isinstance(ref, (list, tuple)):
        if isinstance(ref[0], (list, tuple)) and not torch.is_tensor(got):
            for i, (g, r) in enumerate(zip(got, ref)):
                _tree_close(g, r, rtol, f"{what}[{i}]")
            return
        ref = np.stack([np.stack([np.asarray(x) for x in r])
                        if isinstance(r, (list, tuple)) else np.asarray(r)
                        for r in ref])
    _close(got, ref, rtol, what)


# --- sw_gammas -------------------------------------------------------------

def test_sw_gammas_match_jax():
    rng = np.random.default_rng(0)
    mu0 = rng.uniform(0.01, 1.0, (NCOL, 1))
    ssa, g = rng.uniform(0.0, 1.0, (2, NCOL, NG))
    got = tts.sw_gammas(*map(torch.as_tensor, (mu0, ssa, g)))
    ref = jts.sw_gammas(*map(jnp.asarray, (mu0, ssa, g)))
    for a, b in zip(got, ref):
        _close(a.numpy(), b, RTOL_CORE, "gamma")


# --- step cores ------------------------------------------------------------

class _Planes:
    """Seeded plane inputs in both packages' forms."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def u(self, *shape, lo=0.0, hi=1.0):
        return self.rng.uniform(lo, hi, shape)

    def mat(self, lo, hi):
        """A 3x3 plane matrix: (3, 3, NCOL, NG) numpy."""
        return self.u(3, 3, NCOL, NG, lo=lo, hi=hi)

    def col(self, k, lo=0.0, hi=1.0):
        """k per-column values, broadcast-ready: (k, NCOL, 1)."""
        return self.u(k, NCOL, 1, lo=lo, hi=hi)

    def mask(self, p):
        m = self.rng.uniform(0.0, 1.0, (NCOL, 1)) < p
        m[0], m[1] = True, False
        return m


def _t(x):
    return torch.as_tensor(x) if isinstance(x, np.ndarray) else x


def _jm(m):
    """(3, 3, ...) numpy -> [[plane]]."""
    return [[jnp.asarray(m[i, j]) for j in range(3)] for i in range(3)]


def _jv(v):
    return [jnp.asarray(v[i]) for i in range(len(v))]


def _sw_mats(p):
    return (p.mat(0.0, 0.3), p.mat(0.0, 0.6), p.mat(0.0, 0.2),
            p.mat(0.0, 0.2), p.mat(0.0, 0.8))


def _cl(p, n):
    bounds = ((0.0, 0.3), (0.2, 0.9), (0.0, 0.2), (0.0, 0.2), (0.1, 0.9))
    return tuple(p.u(NCOL, NG, lo=lo, hi=hi) for lo, hi in bounds[:n])


def _opts(mode, do_3d):
    kw = dict(do_3d=do_3d, overhang_factor=0.3,
              cloud_fraction_threshold=1e-6, max_cloud_od=2.0)
    return (tsp.SwOpts(mode=tconfig.Entrapment[mode], **kw),
            jsp.SwOpts(mode=jconfig.Entrapment[mode], **kw))


@pytest.mark.parametrize("do_3d", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_sw_up_core_matches_jax(mode, do_3d):
    p = _Planes(1)
    alb, albd = p.mat(0.0, 0.3), p.mat(0.0, 0.3)
    alb_c, albd_c = p.u(NCOL, NG, hi=0.3), p.u(NCOL, NG, hi=0.3)
    xdif, xdir = p.u(3, NCOL, NG, hi=1000.0), p.u(3, NCOL, NG, hi=1000.0)
    mats, cl5 = _sw_mats(p), _cl(p, 5)
    u9, v9 = p.col(9), p.col(9)
    msk = tuple(p.mask(0.5) for _ in range(4))
    rf3, elp3, rfp3 = p.col(3), p.col(3, hi=2e-3), p.col(3)
    invszp, opp = p.col(1, lo=1e-4, hi=2e-3)[0], p.col(1)[0]
    xld, xldir = p.col(1, hi=800.0)[0], p.col(1, hi=800.0)[0]
    topts, jopts = _opts(mode, do_3d)
    got = tsp._sw_up_core(
        tuple(map(_t, (alb, albd, alb_c, albd_c, xdif, xdir))),
        tuple(map(_t, mats)), tuple(map(_t, cl5)), _t(u9), _t(v9),
        tuple(map(_t, msk)),
        tuple(map(_t, (rf3, elp3, rfp3, invszp, opp, xld, xldir))), topts)
    ref = jsp._sw_up_core(
        (_jm(alb), _jm(albd), jnp.asarray(alb_c), jnp.asarray(albd_c),
         _jv(xdif), _jv(xdir)),
        tuple(_jm(m) for m in mats), tuple(map(jnp.asarray, cl5)), _jv(u9),
        _jv(v9), tuple(map(jnp.asarray, msk)),
        (_jv(rf3), _jv(elp3), _jv(rfp3), jnp.asarray(invszp),
         jnp.asarray(opp), jnp.asarray(xld), jnp.asarray(xldir)), jopts)
    for name, a, b in zip(("alb", "albd", "alb_c", "albd_c", "xdif", "xdir"),
                          got, ref):
        _tree_close(a.numpy(), b, RTOL_CORE, name)


def test_sw_dn_core_matches_jax():
    p = _Planes(2)
    fdn, ddn = p.u(3, NCOL, NG, hi=50.0), p.u(3, NCOL, NG, hi=500.0)
    fdn_c, ddn_c = p.u(NCOL, NG, hi=50.0), p.u(NCOL, NG, hi=500.0)
    mats, cl5 = _sw_mats(p), _cl(p, 5)
    alb_n, albd_n = p.mat(0.0, 0.3), p.mat(0.0, 0.3)
    alb_cn, albd_cn = p.u(NCOL, NG, hi=0.3), p.u(NCOL, NG, hi=0.3)
    v9 = p.col(9)
    msk = (p.mask(0.5), p.mask(0.5))
    got = tsp._sw_dn_core(
        tuple(map(_t, (fdn, ddn, fdn_c, ddn_c))), tuple(map(_t, mats)),
        tuple(map(_t, cl5)), tuple(map(_t, (alb_n, albd_n, alb_cn,
                                             albd_cn))),
        _t(v9), tuple(map(_t, msk)))
    ref = jsp._sw_dn_core(
        (_jv(fdn), _jv(ddn), jnp.asarray(fdn_c), jnp.asarray(ddn_c)),
        tuple(_jm(m) for m in mats), tuple(map(jnp.asarray, cl5)),
        (_jm(alb_n), _jm(albd_n), jnp.asarray(alb_cn), jnp.asarray(albd_cn)),
        _jv(v9), tuple(map(jnp.asarray, msk)))
    for part, (a, b) in enumerate(zip(got, ref)):
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_close(x.numpy(), y, RTOL_CORE, f"part {part}[{i}]")


@pytest.mark.parametrize("multilayer", [False, True])
def test_lw_up_core_matches_jax(multilayer):
    p = _Planes(3)
    alb, src = p.mat(0.0, 0.3), p.u(3, NCOL, NG, hi=100.0)
    alb_c, src_c = p.u(NCOL, NG, hi=0.3), p.u(NCOL, NG, hi=100.0)
    R, T = p.mat(0.0, 0.3), p.mat(0.0, 0.6)
    SU, SD = p.u(3, NCOL, NG, hi=50.0), p.u(3, NCOL, NG, hi=50.0)
    cl4 = _cl(p, 2) + (p.u(NCOL, NG, hi=50.0), p.u(NCOL, NG, hi=50.0))
    u9, v9 = p.col(9), p.col(9)
    msk = (p.mask(0.5), p.mask(0.5))
    got = tsp._lw_up_core(
        tuple(map(_t, (alb, src, alb_c, src_c))),
        tuple(map(_t, (R, T, SU, SD))), tuple(map(_t, cl4)), _t(u9),
        _t(v9), tuple(map(_t, msk)), tsp.LwOpts(multilayer=multilayer))
    ref = jsp._lw_up_core(
        (_jm(alb), _jv(src), jnp.asarray(alb_c), jnp.asarray(src_c)),
        (_jm(R), _jm(T), _jv(SU), _jv(SD)), tuple(map(jnp.asarray, cl4)),
        _jv(u9), _jv(v9), tuple(map(jnp.asarray, msk)),
        jsp.LwOpts(multilayer=multilayer))
    for name, a, b in zip(("alb", "src", "alb_c", "src_c"), got, ref):
        _tree_close(a.numpy(), b, RTOL_CORE, name)


def test_lw_dn_core_matches_jax():
    p = _Planes(4)
    fdn, fdn_c = p.u(3, NCOL, NG, hi=100.0), p.u(NCOL, NG, hi=100.0)
    R, T = p.mat(0.0, 0.3), p.mat(0.0, 0.6)
    SU, SD = p.u(3, NCOL, NG, hi=50.0), p.u(3, NCOL, NG, hi=50.0)
    cl4 = _cl(p, 2) + (p.u(NCOL, NG, hi=50.0), p.u(NCOL, NG, hi=50.0))
    src_n, alb_n = p.u(3, NCOL, NG, hi=100.0), p.mat(0.0, 0.3)
    src_cn, alb_cn = p.u(NCOL, NG, hi=100.0), p.u(NCOL, NG, hi=0.3)
    v9 = p.col(9)
    msk = (p.mask(0.5), p.mask(0.5))
    got = tsp._lw_dn_core(
        tuple(map(_t, (fdn, fdn_c))), tuple(map(_t, (R, T, SU, SD))),
        tuple(map(_t, cl4)), tuple(map(_t, (src_n, alb_n, src_cn, alb_cn))),
        _t(v9), tuple(map(_t, msk)))
    ref = jsp._lw_dn_core(
        (_jv(fdn), jnp.asarray(fdn_c)), (_jm(R), _jm(T), _jv(SU), _jv(SD)),
        tuple(map(jnp.asarray, cl4)),
        (_jv(src_n), _jm(alb_n), jnp.asarray(src_cn), jnp.asarray(alb_cn)),
        _jv(v9), tuple(map(jnp.asarray, msk)))
    for part, (a, b) in enumerate(zip(got, ref)):
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_close(x.numpy(), y, RTOL_CORE, f"part {part}[{i}]")


# --- plain sweeps against the interpret-mode Pallas functions --------------

KNCOL, KNLEV, NBAND = 128, 6, 5
GCOUNTS = (3, 2, 4, 2, 3)
KNG = sum(GCOUNTS)
BAND_FROM_G = torch.as_tensor(np.repeat(np.arange(NBAND), GCOUNTS))


@pytest.fixture(scope="module")
def atmosphere():
    """Seeded solver inputs at 128 columns: cloud-free columns, night and
    low-sun columns, and clouds at every level."""
    rng = np.random.default_rng(21)

    def u(*shape, lo=0.0, hi=1.0):
        return torch.as_tensor(rng.uniform(lo, hi, shape))

    frac = u(KNCOL, KNLEV) * (u(KNCOL, KNLEV) > 0.4)
    frac[0] = 0.0
    cos_sza = u(KNCOL, lo=-0.2, hi=1.0)
    cos_sza[1], cos_sza[2] = 0.0, 0.003
    p_hl = 30000.0 + 8000.0 * torch.arange(KNLEV + 1.0)[None] \
        + u(KNCOL, KNLEV + 1, hi=300.0)
    clouds = (frac, u(KNCOL, KNLEV, hi=2.5), u(KNCOL, KNLEV - 1, lo=-0.1),
              u(KNCOL, KNLEV, lo=1e-4, hi=2e-3),
              u(KNCOL, KNLEV, lo=1e-4, hi=3e-3), p_hl,
              u(KNCOL, KNLEV + 1, lo=200.0, hi=300.0))
    optics = (u(KNCOL, KNLEV, KNG, lo=1e-4, hi=3.0),
              u(KNCOL, KNLEV, KNG, lo=0.1, hi=0.999),
              u(KNCOL, KNLEV, KNG, hi=0.8),
              u(KNCOL, KNLEV, NBAND, hi=4.0),
              u(KNCOL, KNLEV, NBAND, lo=0.3, hi=0.999),
              u(KNCOL, KNLEV, NBAND, hi=0.9), BAND_FROM_G)
    sw = (u(KNCOL, KNG, hi=100.0), cos_sza, u(KNCOL, KNG, hi=0.3),
          u(KNCOL, KNG, hi=0.4))
    lw = (u(KNCOL, KNLEV + 1, KNG, lo=0.5, hi=30.0), u(KNCOL, KNG, hi=10.0),
          u(KNCOL, KNG, hi=0.3))
    return optics, clouds, sw, lw


def _jaxify(x):
    if torch.is_tensor(x):
        return jnp.asarray(x.numpy())
    return tuple(_jaxify(v) for v in x)


def _flat_close(got, ref, rtol, what="out"):
    if torch.is_tensor(got):
        _close(got.numpy(), ref, rtol, what)
        return
    assert len(got) == len(ref), what
    for i, (a, b) in enumerate(zip(got, ref)):
        _flat_close(a, b, rtol, f"{what}[{i}]")


# every mode with 3D on; 3D off changes only the Edge-only/Explicit mix,
# which the step-core test covers for every mode
@pytest.mark.parametrize("mode,do_3d", [(m, True) for m in MODES]
                         + [("EXPLICIT", False)])
def test_sw_sweeps_plain_match_pallas(atmosphere, mode, do_3d):
    optics, clouds, sw, _ = atmosphere
    cfg = tconfig.Config(sw_entrapment=tconfig.Entrapment[mode],
                         do_3d_effects=do_3d, overhang_factor=0.3)
    opts, args, _ = tsp.sw_sweep_args(cfg, *optics, *clouds, *sw)
    assert args[0].shape == (KNLEV, 9, KNCOL, KNG)
    got = cuda_spartacus.sw_sweeps_plain(opts, *args)
    jopts = jsp.SwOpts(mode=jconfig.Entrapment[mode], do_3d=do_3d,
                       overhang_factor=0.3,
                       cloud_fraction_threshold=opts.cloud_fraction_threshold,
                       max_cloud_od=opts.max_cloud_od)
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_spartacus.sw_sweeps(jopts, *_jaxify(args))
    _flat_close(got, ref, RTOL_SWEEP)


@pytest.mark.parametrize("multilayer", [False, True])
def test_lw_sweeps_plain_match_pallas(atmosphere, multilayer):
    optics, clouds, _, lw = atmosphere
    cfg = tconfig.Config(do_3d_effects=True,
                         do_3d_lw_multilayer_effects=multilayer)
    opts, args, _ = tsp.lw_sweep_args(cfg, *optics, *clouds, *lw)
    assert opts.multilayer == multilayer
    got = cuda_spartacus.lw_sweeps_plain(opts, *args)
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_spartacus.lw_sweeps(jsp.LwOpts(multilayer=multilayer),
                                         *_jaxify(args))
    _flat_close(got, ref, RTOL_SWEEP)


def test_wrappers_run_plain_only_on_cpu(atmosphere):
    """A CPU tensor takes the plain version and counts no launch; a tensor
    on any other device goes to the kernel path, which refuses what it
    cannot launch instead of falling back."""
    optics, clouds, sw, lw = atmosphere
    cfg = tconfig.Config(do_3d_effects=True)
    for fn, plain, (opts, args, _) in (
            (cuda_spartacus.sw_sweeps, cuda_spartacus.sw_sweeps_plain,
             tsp.sw_sweep_args(cfg, *optics, *clouds, *sw)),
            (cuda_spartacus.lw_sweeps, cuda_spartacus.lw_sweeps_plain,
             tsp.lw_sweep_args(cfg, *optics, *clouds, *lw))):
        before = fn.launches
        _flat_close(fn(opts, *args), plain(opts, *args), 0.0)
        meta = tuple(a.to("meta") if torch.is_tensor(a)
                     else tuple(x.to("meta") for x in a) for a in args)
        with pytest.raises(ValueError, match="unsupported device"):
            fn(opts, *meta)
        assert fn.launches == before


# --- what the SW kernel skips in clear layers ------------------------------

def _sw_args(atmosphere, mode):
    optics, clouds, sw, _ = atmosphere
    cfg = tconfig.Config(sw_entrapment=tconfig.Entrapment[mode],
                         do_3d_effects=True, overhang_factor=0.3)
    opts, args, _ = tsp.sw_sweep_args(cfg, *optics, *clouds, *sw)
    return opts, args


@pytest.mark.parametrize("mode", ["EXPLICIT", "MAXIMUM", "EDGE_ONLY"])
def test_sw_sweeps_ignore_what_clear_layers_skip(atmosphere, mode):
    """The contract of the SW kernel's clear-layer branch: the plain sweeps
    give the same outputs when every layer-matrix entry the kernel does not
    read in clear layers (all but cuda_spartacus.SW_CLEAR_ENTRIES), and
    every entry but [0][0] of the albedos handed from the up to the down
    sweep there, is replaced by random finite values."""
    opts, args = _sw_args(atmosphere, mode)
    ref = cuda_spartacus.sw_sweeps_plain(opts, *args)
    mats, (cl5, u9c, v9top, v9bot, msk_up, msk_dn, ent13, alb0, albd0,
           albc0, albdc0, ddn0, incoming) = args[:5], args[5:]
    clear = msk_dn[..., 0] != 0.0                       # (nlev, ncol)
    assert bool(clear.any()) and bool((~clear).any())
    rng = np.random.default_rng(5)

    def scramble(x, keep, where):
        """x (9, ...) stacked: entries not in keep replaced where `where`
        (broadcast over the trailing axes)."""
        drop = torch.ones(9, dtype=torch.bool)
        drop[list(keep)] = False
        drop = drop.reshape((9,) + (1,) * (x.dim() - 1))
        noise = torch.as_tensor(rng.uniform(0.0, 1.0, tuple(x.shape)))
        return torch.where(drop & where, noise, x)

    mats = tuple(scramble(m.transpose(0, 1), keep,
                          clear[:, :, None]).transpose(0, 1)
                 for m, keep in zip(mats, cuda_spartacus.SW_CLEAR_ENTRIES))
    carry, below = cuda_spartacus._sw_up_plain(
        opts, mats, cl5, u9c, v9top, msk_up, ent13, alb0, albd0, albc0,
        albdc0)
    below = [tuple(scramble(m.reshape(9, *m.shape[2:]), (0,),
                            clear[l][:, None]).reshape(m.shape)
                   for m in b[:2]) + b[2:]
             for l, b in enumerate(below)]
    dn = cuda_spartacus._sw_dn_plain(mats, cl5, below, v9bot, msk_dn, ddn0,
                                     incoming)
    got = (carry[1].reshape(9, *carry[1].shape[2:]), carry[2], carry[3], dn)
    _flat_close(got, tuple(x.numpy() if torch.is_tensor(x)
                           else tuple(y.numpy() for y in x) for x in ref),
                1e-12)


@pytest.mark.parametrize("cloudy", [True, False])
def test_sw_needed_bytes(atmosphere, cloudy):
    """sw_needed_bytes counts every byte of every input and output tensor
    when every layer is cloudy, and in clear layers only the layer-matrix
    entries of SW_CLEAR_ENTRIES."""
    opts, args = _sw_args(atmosphere, "EXPLICIT")
    msk_dn = args[10].clone()
    msk_dn[..., 0] = 0.0 if cloudy else 1.0
    args = args[:10] + (msk_dn,) + args[11:]
    outs = cuda_spartacus.sw_sweeps(opts, *args)

    def nbytes(x):
        if torch.is_tensor(x):
            return x.numel() * x.element_size()
        return sum(nbytes(v) for v in x)

    every = nbytes(args) + nbytes(outs)
    nlev, _, ncol, ng = args[0].shape
    skipped = sum(9 - len(k) for k in cuda_spartacus.SW_CLEAR_ENTRIES) \
        * nlev * ncol * ng * args[0].element_size()
    want = every if cloudy else every - skipped
    assert cuda_spartacus.sw_needed_bytes(opts, *args) == want


# --- what the LW kernel skips in clear layers ------------------------------

def _lw_args(atmosphere, multilayer=False):
    optics, clouds, _, lw = atmosphere
    cfg = tconfig.Config(do_3d_effects=True,
                         do_3d_lw_multilayer_effects=multilayer)
    opts, args, _ = tsp.lw_sweep_args(cfg, *optics, *clouds, *lw)
    return opts, args


def _scramble(rng, x, keep, where):
    """x (K, ...) stacked: entries not in keep replaced by random finite
    values where `where` (broadcast over the trailing axes)."""
    drop = torch.ones(x.shape[0], dtype=torch.bool)
    drop[list(keep)] = False
    drop = drop.reshape((-1,) + (1,) * (x.dim() - 1))
    noise = torch.as_tensor(rng.uniform(0.0, 1.0, tuple(x.shape)))
    return torch.where(drop & where, noise, x)


@pytest.mark.parametrize("multilayer", [False, True])
def test_lw_sweeps_ignore_what_clear_layers_skip(atmosphere, multilayer):
    """The contract of the LW kernel's clear-layer branch: the plain sweeps
    give the same outputs when every layer-matrix entry the kernel does not
    read in clear layers (all but cuda_spartacus.LW_CLEAR_ENTRIES) is
    replaced by random finite values, and the sweeps run through the step
    cores as the kernel does also when every entry but alb[0][0] and
    src[0] of the carry handed from the up to the down sweep is."""
    opts, args = _lw_args(atmosphere, multilayer)
    ref = cuda_spartacus.lw_sweeps_plain(opts, *args)
    mats, (cl4, u9c, v9top, v9bot, msk_up, msk_dn, alb0, src0, albc0,
           srcc0) = args[:4], args[4:]
    clear = msk_dn[..., 0] != 0.0                       # (nlev, ncol)
    assert bool(clear.any()) and bool((~clear).any())
    rng = np.random.default_rng(7)
    mats = tuple(_scramble(rng, m.transpose(0, 1), keep,
                           clear[:, :, None]).transpose(0, 1)
                 for m, keep in zip(mats, cuda_spartacus.LW_CLEAR_ENTRIES))
    ref_np = tuple(x.numpy() if torch.is_tensor(x)
                   else tuple(y.numpy() for y in x) for x in ref)
    _flat_close(cuda_spartacus.lw_sweeps_plain(opts, *mats, *args[4:]),
                ref_np, 1e-12)

    # the up sweep, the hand-off with only what the kernel stores in clear
    # layers, the down sweep
    nlev, _, ncol, ng = mats[0].shape
    lmats = [(tsp._m3(mats[0][l]), tsp._m3(mats[1][l]), mats[2][l],
              mats[3][l]) for l in range(nlev)]
    carry = (tsp._m3(alb0), src0, albc0, srcc0)
    below = [None] * nlev
    for l in range(nlev - 1, -1, -1):
        alb, src, alb_c, src_c = carry
        where = clear[l][:, None]
        below[l] = (_scramble(rng, src, (0,), where),
                    _scramble(rng, alb.reshape(9, ncol, ng), (0,),
                              where).reshape(alb.shape), src_c, alb_c)
        m = msk_up[l] != 0.0
        carry = tsp._lw_up_core(carry, lmats[l], tuple(c[l] for c in cl4),
                                cuda_spartacus._b(u9c[l]),
                                cuda_spartacus._b(v9top[l]),
                                (m[:, 0, None], m[:, 1, None]), opts)
    state = (src0.new_zeros((3, ncol, ng)), torch.zeros_like(srcc0))
    ys = []
    for l in range(nlev):
        m = msk_dn[l] != 0.0
        state, y = tsp._lw_dn_core(state, lmats[l], tuple(c[l] for c in cl4),
                                   below[l], cuda_spartacus._b(v9bot[l]),
                                   (m[:, 0, None], m[:, 1, None]))
        ys.append(y)
    got = (carry[1], carry[3], tuple(torch.stack(x) for x in zip(*ys)))
    _flat_close(got, ref_np, 1e-12)


@pytest.mark.parametrize("cloudy", [True, False])
def test_lw_needed_bytes(atmosphere, cloudy):
    """lw_needed_bytes counts every byte of every input and output tensor
    when every layer is cloudy, and in clear layers only the layer-matrix
    entries of LW_CLEAR_ENTRIES."""
    opts, args = _lw_args(atmosphere)
    msk_dn = args[9].clone()
    msk_dn[..., 0] = 0.0 if cloudy else 1.0
    args = args[:9] + (msk_dn,) + args[10:]
    outs = cuda_spartacus.lw_sweeps(opts, *args)

    def nbytes(x):
        if torch.is_tensor(x):
            return x.numel() * x.element_size()
        return sum(nbytes(v) for v in x)

    every = nbytes(args) + nbytes(outs)
    nlev, _, ncol, ng = args[0].shape
    skipped = sum(m.shape[1] - len(k) for m, k in
                  zip(args[:4], cuda_spartacus.LW_CLEAR_ENTRIES)) \
        * nlev * ncol * ng * args[0].element_size()
    want = every if cloudy else every - skipped
    assert cuda_spartacus.lw_needed_bytes(opts, *args) == want
