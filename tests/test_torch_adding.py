"""The port's adding sweeps against the JAX package (CPU, f64).

* ``cuda_adding``'s plain versions against the Pallas kernels of
  ``ecrad_tpu/solvers/pallas_adding.py`` in interpret mode, on the same
  planes (the port's layout transposed and column-padded as the JAX
  package's adding wrappers do it).
* ``adding.adding_sw_reduced``, ``adding_lw_reduced`` and
  ``lw_no_scattering_reduced`` against the JAX package's functions on its
  scan path and on its Pallas path (``ECRAD_TPU_ADDING=pallas`` under
  ``pltpu.force_tpu_interpret_mode()``, as tests/test_pallas_adding.py
  reaches them), with full and (ncol, 1) surface albedos.
* The kernel wrappers take their plain version for CPU tensors only.
* The orders in which ``csrc/adding_sweeps.cu`` computes ``scat_sweeps``
  and ``sw_sweeps`` (an up pass that keeps its carry only every k levels,
  a down pass that recomputes each chunk's carries from there; SW with
  direct albedos) and ``lw_noscat_sweeps`` (both passes in chunks of k
  levels, per-level sums in the kernel's order), in plain torch, against
  the plain versions, on the module's layers, a thick-cloud case and a
  night case.

37 columns: a ragged count (the JAX wrappers pad it to 128).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ecrad_tpu.solvers import adding as jadding
from ecrad_tpu.solvers import pallas_adding
from ecrad_torch.solvers import adding as tadding
from ecrad_torch.solvers import cuda_adding

torch.set_num_threads(2)

NCOL, NLEV, NG = 37, 21, 9
# The plain versions run the Pallas kernels' recurrences in the same
# order, and the port's adding functions those of the JAX scan path (the
# SW surface source multiplies albedo, mu0 and the direct flux in another
# order): f64 roundoff through ~20-level recurrences.
RTOL, ATOL = 1e-12, 1e-12


@pytest.fixture(scope="module")
def props():
    rng = np.random.default_rng(0)

    def u(*shape, lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, shape)

    trans = u(NCOL, NLEV, NG, lo=0.05, hi=0.9)
    # passive layers: refl + trans <= 1
    refl = np.maximum(np.minimum(u(NCOL, NLEV, NG, hi=0.3),
                                 1.0 - trans - 0.01), 0.0)
    return dict(
        refl=refl, trans=trans,
        s_up=u(NCOL, NLEV, NG, hi=5.0), s_dn=u(NCOL, NLEV, NG, hi=5.0),
        rdir=u(NCOL, NLEV, NG, hi=0.2), tdd=u(NCOL, NLEV, NG, hi=0.2),
        tdirdir=u(NCOL, NLEV, NG, lo=0.1, hi=0.95),
        emission=u(NCOL, NG, hi=10.0), albedo=u(NCOL, NG, hi=0.4),
        albedo_col=u(NCOL, 1, hi=0.4), alb_dir=u(NCOL, NG, hi=0.4),
        incoming=u(NCOL, NG, hi=100.0), mu0=u(NCOL, 1, lo=0.05, hi=1.0))


def _t(*xs):
    return tuple(torch.as_tensor(x) for x in xs)


def _knl(x, ncolp):
    """(ncol, nlev, ng) -> the kernel layout (nlev, ng, ncolp)."""
    return jadding._to_kern(jnp.asarray(x), ncolp)


def _knl_surf(x, ncolp):
    return jadding._to_kern_surf(jnp.asarray(x), ncolp)


def _from_knl(x):
    """(..., ncolp) -> (ncol, ...), the padding cut off."""
    return np.moveaxis(np.asarray(x)[..., :NCOL], -1, 0)


# kernel name -> (argument names, planes among them, output names)
KERNELS = {
    "lw_noscat_sweeps": (("trans", "s_up", "s_dn", "emission", "albedo"), 3,
                         ("dn_bb", "fdn_surf", "up_bb", "fup_toa",
                          "fup_surf")),
    "scat_sweeps": (("refl", "trans", "s_up", "s_dn", "albedo", "emission"),
                    4, ("dn_bb", "up_bb", "src_top", "fdn_surf")),
    "sw_sweeps": (("refl", "trans", "rdir", "tdd", "tdirdir", "incoming",
                   "albedo", "alb_dir_mu0"), 5,
                  ("dir_bb", "dn_bb", "up_bb", "fdir_surf", "fdn_surf",
                   "src_top")),
}


@pytest.mark.parametrize("name", list(KERNELS))
def test_plain_matches_pallas(props, name):
    names, nplanes, outs = KERNELS[name]
    p = dict(props, alb_dir_mu0=props["alb_dir"] * props["mu0"])
    args = [p[n] for n in names]
    ncolp = jadding._kernel_cols(NCOL)
    with pltpu.force_tpu_interpret_mode():
        ref = getattr(pallas_adding, name)(
            *[_knl(a, ncolp) for a in args[:nplanes]],
            *[_knl_surf(a, ncolp) for a in args[nplanes:]])
    got = getattr(cuda_adding, name + "_plain")(*_t(*args))
    assert list(got) == list(outs) and len(ref) == len(outs)
    for key, r in zip(outs, ref):
        r = _from_knl(r)
        assert got[key].shape == r.shape, key
        np.testing.assert_allclose(got[key].numpy(), r, rtol=RTOL,
                                   atol=ATOL, err_msg=key)


def _compare(got, ref):
    """Every field of the port's result against the JAX package's; the
    spectral profiles (``*_s``) are absent from both without a
    spec_matrix."""
    assert got._fields == ref._fields
    for field in got._fields:
        if getattr(ref, field) is None:
            assert getattr(got, field) is None, field
            continue
        a, b = np.asarray(getattr(got, field)), np.asarray(getattr(ref, field))
        assert a.shape == b.shape, field
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=field)


def _jax_adding(monkeypatch, mode, fn, *args):
    monkeypatch.setenv("ECRAD_TPU_ADDING", mode)
    jargs = [jnp.asarray(a) for a in args]
    if mode == "scan":
        return getattr(jadding, fn)(*jargs)
    with pltpu.force_tpu_interpret_mode():
        return getattr(jadding, fn)(*jargs)


@pytest.mark.parametrize("albedo", ["albedo", "albedo_col"])
@pytest.mark.parametrize("mode", ["scan", "pallas"])
@pytest.mark.parametrize("fn", ["lw_no_scattering_reduced",
                                "adding_lw_reduced"])
def test_lw_adding_matches_jax(props, monkeypatch, fn, mode, albedo):
    p = props
    args = ((p["trans"], p["s_up"], p["s_dn"]) if fn.startswith("lw_no")
            else (p["refl"], p["trans"], p["s_up"], p["s_dn"]))
    args += (p["emission"], p[albedo])
    ref = _jax_adding(monkeypatch, mode, fn, *args)
    got = getattr(tadding, fn)(*_t(*args))
    assert got.up.shape == (NCOL, NLEV + 1)
    _compare(got, ref)


@pytest.mark.parametrize("mode", ["scan", "pallas"])
def test_sw_adding_matches_jax(props, monkeypatch, mode):
    p = props
    args = (p["incoming"], p["albedo_col"], p["alb_dir"], p["mu0"],
            p["refl"], p["trans"], p["rdir"], p["tdd"], p["tdirdir"])
    ref = _jax_adding(monkeypatch, mode, "adding_sw_reduced", *args)
    got = tadding.adding_sw_reduced(*_t(*args))
    assert got.dn_direct.shape == (NCOL, NLEV + 1)
    _compare(got, ref)


# (ng, nspec) projections of the spectral profiles: g-points into three
# bands, and the identity (g-point output)
SPEC = {"bands": np.eye(3)[np.arange(NG) % 3],
        "gpoints": np.eye(NG)}


@pytest.mark.parametrize("spec", list(SPEC))
@pytest.mark.parametrize("fn", ["lw_no_scattering_reduced",
                                "adding_lw_reduced", "adding_sw_reduced"])
def test_adding_spectral_matches_jax(props, monkeypatch, fn, spec):
    """With a spec_matrix: the projected profiles from the sweeps' per-g
    planes against the JAX package's scan form (which its Pallas mode
    falls back to), every field."""
    p = props
    if fn == "adding_sw_reduced":
        args = (p["incoming"], p["albedo_col"], p["alb_dir"], p["mu0"],
                p["refl"], p["trans"], p["rdir"], p["tdd"], p["tdirdir"])
    else:
        args = ((p["trans"], p["s_up"], p["s_dn"]) if fn.startswith("lw_no")
                else (p["refl"], p["trans"], p["s_up"], p["s_dn"]))
        args += (p["emission"], p["albedo"])
    args += (SPEC[spec],)
    ref = _jax_adding(monkeypatch, "scan", fn, *args)
    got = getattr(tadding, fn)(*_t(*args))
    assert got.up_s.shape == (NCOL, NLEV + 1, SPEC[spec].shape[1])
    _compare(got, ref)


def test_wrappers_run_plain_only_on_cpu(props):
    """A CPU tensor takes the plain version and counts no launch; a tensor
    on any other device goes to the kernel path, which refuses what it
    cannot launch instead of falling back."""
    p = props
    args = _t(p["trans"], p["s_up"], p["s_dn"], p["emission"], p["albedo"])
    before = cuda_adding.lw_noscat_sweeps.launches
    got = cuda_adding.lw_noscat_sweeps(*args)
    ref = cuda_adding.lw_noscat_sweeps_plain(*args)
    assert cuda_adding.lw_noscat_sweeps.launches == before
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    meta = tuple(a.to("meta") for a in args)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_adding.lw_noscat_sweeps(*meta)
    assert cuda_adding.lw_noscat_sweeps.launches == before



@pytest.mark.parametrize("name", list(KERNELS))
def test_wrappers_pass_planes_on_cpu(props, name):
    """planes=True reaches the plain version on CPU tensors (the per-g
    planes beside the same broadband outputs) and counts no launch."""
    p = dict(props, alb_dir_mu0=props["alb_dir"] * props["mu0"])
    names, _, outs = KERNELS[name]
    args = _t(*(p[n] for n in names))
    wrapper = getattr(cuda_adding, name)
    before = wrapper.launches
    got = wrapper(*args, planes=True)
    ref = getattr(cuda_adding, f"{name}_plain")(*args, planes=True)
    assert wrapper.launches == before
    planes = {"dn_g", "up_g"} | ({"dir_g"} if name == "sw_sweeps" else set())
    assert set(got) == set(ref) == set(outs) | planes
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    assert all(got[k].shape == (NCOL, NLEV + 1, NG) for k in planes)

# --- the orders of csrc/adding_sweeps.cu --------------------------------------

def checkpointed_carries(nlev, k, step, carry):
    """The carries below each layer as csrc/adding_sweeps.cu's down pass
    recomputes them: the up pass (surface -> TOA) keeps only the carry
    below each chunk of k levels (chunks counted from TOA, the one at the
    surface ragged), and each chunk's levels are run up again from its
    checkpoint.  step(l, carry) -> (carry above layer l, what the down step
    reuses).  Returns the carry at TOA and [(carry below layer l, reused)]
    by level; k=1 is a hand-off of every level's carry."""
    chunks = [(lo, min(nlev, lo + k)) for lo in range(0, nlev, k)]
    ckpt = [None] * len(chunks)
    for c in range(len(chunks) - 1, -1, -1):
        ckpt[c] = carry
        for l in range(chunks[c][1] - 1, chunks[c][0] - 1, -1):
            carry = step(l, carry)[0]
    below = [None] * nlev
    for c, (lo, hi) in enumerate(chunks):
        up = ckpt[c]
        for l in range(hi - 1, lo - 1, -1):
            nxt, reused = step(l, up)
            below[l], up = (up, reused), nxt
    return carry, below


def checkpointed_scat_sweeps(refl, trans, s_up, s_dn, alb0, src0, k):
    """scat_sweeps in the order of csrc/adding_sweeps.cu: the Moebius up
    pass with checkpoints every k levels, the affine down pass from each
    chunk's recomputed albedos, sources and 1 / (1 - alb_below * refl)."""
    def step(l, carry):
        alb, src = carry
        inv = 1.0 / (1.0 - alb * refl[:, l])
        return ((refl[:, l] + trans[:, l] * trans[:, l] * alb * inv,
                 s_up[:, l] + trans[:, l] * (src + alb * s_dn[:, l]) * inv),
                inv)

    nlev = refl.shape[1]
    (_, src_top), below = checkpointed_carries(nlev, k, step, (alb0, src0))
    fdn, dn_bb, up_bb = torch.zeros_like(alb0), [], []
    for l in range(nlev):
        (alb, src), inv = below[l]
        fdn = (trans[:, l] * fdn + refl[:, l] * src + s_dn[:, l]) * inv
        dn_bb.append(fdn.sum(-1))
        up_bb.append((alb * fdn + src).sum(-1))
    stack = lambda xs: torch.stack(xs, dim=1)  # noqa: E731
    return dict(dn_bb=stack(dn_bb), up_bb=stack(up_bb), src_top=src_top,
                fdn_surf=fdn), below


def direct_albedo_sweeps(coeffs, incoming, alb_dif, alb_dir_mu0, k,
                         affine=False):
    """The SW sweeps with direct albedos, in the order of the two passes of
    csrc/sw_fused.cu (k=1, the albedos below every layer handed over) and
    of csrc/adding_sweeps.cu's sw_sweeps (checkpoints every k levels, and
    with affine each level's down step as fdn' = A fdn + B fdir, fup = Y
    fdir + alb fdn'): up, the diffuse albedo and the direct albedo (upward
    source per unit direct flux) below each layer; down, the direct beam
    with the diffuse flux."""
    refl, trans, rdir, tdd, tdir = coeffs

    def step(l, carry):
        alb, albd = carry
        inv = 1.0 / (1.0 - alb * refl[:, l])
        return ((refl[:, l] + trans[:, l] * trans[:, l] * alb * inv,
                 rdir[:, l] + (tdir[:, l] * albd + tdd[:, l] * alb)
                 * trans[:, l] * inv), inv)

    nlev = refl.shape[1]
    (_, albd_top), below = checkpointed_carries(
        nlev, k, step, (alb_dif, alb_dir_mu0))
    src_top = albd_top * incoming
    fdir, fdn = incoming, torch.zeros_like(incoming)
    dir_bb, dn_bb, up_bb = [], [], []
    for l in range(nlev):
        (alb, albd), inv = below[l]
        if affine:
            y = tdir[:, l] * albd
            fdn = trans[:, l] * inv * fdn \
                + (y * refl[:, l] + tdd[:, l]) * inv * fdir
            up_bb.append((y * fdir + fdn * alb).sum(-1))
        else:
            fdn = (trans[:, l] * fdn
                   + fdir * (tdir[:, l] * albd * refl[:, l] + tdd[:, l])) \
                / (1.0 - refl[:, l] * alb)
            up_bb.append((tdir[:, l] * fdir * albd + fdn * alb).sum(-1))
        fdir = tdir[:, l] * fdir
        dir_bb.append(fdir.sum(-1))
        dn_bb.append(fdn.sum(-1))
    stack = lambda xs: torch.stack(xs, dim=1)  # noqa: E731
    return dict(dir_bb=stack(dir_bb), fdir_surf=fdir, src_top=src_top,
                dn_bb=stack(dn_bb), up_bb=stack(up_bb), fdn_surf=fdn), below


def block_sum(x):
    """The sum over the last axis (g-points) in the order of common.cuh's
    block_sum, which warp_partial and store_level_sums follow: a
    shuffle-down tree over each warp of 32 lanes, padded with zeros, then
    the warps' partials added in warp order."""
    x = torch.nn.functional.pad(x, (0, -x.shape[-1] % 32))
    x = x.unflatten(-1, (-1, 32))
    for off in (16, 8, 4, 2, 1):
        x = x[..., :off] + x[..., off:2 * off]
    s = x[..., 0, 0]
    for w in range(1, x.shape[-2]):
        s = s + x[..., w, 0]
    return s


def chunked_noscat_sweeps(trans, s_up, s_dn, emission, albedo, k):
    """lw_noscat_sweeps in the order of csrc/adding_sweeps.cu: the down
    pass over chunks of k levels from TOA, the up pass over the same
    chunks from the surface one (the short one when k does not divide
    nlev), each chunk's planes taken whole before its levels run, and
    each level's broadband sum in block_sum's order."""
    nlev = trans.shape[1]
    chunks = [(lo, min(nlev, lo + k)) for lo in range(0, nlev, k)]
    dn_bb, up_bb = [None] * nlev, [None] * nlev
    fdn = torch.zeros_like(emission)
    for lo, hi in chunks:
        t, s = trans[:, lo:hi], s_dn[:, lo:hi]
        for j in range(hi - lo):
            fdn = t[:, j] * fdn + s[:, j]
            dn_bb[lo + j] = block_sum(fdn)
    fup_surf = emission + albedo * fdn
    fup = fup_surf
    for lo, hi in reversed(chunks):
        t, s = trans[:, lo:hi], s_up[:, lo:hi]
        for j in range(hi - lo - 1, -1, -1):
            fup = t[:, j] * fup + s[:, j]
            up_bb[lo + j] = block_sum(fup)
    stack = lambda xs: torch.stack(xs, dim=1)  # noqa: E731
    return dict(dn_bb=stack(dn_bb), fdn_surf=fdn, up_bb=stack(up_bb),
                fup_toa=fup, fup_surf=fup_surf)


def _mirror_case(props, case):
    """The module's layers ("props"); with thick cloud in a few layers
    ("thick": direct transmittance at most 1e-6, diffuse reflectance up to
    0.8); or with every third column at night ("night": incoming 0)."""
    p = {k: v.copy() for k, v in props.items()}
    rng = np.random.default_rng(1)
    if case == "thick":
        layers = [2, 7, 8, 9, 15, NLEV - 1]
        shape = (NCOL, len(layers), NG)
        p["refl"][:, layers] = rng.uniform(0.5, 0.8, shape)
        p["trans"][:, layers] = rng.uniform(0.0, 1.0, shape) \
            * (0.99 - p["refl"][:, layers])
        p["tdirdir"][:, layers] = rng.uniform(0.0, 1e-6, shape)
    if case == "night":
        p["incoming"][::3] = 0.0
    p["alb_dir_mu0"] = p["alb_dir"] * p["mu0"]
    return p


# The direct-albedo form is the three SW sweeps' function in another
# rounding order: f64 roundoff through ~20 levels, of each entry and (for
# entries that are zero to roundoff) of the field's largest value.
RTOL_REORDERED = 1e-12
MIRROR_CASES = {"lw_noscat_sweeps": ("props", "thick"),
                "scat_sweeps": ("props", "thick"),
                "sw_sweeps": ("props", "thick", "night")}


@pytest.mark.parametrize("k", [4, 8, 21, 32])    # 21 % k: 1, 5, 0; k > nlev
@pytest.mark.parametrize("name,case", [(n, c) for n, cs in MIRROR_CASES.items()
                                       for c in cs])
def test_checkpointed_sweeps_match_plain(props, name, case, k):
    """The kernel's order (checkpoints every k levels, chunks recomputed;
    SW with direct albedos and affine down steps; LW without scattering
    in chunks, its sums in block_sum's order) gives the plain version's
    outputs, and each recomputed carry equals the one a full up pass hands
    over (k=1), bit for bit; so do LW without scattering's per-g-point
    outputs."""
    p = _mirror_case(props, case)
    names, _, outs = KERNELS[name]
    args = _t(*(p[n] for n in names))
    ref = getattr(cuda_adding, name + "_plain")(*args)
    if name == "lw_noscat_sweeps":
        got, below, handed = chunked_noscat_sweeps(*args, k=k), [], []
        assert all(torch.equal(got[key], ref[key])
                   for key in ("fdn_surf", "fup_toa", "fup_surf"))
    elif name == "scat_sweeps":
        (got, below), (_, handed) = (checkpointed_scat_sweeps(*args, k=k),
                                     checkpointed_scat_sweeps(*args, k=1))
    else:
        (got, below), (_, handed) = (
            direct_albedo_sweeps(args[:5], *args[5:], k=k, affine=True),
            direct_albedo_sweeps(args[:5], *args[5:], k=1, affine=True))
    assert set(got) == set(outs)
    for (carry, _), (carry1, _) in zip(below, handed):
        assert all(torch.equal(a, b) for a, b in zip(carry, carry1))
    for key in outs:
        r = ref[key]
        np.testing.assert_allclose(
            got[key].numpy(), r.numpy(), rtol=RTOL_REORDERED,
            atol=RTOL_REORDERED * float(r.abs().max()), err_msg=key)
    if case == "night":
        assert all(bool((got[key][::3] == 0).all()) for key in outs)
