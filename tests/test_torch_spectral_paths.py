"""Spectral solar scaling, blocking and the per-g planes of the port's
spectral flux outputs (CPU, f64).

* ``use_spectral_solar_scaling``: the RRTMG gas optics against the JAX
  package's with the scaling vector of ``tests/test_solar.py`` (band 4
  scaled by 1.5; the totals renormalised to the solar irradiance), and a
  full flagship step with it against the JAX step.
* A blocked step with the scaling vector over two blocks equals the
  one-block step (the vector has no column axis; it goes to every block
  whole).
* The plain versions of the four kernels that write per-g planes
  (McICA and Tripleclouds LW and SW), on the inputs the main paths build
  at RRTMG and ecCKD widths: the broadband outputs with planes are those
  without, and the planes summed over g and at TOA and the surface are
  the kernels' broadband sums and boundary planes.
* The plain versions of the three adding sweeps with their per-g planes
  (the values their kernels' build with planes writes), on the clear-sky
  and total-scene inputs the Cloudless and unfused McICA paths build: the
  same broadband outputs as without planes, the planes summed over g the
  per-level sums, and their TOA and surface rows the boundary planes.
* The routes through the adding sweeps (Cloudless, Homogeneous LW with
  aerosol scattering, the Tripleclouds scan form) with flux profiles and
  TOA fluxes per band against the JAX package's step, every field within
  1e-9 W m-2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__
from ecrad_tpu import pipeline as jpipeline
from ecrad_tpu.optics import rrtmg as jrrtmg
from ecrad_torch import flagship, pipeline
from ecrad_torch.interface import _optical_properties
from ecrad_torch.optics import rrtmg as trrtmg
from ecrad_torch.solvers import cuda_adding, cuda_mcica, cuda_tripleclouds
from tests.torch_steps import (FLAGSHIP_FIELDS, PROFILE_FIELDS, TOA_FIELDS,
                               assert_fluxes, columns, jax_step, port_args,
                               port_step)

import chip_smoke

torch.set_num_threads(2)

SCALING = np.ones(14)
SCALING[3] = 1.5                 # tests/test_solar.py


def test_spectral_solar_scaling_gas_optics():
    ncol, nlev, tsi = 4, 20, 1361.0
    p_hl = np.broadcast_to(np.linspace(100.0, 101325.0, nlev + 1),
                           (ncol, nlev + 1)).copy()
    t_hl = np.full((ncol, nlev + 1), 260.0)
    gas = {"h2o": 1e-3, "co2": 6e-4, "o3": 1e-6}
    mu = np.array([0.6, 0.3, -0.1, 1.0])          # one night column
    jt = jrrtmg.setup_tables()
    tt = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
          for k, v in trrtmg.setup_tables().items()}

    def run_jax(scaling):
        return np.asarray(jrrtmg.gas_optics(
            jt, jnp.asarray(p_hl), jnp.asarray(t_hl),
            {k: jnp.full((ncol, nlev), v) for k, v in gas.items()},
            cos_sza=jnp.asarray(mu), do_lw=False, do_sw=True,
            solar_irradiance=tsi, spectral_solar_scaling=scaling).incoming_sw)

    def run_port(scaling):
        return trrtmg.gas_optics(
            tt, torch.as_tensor(p_hl), torch.as_tensor(t_hl),
            {k: torch.full((ncol, nlev), v, dtype=torch.float64)
             for k, v in gas.items()},
            cos_sza=torch.as_tensor(mu), do_lw=False, do_sw=True,
            solar_irradiance=tsi,
            spectral_solar_scaling=scaling).incoming_sw.numpy()

    ref, got = run_jax(jnp.asarray(SCALING)), run_port(SCALING)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)
    unscaled = run_port(None)
    day = mu > 0
    np.testing.assert_allclose(got[day].sum(-1), tsi, rtol=1e-12)
    assert not got[~day].any()
    band = np.asarray(tt["sw_band_from_g"])
    in4 = band == 3
    ratio = (got[0, in4].sum() / got[0, ~in4].sum()) \
        / (unscaled[0, in4].sum() / unscaled[0, ~in4].sum())
    np.testing.assert_allclose(ratio, 1.5, rtol=1e-12)


def test_spectral_solar_scaling_step_matches_jax():
    jstep, jargs = __graft_entry__._build(ncol=32, dtype="float64")
    jconfig = jstep.config.replace(use_spectral_solar_scaling=True)
    jkw = dict(zip(flagship.ARG_ORDER,
                   [columns(a, jnp.asarray) for a in jargs]))
    flux = jax.jit(lambda kw, s: jpipeline.radiation_step(
        jconfig, jstep.tables, solar_irradiance=jstep.solar,
        spectral_solar_scaling=s, **kw))(jkw, jnp.asarray(SCALING))
    ref = {k: np.asarray(getattr(flux, k)) for k in flux.__dataclass_fields__
           if getattr(flux, k) is not None}

    step, kw = port_args()
    config = step.config.replace(use_spectral_solar_scaling=True)
    flux = pipeline.radiation_step(
        config, step.tables, solar_irradiance=step.solar,
        spectral_solar_scaling=torch.as_tensor(SCALING), **kw)
    got = {k: v.numpy() for k, v in flux.fields().items()}
    assert_fluxes(got, ref)
    plain = pipeline.radiation_step(step.config, step.tables,
                                    solar_irradiance=step.solar, **kw)
    assert np.abs(got["sw_dn_surf_band"][:, 3]
                  - plain.sw_dn_surf_band[:, 3].numpy()).max() > 1.0


def test_blocked_spectral_step_with_scaling_equals_one_block():
    step, args = flagship.build(ncol=5, dtype=torch.float64, device="cpu",
                                config_name="mcica_rrtmg_spectral")
    config = step.config.replace(use_spectral_solar_scaling=True)
    kw = dict(zip(flagship.ARG_ORDER, args), solar_irradiance=step.solar,
              spectral_solar_scaling=torch.as_tensor(SCALING))
    one = pipeline.radiation_step(config, step.tables, **kw).fields()
    blocked = pipeline.radiation_blocked(config, step.tables, block_size=2,
                                         **kw).fields()
    assert set(one) == set(blocked) == set(
        FLAGSHIP_FIELDS + PROFILE_FIELDS + TOA_FIELDS)
    for k, v in one.items():
        torch.testing.assert_close(blocked[k], v, rtol=0, atol=1e-10,
                                   msg=k)


# --- the plain versions' planes ---------------------------------------------

KERNELS = {"lw_fused": cuda_mcica.lw_fused_plain,
           "sw_fused": cuda_mcica.sw_fused_plain,
           "tripleclouds_lw": cuda_tripleclouds.lw_fused_plain,
           "tripleclouds_sw": cuda_tripleclouds.sw_fused_plain}


def _fused_args(config_name):
    """The four kernels' arguments as chip_smoke.fused_inputs builds them
    from a McICA step's state (3 meridian columns, one at night)."""
    step, args = flagship.build(ncol=3, dtype=torch.float64, device="cpu",
                                config_name=config_name)
    kw = dict(zip(flagship.ARG_ORDER, args))
    cloud = pipeline.add_cloud_sample(step.config, step.tables,
                                      kw.pop("cloud"))
    op = _optical_properties(step.config, step.tables,
                             solar_irradiance=step.solar, cloud=cloud, **kw)
    return chip_smoke.fused_inputs(step, kw, cloud, op)


@pytest.fixture(scope="module", params=["mcica_rrtmg", "ecckd_mcica"])
def fused_args(request):
    return _fused_args(request.param)


def _boundaries(name, args, r):
    """{(plane, row): the kernel output that row must equal}."""
    lw = name.endswith("lw") or name == "lw_fused"
    if lw:
        top_t = r["src_top_t"]
        if top_t.dim() == 3:                          # Tripleclouds regions
            top_t = top_t.sum(1)
        return {("dn_g_c", -1): r["fdn_surf_c"],
                ("up_g_c", 0): r["fup_toa_c"],
                ("up_g_c", -1): r["fup_surf_c"],
                ("dn_g_t", -1): r["fdn_surf_t"],
                ("up_g_t", -1): r["fup_surf_t"], ("up_g_t", 0): top_t}
    out = {}
    for s in "ct":
        out.update({(f"dir_g_{s}", -1): r[f"fdir_surf_{s}"],
                    (f"dn_g_{s}", -1): r[f"fdn_surf_{s}"]})
    incoming = args[9] if name == "sw_fused" else args[10]
    out[("dir_g_c", 0)] = incoming
    if name == "sw_fused":
        out.update({("up_g_c", 0): r["src_top_c"],
                    ("up_g_t", 0): r["src_top_t"],
                    ("dir_g_t", 0): incoming})
    else:
        fdir0 = args[11]
        out.update({("up_g_c", 0): incoming * r["albd_top_c"],
                    ("up_g_t", 0): (fdir0 * r["albd_top"]).sum(1),
                    ("dir_g_t", 0): fdir0.sum(1)})
    return out


@pytest.mark.parametrize("name", list(KERNELS))
def test_plain_planes_sum_to_broadband(fused_args, name):
    args = fused_args[name]
    plain = KERNELS[name]
    base = plain(*args)
    r = plain(*args, planes=True)
    names = (cuda_mcica.LW_PLANES if "lw" in name else cuda_mcica.SW_PLANES)
    assert set(r) == set(base) | set(names)
    for k, v in base.items():
        assert torch.equal(r[k], v), k
    ncol, nlev, ng = args[0].shape
    for p in names:
        plane = r[p]
        assert plane.shape == (ncol, nlev + 1, ng), p
        kind, _, scene = p.split("_")
        rows = slice(0, nlev) if (p == "up_g_c" and "lw" in name) \
            else slice(1, nlev + 1)
        torch.testing.assert_close(plane[:, rows].sum(-1),
                                   r[f"{kind}_bb_{scene}"], rtol=1e-12,
                                   atol=1e-12, msg=p)
        if kind == "dn":
            assert not plane[:, 0].any(), p
    for (p, row), want in _boundaries(name, args, r).items():
        torch.testing.assert_close(r[p][:, row], want, rtol=1e-13,
                                   atol=1e-13, msg=f"{p}[{row}]")


# --- the adding sweeps' planes -----------------------------------------------

SWEEPS = {"lw_noscat_sweeps": cuda_adding.lw_noscat_sweeps_plain,
          "scat_sweeps": cuda_adding.scat_sweeps_plain,
          "sw_sweeps": cuda_adding.sw_sweeps_plain}


@pytest.fixture(scope="module")
def sweep_args():
    """The three sweeps' arguments on the clear sky
    (chip_smoke.clear_sky_inputs) and scat_sweeps' and sw_sweeps' on the
    total scene (chip_smoke.total_scene_inputs) of a McICA step's state (3
    meridian columns, one at night)."""
    step, args = flagship.build(ncol=3, dtype=torch.float64, device="cpu")
    kw = dict(zip(flagship.ARG_ORDER, args))
    cloud = pipeline.add_cloud_sample(step.config, step.tables,
                                      kw.pop("cloud"))
    op = _optical_properties(step.config, step.tables,
                             solar_irradiance=step.solar, cloud=cloud, **kw)
    clear = dict(zip(SWEEPS, chip_smoke.clear_sky_inputs(kw, op)))
    total = chip_smoke.total_scene_inputs(step, kw, cloud, op)
    return {"clear": clear, "total": total}


# (plane, row) -> the output that row of the plane must equal
SWEEP_BOUNDARIES = {
    "lw_noscat_sweeps": {("dn_g", -1): "fdn_surf", ("up_g", 0): "fup_toa",
                         ("up_g", -1): "fup_surf"},
    "scat_sweeps": {("dn_g", -1): "fdn_surf", ("up_g", 0): "src_top"},
    "sw_sweeps": {("dn_g", -1): "fdn_surf", ("dir_g", -1): "fdir_surf",
                  ("up_g", 0): "src_top"},
}


@pytest.mark.parametrize("name, scene", [
    ("lw_noscat_sweeps", "clear"), ("scat_sweeps", "clear"),
    ("scat_sweeps", "total"), ("sw_sweeps", "clear"), ("sw_sweeps", "total")])
def test_plain_sweep_planes_sum_to_broadband(sweep_args, name, scene):
    args = sweep_args[scene][name]
    plain = SWEEPS[name]
    base = plain(*args)
    r = plain(*args, planes=True)
    names = {"dn_g", "up_g"} | ({"dir_g"} if name == "sw_sweeps" else set())
    assert set(r) == set(base) | names
    for k, v in base.items():
        assert torch.equal(r[k], v), k
    ncol, nlev, ng = args[0].shape
    for p in names:
        plane = r[p]
        assert plane.shape == (ncol, nlev + 1, ng), p
        # lw_noscat_sweeps sums the up flux at half-levels 0..nlev-1, the
        # others every flux at 1..nlev
        rows = slice(0, nlev) if (name, p) == ("lw_noscat_sweeps", "up_g") \
            else slice(1, nlev + 1)
        torch.testing.assert_close(plane[:, rows].sum(-1),
                                   r[f"{p[:-2]}_bb"], rtol=1e-12,
                                   atol=1e-12, msg=p)
    assert not r["dn_g"][:, 0].any()
    if name == "sw_sweeps":
        assert torch.equal(r["dir_g"][:, 0], args[5])
    for (p, row), out in SWEEP_BOUNDARIES[name].items():
        torch.testing.assert_close(r[p][:, row], r[out], rtol=1e-13,
                                   atol=1e-13, msg=f"{p}[{row}]")


# --- the routes through the adding sweeps against JAX ------------------------

# CPU, f64: the JAX package's scan path and the port's sweeps agree to
# ~2e-11 W m-2 on these columns
ATOL_ROUTES = 1e-9


def config_over(config_name, **extra):
    """A configuration's Config fields over the flagship's, enums by member
    name (as tests.torch_steps takes them)."""
    return {k: getattr(v, "name", v)
            for k, v in {**flagship.CONFIGS[config_name], **extra}.items()}


@pytest.mark.parametrize("config_name, over", [
    ("cloudless_rrtmg", {}),
    ("homogeneous_rrtmg", {}),
    ("tripleclouds_rrtmg", dict(do_lw_aerosol_scattering=True)),
])
def test_adding_sweep_routes_match_jax(config_name, over):
    over = config_over(config_name, do_save_spectral_flux=True,
                       do_toa_spectral_flux=True, **over)
    ref, got = jax_step(over), port_step(over)
    for k in PROFILE_FIELDS:
        width = 14 if k.startswith("sw") else 16
        assert got[k].shape == (4, 138, width), k
        assert np.abs(ref[k]).max() > 1.0, k
    assert_fluxes(got, ref, FLAGSHIP_FIELDS + PROFILE_FIELDS + TOA_FIELDS,
                  atol=ATOL_ROUTES)
