"""The reference's SPARTACUS route on its own: on the fields of the port's
``spartacus_ecckd`` (no aerosols) and ``spartacus_3d`` (RRTMG, in ecRad's
SPARTACUS g order, with the flagship's aerosols) over the 32 meridian
columns, against the JAX package's frozen float64 fluxes of those
configurations (``tests/data/torch_spartacus_ecckd_meridian32.npz``,
``torch_spartacus_meridian32.npz``), and on RRTMG in natural g order
missing them; on ecCKD, the parent route's formula bit for bit; on the
other entrapment modes, multilayer LW effects, without 3D effects, at
RRTMG's widths and with RRTMG in one band set only, against the port's
CPU path; and refusing what it does not follow."""

import dataclasses
import enum
import json
import os

import numpy as np
import pytest
import torch

from benchmark import check, inputs, program, run
from benchmark.reference import interface, step
from benchmark.reference.solvers.spartacus_lw import solver_spartacus_lw
from benchmark.reference.solvers.spartacus_sw import solver_spartacus_sw

FROZEN = os.path.join(run.ROOT, "tests", "data",
                      "torch_spartacus_ecckd_meridian32.npz")
FROZEN_RRTMG = os.path.join(run.ROOT, "tests", "data",
                            "torch_spartacus_meridian32.npz")
SPARTACUS = os.path.join(run.HERE, "configs", "spartacus_ecckd.json")
FLAGSHIP = os.path.join(run.HERE, "configs", "mcica_rrtmg.json")


def _write_config(tmp_path, fields: dict, name="cfg") -> str:
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps({"config": fields}))
    return str(path)


def _fields_of(config) -> dict:
    """The user fields of a port Config, as a configuration file holds
    them."""
    with open(SPARTACUS) as f:
        names = json.load(f)["config"]
    out = {}
    for k in names:
        v = getattr(config, k)
        out[k] = (v.name if isinstance(v, enum.Enum)
                  else list(v) if isinstance(v, tuple) else v)
    return out


def _meridian(driver, dtype=torch.float64) -> dict:
    """The 32 meridian columns in order with the file's own sun."""
    from scipy.io import netcdf_file
    profiles = inputs.read_profiles(driver=driver)
    call = {k: v for k, v in inputs.profiles_on(profiles, "cpu", dtype)
            .items() if k != "solar_irradiance"}
    with netcdf_file(inputs.MERIDIAN, "r", mmap=False) as f:
        call["cos_sza"] = torch.as_tensor(np.array(
            f.variables["cos_solar_zenith_angle"].data, dtype=np.float64),
            dtype=dtype)
        call["cloud"]["iseed"] = torch.as_tensor(np.array(
            f.variables["iseed"].data, dtype=np.int64))
    return call, profiles["solar_irradiance"]


def _frozen(path) -> dict:
    """The JAX package's float64 fluxes of a frozen file."""
    with np.load(path) as f:
        return {k.split("/", 1)[1]: torch.as_tensor(f[k]) for k in f.files
                if k.startswith("f64/")}


def _spartacus_3d(tmp_path):
    """The reference on the port's ``spartacus_3d`` fields (RRTMG with the
    flagship's aerosols), the 32 meridian columns and their solar
    irradiance."""
    from ecrad_torch import flagship
    fields = _fields_of(flagship.flagship_config("float64", "spartacus_3d"))
    assert fields["gas_model_sw"] == fields["gas_model_lw"] == "RRTMG"
    assert fields["sw_solver"] == fields["lw_solver"] == "SPARTACUS"
    assert fields["use_aerosols"]
    ref = step.setup(_write_config(tmp_path, fields), "cpu", torch.float64,
                     torch.float64)
    return ref, *_meridian(flagship.DRIVER_SETTINGS)


def test_route_matches_the_frozen_jax_fluxes(tmp_path):
    from ecrad_torch import flagship
    fields = _fields_of(flagship.flagship_config("float64",
                                                 "spartacus_ecckd"))
    assert fields["sw_solver"] == fields["lw_solver"] == "SPARTACUS"
    assert not fields["use_aerosols"]
    ref = step.setup(_write_config(tmp_path, fields), "cpu", torch.float64,
                     torch.float64)
    call, solar = _meridian(flagship.DRIVER_SETTINGS)
    got = step.fluxes(ref, call, solar)
    with np.load(FROZEN) as f:
        want = {k.split("/", 1)[1]: torch.as_tensor(f[k]) for k in f.files
                if k.startswith("f64/")}
    assert sorted(got) == sorted(want)
    gaps = check.field_gaps(got, want)
    assert max(gaps.values()) < 1e-6, gaps
    assert float(want["sw_dn"][:, -1].max()) > 100.0


def test_route_on_rrtmg_matches_the_frozen_jax_fluxes(tmp_path):
    """RRTMG's g-points in ecRad's SPARTACUS order, as the JAX package
    takes them."""
    ref, call, solar = _spartacus_3d(tmp_path)
    got = step.fluxes(ref, call, solar)
    want = _frozen(FROZEN_RRTMG)
    assert sorted(got) == sorted(want)
    gaps = check.field_gaps(got, want)
    assert max(gaps.values()) < 1e-6, gaps
    assert float(want["sw_dn"][:, -1].max()) > 100.0


def test_route_on_rrtmg_in_natural_order_misses_the_frozen_fluxes(
        tmp_path, monkeypatch):
    """A route that leaves RRTMG's g-points in their natural order takes
    the 3D exponential on other g-points: it fails the flagship's limits
    against the frozen fluxes."""
    ref, call, solar = _spartacus_3d(tmp_path)
    monkeypatch.setattr(ref.route, "g_order", lambda *args: None)
    gaps = check.gaps(step.fluxes(ref, call, solar), _frozen(FROZEN_RRTMG))
    with open(FLAGSHIP) as f:
        limits = json.load(f)["limits"]
    assert not check.verdict(gaps, limits), gaps
    assert gaps["sw_direct_gap_wm2"] > limits["sw_direct_gap_wm2"]
    assert gaps["lw_gap_wm2"] > limits["lw_gap_wm2"]


def _parent_solve(config, tables, op, cloud, cos_sza):
    """The route's solve before it took RRTMG's g order: both band sets
    in the gas model's own order."""
    go, frac, cl = op["go"], op["frac"], op["cl"]
    geometry = (frac, cloud["fractional_std"], cloud["overlap_param"],
                cloud["inv_cloud_effective_size"],
                cloud.get("inv_inhom_effective_size"),
                op["pressure_hl"], op["temperature_hl"])
    lw_albedo_g = op["lw_albedo_g"]
    lw = solver_spartacus_lw(
        config, op["od_lw"], op["ssa_lw"], op["g_lw_arr"], cl["od_lw"],
        cl["ssa_lw"], cl["g_lw"], tables.band_from_g_lw, *geometry,
        go.planck_hl, go.lw_emission * (1.0 - lw_albedo_g), lw_albedo_g)
    sw = solver_spartacus_sw(
        config, op["od_sw"], op["ssa_sw"], op["g_sw_arr"], cl["od_sw"],
        cl["ssa_sw"], cl["g_sw"], tables.band_from_g_sw, *geometry,
        go.incoming_sw, cos_sza, op["sw_albedo_diffuse_g"],
        op["sw_albedo_direct_g"])
    return lw, sw


def test_route_on_ecckd_is_the_parents_bit_for_bit():
    """On ecCKD the route hands the solvers what it did before it took
    RRTMG's g order, and gives the same outputs, bit for bit."""
    with open(SPARTACUS) as f:
        cfg = json.load(f)
    ref = step.setup(SPARTACUS, "cpu", torch.float64, torch.float64)
    call, solar = _meridian(cfg["driver"])
    kw = step._cast(call, torch.float64)
    op = interface.optical_properties(ref.config, ref.tables,
                                      solar_irradiance=solar, **kw)
    got = ref.route.solve(ref.config, ref.tables, op, kw["cloud"],
                          kw["cos_sza"])
    want = _parent_solve(ref.config, ref.tables, op, kw["cloud"],
                         kw["cos_sza"])
    for mine, parents in zip(got, want):
        assert mine._fields == parents._fields
        for name, a, b in zip(mine._fields, mine, parents):
            assert (a is None) == (b is None), name
            assert a is None or torch.equal(a, b), name


# RRTMG in both band sets (SOCRATES / Fu cloud optics by band)
RRTMG = dict(gas_model_sw="RRTMG", gas_model_lw="RRTMG",
             use_general_cloud_optics=False)
CHANGES = {"maximum": dict(sw_entrapment="MAXIMUM"),
           "edge_only": dict(sw_entrapment="EDGE_ONLY"),
           "non_fractal": dict(sw_entrapment="EXPLICIT_NON_FRACTAL"),
           "zero": dict(sw_entrapment="ZERO"),
           "multilayer": dict(do_3d_lw_multilayer_effects=True),
           "no_3d": dict(do_3d_effects=False),
           "rrtmg": RRTMG,
           "rrtmg_maximum": dict(RRTMG, sw_entrapment="MAXIMUM"),
           "mixed": dict(gas_model_sw="RRTMG"),
           "mixed_lw": dict(gas_model_lw="RRTMG")}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_route_matches_the_port_on_other_settings(tmp_path, change):
    with open(SPARTACUS) as f:
        cfg = json.load(f)
    cfg["config"].update(CHANGES[change])
    path = _write_config(tmp_path, cfg["config"], change)
    call, solar = _meridian(cfg["driver"])
    call = inputs.columns(call, torch.arange(0, 32, 4))
    got = program.call(program.build(path, "cpu", torch.float64), call, 8,
                       solar).fields()
    want = step.fluxes(step.setup(path, "cpu", torch.float64, torch.float64),
                       call, solar)
    gaps = check.gaps(got, want)
    assert gaps["nonfinite"] == 0
    assert gaps["lw_gap_wm2"] < 1e-6
    assert gaps["sw_direct_gap_wm2"] < 1e-9 and gaps["sw_gap_wm2"] < 1e-9
    assert gaps["fraction_gap"] < 1e-12


@pytest.mark.parametrize("change", [
    dict(do_save_spectral_flux=True), dict(do_save_gpoint_flux=True),
    dict(do_sw_delta_scaling_with_gases=True), dict(nregions=2)],
    ids=lambda c: sorted(c)[0])
def test_route_refuses_what_it_does_not_follow(tmp_path, change):
    with open(SPARTACUS) as f:
        fields = {**json.load(f)["config"], **change}
    with pytest.raises(NotImplementedError, match="SPARTACUS route"):
        step.setup(_write_config(tmp_path, fields), "cpu", torch.float64,
                   torch.float64)


def test_fields_of_names_every_user_field():
    """The configuration file names every field of the reference's Config
    but those consolidation computes."""
    from benchmark.reference import config
    computed = {"is_consolidated", "n_g_sw", "n_g_lw", "n_bands_sw",
                "n_bands_lw", "n_canopy_bands_sw", "n_canopy_bands_lw",
                "n_albedo_intervals", "n_emiss_intervals", "n_cloud_types",
                "is_homogeneous", "do_clouds", "dtype_name",
                "directory_name"}
    with open(SPARTACUS) as f:
        names = set(json.load(f)["config"])
    assert names == {f.name for f in dataclasses.fields(config.Config)} \
        - computed
