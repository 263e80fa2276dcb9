"""The reference's Tripleclouds route on its own: against the port's CPU
path (the fused kernels' plain versions, and the scan form where the
kernels do not go) in float64 on the fields of ``tripleclouds_ecckd.json``
and on other settings; on the fields of the port's ``tripleclouds_ecckd``
(no aerosols) over the 32 meridian columns, against the JAX package's
frozen float64 fluxes of that configuration
(``tests/data/torch_tripleclouds_ecckd_meridian32.npz``); refusing what it
does not follow; and in a run of the cell at a small size, where the
program with homogeneous clouds in place of Tripleclouds' two comes out
not correct, the bfloat16 control fails the limits and a traced run
reads the region set-up's span."""

import json
import os
import time

import numpy as np
import pytest
import torch

from benchmark import calibrate, check, inputs, program, run
from benchmark.reference import step
from bench_small import SMALL
from test_bench_spartacus import _fields_of, _meridian, _write_config

FROZEN = os.path.join(run.ROOT, "tests", "data",
                      "torch_tripleclouds_ecckd_meridian32.npz")
TRIPLECLOUDS = os.path.join(run.HERE, "configs", "tripleclouds_ecckd.json")
CELL = "tripleclouds_ecckd.slab16k"


def _config(change: dict) -> dict:
    with open(TRIPLECLOUDS) as f:
        fields = json.load(f)["config"]
    return {**fields, **change}


def _gaps(path, ncol, seed):
    """The gaps of the port's CPU path against the route at float64 on
    ``ncol`` columns of a pool drawn from ``seed``."""
    profiles = inputs.read_profiles()
    solar = profiles["solar_irradiance"]
    pool = inputs.make_pool(inputs.profiles_on(profiles, "cpu",
                                               torch.float64),
                            seed, 1, ncol)
    got = program.call(program.build(path, "cpu", torch.float64), pool[0],
                       ncol, solar).fields()
    want = step.fluxes(step.setup(path, "cpu", torch.float64,
                                  torch.float64), pool[0], solar)
    return check.gaps(got, want), want


def test_route_matches_the_port_in_float64():
    gaps, want = _gaps(TRIPLECLOUDS, 32, 2**31 + 99)
    assert gaps == dict(gaps, nonfinite=0)
    for k in ("lw_gap_wm2", "sw_direct_gap_wm2", "sw_gap_wm2"):
        assert gaps[k] < 1e-9, k
    assert gaps["fraction_gap"] < 1e-12
    # the columns differ, clouds and sun both
    assert float(want["sw_dn"][:, -1].std()) > 1.0
    assert 0.1 < float(want["cloud_cover_sw"].mean()) < 1.0
    # Tripleclouds sets the cloud cover of night columns too
    assert torch.equal(want["cloud_cover_sw"], want["cloud_cover_lw"])


# settings the port takes elsewhere: LW clouds absorbing only (its scan
# form), the lognormal PDF's regions, no LW derivatives, RRTMG's g-points
# and band-wise cloud optics
CHANGES = {
    "lw_no_cloud_scattering": dict(do_lw_cloud_scattering=False),
    "lognormal": dict(cloud_pdf_shape="LOGNORMAL"),
    "no_derivatives": dict(do_lw_derivatives=False),
    "rrtmg": dict(gas_model_sw="RRTMG", gas_model_lw="RRTMG",
                  use_general_cloud_optics=False,
                  do_cloud_aerosol_per_sw_g_point=False,
                  do_cloud_aerosol_per_lw_g_point=False)}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_route_matches_the_port_on_other_settings(tmp_path, change):
    path = _write_config(tmp_path, _config(CHANGES[change]), change)
    gaps, _ = _gaps(path, 8, 2**31 + 7)
    assert gaps["nonfinite"] == 0
    for k in ("lw_gap_wm2", "sw_direct_gap_wm2", "sw_gap_wm2"):
        assert gaps[k] < 1e-9, k
    assert gaps["fraction_gap"] < 1e-12


def test_route_matches_the_frozen_jax_fluxes(tmp_path):
    from ecrad_torch import flagship
    fields = _fields_of(flagship.flagship_config("float64",
                                                 "tripleclouds_ecckd"))
    assert fields["sw_solver"] == fields["lw_solver"] == "TRIPLECLOUDS"
    assert not fields["use_aerosols"]
    ref = step.setup(_write_config(tmp_path, fields), "cpu", torch.float64,
                     torch.float64)
    call, solar = _meridian(None)
    got = step.fluxes(ref, call, solar)
    with np.load(FROZEN) as f:
        want = {k.split("/", 1)[1]: torch.as_tensor(f[k]) for k in f.files
                if k.startswith("f64/")}
    assert sorted(got) == sorted(want)
    gaps = check.field_gaps(got, want)
    # the JAX package sums the g-points and the SW adding in another
    # order: 1.7e-10 W m-2 at most over the SW diffuse fluxes
    assert max(gaps.values()) < 1e-9, gaps
    assert float(want["sw_dn"][:, -1].max()) > 100.0


@pytest.mark.parametrize("change", [
    dict(nregions=2), dict(do_save_spectral_flux=True),
    dict(do_save_gpoint_flux=True),
    dict(do_sw_delta_scaling_with_gases=True),
    dict(do_lw_aerosol_scattering=True)], ids=lambda c: sorted(c)[0])
def test_route_refuses_what_it_does_not_follow(tmp_path, change):
    with pytest.raises(NotImplementedError, match="Tripleclouds route"):
        step.setup(_write_config(tmp_path, _config(change)), "cpu",
                   torch.float64, torch.float64)


def _cell():
    cell = run.load_cell(CELL)
    cell.traffic.update(SMALL)
    return cell


def _homogeneous(call):
    """The program with one cloudy region's optical depth: the fractional
    std zero, so that both cloudy regions take the layer's mean od."""
    def broken(prog, inputs, block, solar):
        cloud = dict(inputs["cloud"])
        cloud["fractional_std"] = torch.zeros_like(cloud["fractional_std"])
        return call(prog, dict(inputs, cloud=cloud), block, solar)
    return broken


@pytest.mark.parametrize("fault", (None, _homogeneous),
                         ids=("sound", "homogeneous"))
def test_homogeneous_clouds_are_not_correct(monkeypatch, fault):
    if fault is not None:
        monkeypatch.setattr(program, "call", fault(program.call))
    out = run.run_cell(_cell(), 2**31 + 17, 0.5, False, "cpu", time.time())
    assert out["correct"] is (fault is None), out["checked"]


def test_control_fails_and_program_passes():
    cell = _cell()
    rows = list(calibrate.readings(cell, [2**31 + 5], 1, "cpu"))
    limits = cell.config["limits"]
    prog = [r for r in rows if r["kind"] == "program"]
    control = [r for r in rows if r["kind"] == "bf16"]
    assert len(prog) == len(control) == SMALL["check_calls"]
    assert all(check.verdict(r, limits) for r in prog)
    assert not any(check.verdict(r, limits) for r in control)


def test_traced_run_reads_the_regions():
    """A traced run reads the solvers' layer through the wraps of the
    Tripleclouds route and the region set-up's span, opened once a band
    set; no metric of the McICA generator."""
    cell = _cell()
    out = run.run_cell(cell, 2**31 + 29, 0.5, True, "cpu", time.time())
    assert out["correct"] is True
    metrics = out["metrics"]
    assert metrics["regions_per_block"]["value"] == 2.0
    assert metrics["regions_dev_ms_per_kcol"]["value"] is not None
    assert metrics["solvers_host_ms_per_kcol"]["value"] > 0
    assert not any(k.startswith(("generator", "cumulator", "sampler"))
                   for k in metrics)
