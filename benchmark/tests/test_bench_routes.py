"""The reference's solver routes, found by name under
``benchmark/reference/routes/``: a route written as a new file is found and
dispatched to with no other change, a Config whose solvers have no route
raises naming the file looked for, and the McICA route gives the fields
the reference gave before the routes were split out, bit for bit (frozen
in ``data/reference_mcica_32.npz``)."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import inputs, run
from benchmark.reference import routes, step

HERE = os.path.dirname(os.path.abspath(__file__))
FROZEN = os.path.join(HERE, "data", "reference_mcica_32.npz")
FROZEN_CONFIGS = ("mcica_rrtmg", "ecckd_mcica")
NCOL = 32


def frozen_inputs() -> dict:
    """One call of the 32 meridian columns in order, in float64 on the CPU,
    drawn from no generator: the sun from below the horizon to overhead,
    and fixed McICA seeds."""
    profiles = inputs.read_profiles()
    call = {k: v for k, v in inputs.profiles_on(
        profiles, "cpu", torch.float64).items() if k != "solar_irradiance"}
    call["cos_sza"] = torch.linspace(-0.9, 1.0, NCOL, dtype=torch.float64)
    call["cloud"]["iseed"] = (torch.arange(1, NCOL + 1, dtype=torch.int64)
                              * 104729 * 7919) % (2**31 - 1)
    return call


def reference_fields(name: str) -> dict:
    path = os.path.join(run.HERE, "configs", f"{name}.json")
    ref = step.setup(path, "cpu", torch.float64, torch.float64)
    solar = inputs.read_profiles()["solar_irradiance"]
    return step.fluxes(ref, frozen_inputs(), solar)


@pytest.mark.parametrize("name", FROZEN_CONFIGS)
def test_mcica_route_matches_the_frozen_fields(name):
    got = reference_fields(name)
    with np.load(FROZEN) as f:
        want = {k.split("/", 1)[1]: f[k] for k in f.files
                if k.startswith(name + "/")}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), v), k


def _config_file(tmp_path, solver: str) -> str:
    with open(os.path.join(run.HERE, "configs", "mcica_rrtmg.json")) as f:
        cfg = json.load(f)
    cfg["config"].update(sw_solver=solver, lw_solver=solver)
    path = tmp_path / f"{solver.lower()}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


ROUTE = '''
"""A route that hands back its inputs' clear-sky optical depths."""
from benchmark.reference.solvers.outputs import LwFluxes, SwFluxes

NEEDS_SAMPLE = False


def check_supported(config):
    pass


def solve(config, tables, op, cloud, cos_sza):
    lw = op["od_lw"].sum(-1)
    sw = op["od_sw"].sum(-1)
    g = op["od_lw"][:, 0]
    s = op["od_sw"][:, 0]
    cover = op["frac"].amax(-1)
    return (LwFluxes(lw, lw, lw, lw, g, g, g, g, cover),
            SwFluxes(sw, sw, sw, sw, sw, sw, s, s, s, s, s, s, cover))
'''


def test_a_new_route_is_found_by_name_and_dispatched_to(tmp_path,
                                                        monkeypatch):
    """A route module written at test time, named for the Config's
    solvers, is found and its fields come back from ``step.fluxes``; a
    route that needs no McICA sample gets none drawn."""
    (tmp_path / "tripleclouds.py").write_text(ROUTE)
    monkeypatch.setattr(routes, "DIRECTORY", str(tmp_path))

    def no_sample(*args):
        raise AssertionError("a route without the McICA sample drew it")
    monkeypatch.setattr(step, "sample", no_sample)
    ref = step.setup(_config_file(tmp_path, "TRIPLECLOUDS"), "cpu",
                     torch.float64, torch.float64)
    assert ref.route.__file__ == str(tmp_path / "tripleclouds.py")
    assert ref.pdf_sample is None
    call = {k: v[:4] if torch.is_tensor(v) else
            {kk: vv[:4] for kk, vv in v.items()}
            for k, v in frozen_inputs().items()}
    got = step.fluxes(ref, call, 1361.0)
    assert torch.equal(got["lw_up"], got["lw_dn"])
    assert float(got["lw_up"].min()) > 0.0
    assert torch.equal(got["sw_up"], got["sw_dn_direct_clear"])


def test_solvers_without_a_route_raise_naming_the_file(tmp_path):
    with pytest.raises(NotImplementedError,
                       match=r"routes/homogeneous\.py"):
        step.setup(_config_file(tmp_path, "HOMOGENEOUS"), "cpu",
                   torch.float64, torch.float64)
    config = step.config_from_fields(
        dict(sw_solver="TRIPLECLOUDS", lw_solver="MCICA"), "float64")
    assert routes.name(config) == "tripleclouds_mcica"
