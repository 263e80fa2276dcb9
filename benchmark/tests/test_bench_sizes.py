"""The cloud effective sizes of a configuration's ``driver`` group: derived
as ecRad's offline driver derives them (against the port's own
``cloud_size.param_cloud_effective_separation_eta``), carried by the pool
like any other field, and absent, with the pool unchanged bit for bit,
where a configuration has no such group."""

import hashlib
import json

import numpy as np
import pytest
import torch

from benchmark import inputs, run

SEED = 2**31 + 12345
DRIVER = dict(cloud_separation_scale_toa=14000.0,
              cloud_separation_scale_surface=2500.0,
              cloud_separation_scale_power=3.5,
              cloud_inhom_separation_factor=0.75)
# sha256 of the pool of SEED, 2 calls of 64 columns in float32 on the CPU,
# as the harness made it before configurations had a driver group
PARENT_POOL = ("607e0029f18a77bd765cb78d727a993956f4432e322909bc9306f4f4"
               "22baddd8")
SIZES = ("inv_cloud_effective_size", "inv_inhom_effective_size")


def _digest(pool) -> str:
    h = hashlib.sha256()

    def walk(prefix, x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(prefix + "/" + k, x[k])
        else:
            h.update(prefix.encode())
            h.update(x.numpy().tobytes())
    for call in pool:
        walk("", call)
    return h.hexdigest()


def _pool(driver):
    profiles = inputs.profiles_on(inputs.read_profiles(driver=driver),
                                  "cpu", torch.float32)
    return inputs.make_pool(profiles, SEED, 2, 64)


def test_sizes_as_the_offline_driver_derives_them():
    from ecrad_torch.cloud_size import param_cloud_effective_separation_eta
    raw = inputs.read_profiles()
    got = inputs.read_profiles(driver=DRIVER)["cloud"]
    want = param_cloud_effective_separation_eta(
        raw["pressure_hl"], raw["cloud"]["fraction"],
        DRIVER["cloud_separation_scale_surface"],
        DRIVER["cloud_separation_scale_toa"],
        DRIVER["cloud_separation_scale_power"],
        DRIVER["cloud_inhom_separation_factor"])
    for name, w in zip(SIZES, want):
        assert got[name].shape == raw["cloud"]["fraction"].shape
        np.testing.assert_allclose(got[name], w, rtol=1e-12, atol=0)
        assert (got[name] > 0).all()


def test_the_spartacus_configuration_states_the_driver_settings():
    cell = run.load_cell("spartacus_ecckd.slab16k")
    assert cell.config["driver"] == DRIVER
    for name in ("mcica_rrtmg", "ecckd_mcica", "mcica_rrtmg_spectral"):
        with open(f"{run.HERE}/configs/{name}.json") as f:
            assert "driver" not in json.load(f)


def test_a_pool_without_a_driver_group_is_the_parents():
    pool = _pool(None)
    assert not set(SIZES) & set(pool[0]["cloud"])
    assert _digest(pool) == PARENT_POOL


def test_the_sizes_are_drawn_with_their_columns():
    """The same draws as without the group; each column's sizes are its
    profile's."""
    plain, sized = _pool(None), _pool(DRIVER)
    assert _digest([{k: v for k, v in c.items() if k != "cloud"}
                    for c in plain]) == _digest(
        [{k: v for k, v in c.items() if k != "cloud"} for c in sized])
    for a, b in zip(plain, sized):
        for k, v in a["cloud"].items():
            assert torch.equal(v, b["cloud"][k]), k
    profiles = inputs.read_profiles(driver=DRIVER)
    base = torch.as_tensor(profiles["pressure_hl"], dtype=torch.float32)
    call = sized[0]
    for col in range(8):
        row = int((base == call["pressure_hl"][col]).all(dim=1)
                  .nonzero()[0])
        for name in SIZES:
            want = torch.as_tensor(profiles["cloud"][name][row],
                                   dtype=torch.float32)
            assert torch.equal(call["cloud"][name][col], want)


def test_a_driver_group_with_other_keys_is_refused():
    with pytest.raises(ValueError, match="a driver group has exactly"):
        inputs.read_profiles(driver={**DRIVER, "effective_size_scaling": 1})
