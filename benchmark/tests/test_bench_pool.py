"""The seeded pool of calls: the same seed gives the same inputs, half the
columns are in night, and no two consecutive calls are equal; the
existing mixes draw their pools as before, and a mix that puts every
column in daylight draws its suns on (0, 1]."""

import json
import os

import pytest
import torch

from benchmark import inputs, run
from benchmark.inputs import SEED_HIGH

SEED = 2**31 + 12345          # a run's seed may pass 32 signed bits


def _pool(seed, ncall=3, ncol=4096):
    profiles = inputs.profiles_on(inputs.read_profiles(), "cpu",
                                  torch.float32)
    return inputs.make_pool(profiles, seed, ncall, ncol)


def _flat(call):
    out = []
    for k in sorted(call):
        v = call[k]
        out += _flat(v) if isinstance(v, dict) else [v]
    return out


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(_flat(a), _flat(b)))


def test_same_seed_same_inputs():
    a, b = _pool(SEED), _pool(SEED)
    assert all(_equal(x, y) for x, y in zip(a, b))
    c = _pool(SEED + 1)
    assert not _equal(a[0], c[0])


def test_half_the_columns_in_night():
    for call in _pool(SEED):
        night = float((call["cos_sza"] <= 0).float().mean())
        assert 0.46 < night < 0.54
        assert float(call["cos_sza"].min()) >= -1.0
        assert float(call["cos_sza"].max()) <= 1.0


def test_no_two_consecutive_calls_equal():
    pool = _pool(SEED, ncall=4, ncol=64)
    for i in range(len(pool)):           # the window cycles: last, first
        assert not _equal(pool[i], pool[(i + 1) % len(pool)])


def test_columns_are_meridian_profiles_with_fresh_seeds():
    profiles = inputs.read_profiles()
    call = _pool(SEED, ncall=1, ncol=512)[0]
    base = torch.as_tensor(profiles["pressure_hl"], dtype=torch.float32)
    for row in call["pressure_hl"][:32]:
        assert (base == row).all(dim=1).any()
    seeds = call["cloud"]["iseed"]
    assert seeds.dtype == torch.int64
    assert int(seeds.min()) >= 1 and int(seeds.max()) < SEED_HIGH
    assert seeds.unique().numel() > 500


def test_cloudy_fraction():
    call = _pool(SEED, ncall=1, ncol=256)[0]
    f = inputs.cloudy_fraction(call, 1e-6, 1e-9)
    assert 0.0 < f < 1.0
    assert inputs.cloudy_fraction(call, 2.0, 1e-9) == 0.0


def _slim(dtype=torch.float32):
    """The profiles cut to the half-level pressure and the cloud group's
    fraction, which show each column's profile, and the group the seeds
    go to: a pool of the full profiles at 16,384 columns would hold a
    GiB."""
    profiles = inputs.read_profiles()
    return {"pressure_hl": torch.as_tensor(profiles["pressure_hl"],
                                           dtype=dtype),
            "cloud": {"fraction": torch.as_tensor(
                profiles["cloud"]["fraction"], dtype=dtype)}}


def _parent_draws(seed, ncall, ncol, nprof, dtype=torch.float32):
    """The pool's draws by the formula of the harness before mixes could
    state the sun: per call the profiles, cos_sza on [-1, 1), the seeds,
    in that order from one generator."""
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    out = []
    for _ in range(ncall):
        idx = torch.randint(0, nprof, (ncol,), generator=gen)
        cos_sza = (2.0 * torch.rand(ncol, generator=gen,
                                    dtype=torch.float64) - 1.0).to(dtype)
        iseed = torch.randint(1, SEED_HIGH, (ncol,), generator=gen,
                              dtype=torch.int64)
        out.append((idx, cos_sza, iseed))
    return out


def _mix(name):
    with open(os.path.join(run.HERE, "traffic", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("mix", ["slab16k", "rank2k"])
def test_pools_of_the_mixes_are_the_parents_bit_for_bit(mix):
    t = _mix(mix)
    assert run.mix_value(t, "sun") == "any"
    base = _slim()
    pool = inputs.make_pool(base, SEED, t["pool_calls"], t["ncol"],
                            run.mix_value(t, "sun"))
    want = _parent_draws(SEED, t["pool_calls"], t["ncol"],
                         base["pressure_hl"].shape[0])
    assert len(pool) == len(want)
    for call, (idx, cos_sza, iseed) in zip(pool, want):
        assert torch.equal(call["pressure_hl"], base["pressure_hl"][idx])
        assert torch.equal(call["cloud"]["fraction"],
                           base["cloud"]["fraction"][idx])
        assert torch.equal(call["cos_sza"], cos_sza)
        assert torch.equal(call["cloud"]["iseed"], iseed)


def test_allday_puts_every_column_in_daylight():
    """allday16k's solar zenith cosines lie in (0, 1], uniform over the
    sunlit hemisphere, from the same draws as a mix with any sun: the
    columns and seeds are the same."""
    t = _mix("allday16k")
    assert run.mix_value(t, "sun") == "day"
    base = _slim()
    day = inputs.make_pool(base, SEED, t["pool_calls"], t["ncol"], "day")
    anysun = inputs.make_pool(base, SEED, t["pool_calls"], t["ncol"])
    for d, a in zip(day, anysun):
        mu0 = d["cos_sza"]
        assert mu0.numel() == 16384 and mu0.dtype == torch.float32
        assert float(mu0.min()) > 0.0 and float(mu0.max()) <= 1.0
        assert abs(float(mu0.double().mean()) - 0.5) < 0.02
        assert torch.equal(d["pressure_hl"], a["pressure_hl"])
        assert torch.equal(d["cloud"]["iseed"], a["cloud"]["iseed"])
        assert not torch.equal(mu0, a["cos_sza"])
