"""The seeded pool of calls: the same seed gives the same inputs, half the
columns are in night, and no two consecutive calls are equal."""

import torch

from benchmark import inputs
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
