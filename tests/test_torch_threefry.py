"""The port's threefry draws (ecrad_torch/solvers/threefry.py) against
jax.random, bit for bit: key(seed) -> split(4) -> uniform, as the McICA
generator draws its per-column sample (ecrad_tpu/solvers/
cloud_generator.py draw), for float32 and float64."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ecrad_tpu.data import MERIDIAN_INPUT
from ecrad_tpu.io.input import read_input
from ecrad_torch.solvers import threefry

torch.set_num_threads(2)

NLEV, NG = 137, 14


def _seeds():
    """The meridian file's real seeds (~2.5e8), the same + 997 (the LW
    stream offset of pipeline.LW_SEED_OFFSET) and a few small seeds."""
    real = read_input(MERIDIAN_INPUT).iseed.astype(np.int64)
    assert real.max() > 1e8
    return np.concatenate([real, real + 997, [0, 1, 2, 3, 12345]])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_draws_bit_equal_to_jax(dtype):
    seeds = _seeds()
    jdt = jnp.float32 if dtype == "float32" else jnp.float64
    tdt = torch.float32 if dtype == "float32" else torch.float64

    def draw(s):
        k1, k2, k3, k4 = jax.random.split(jax.random.key(s), 4)
        return (jax.random.uniform(k1, (NG,), jdt),
                jax.random.uniform(k2, (NLEV, NG), jdt),
                jax.random.uniform(k3, (NLEV, NG), jdt),
                jax.random.uniform(k4, (NLEV, NG), jdt))

    ref = jax.vmap(draw)(jnp.asarray(seeds, jnp.uint32))
    keys = threefry.split(threefry.seed_keys(torch.as_tensor(seeds)), 4)
    got = (threefry.uniform(keys[0], (NG,), tdt),
           threefry.uniform(keys[1], (NLEV, NG), tdt),
           threefry.uniform(keys[2], (NLEV, NG), tdt),
           threefry.uniform(keys[3], (NLEV, NG), tdt))
    for g, r in zip(got, ref):
        assert g.dtype == tdt
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_raw_split_keys_equal_jax():
    seeds = _seeds()
    ref = jax.vmap(lambda s: jax.random.key_data(
        jax.random.split(jax.random.key(s), 4)))(
            jnp.asarray(seeds, jnp.uint32))                # (n, 4, 2)
    keys = threefry.split(threefry.seed_keys(torch.as_tensor(seeds)), 4)
    got = np.stack([np.stack([k1.numpy(), k2.numpy()], -1)
                    for k1, k2 in keys], 1)
    np.testing.assert_array_equal(got, np.asarray(ref).astype(np.int64))
