"""The draws and the scan of the port's McICA generator kernel against the
JAX package (CPU).

* threefry.uniform_at, the per-element formula of the draws of
  ecrad_torch/csrc/generator_scan.cu (key(seed) -> split(4) -> the hash of
  (0, l * ng + g) -> the mantissa of [1, 2), minus 1), against
  jax.random.uniform(k, (nlev, ng)) over every (l, g), bit for bit, in
  float32 and float64.
* generator_cdf_plain (the draws, the trigger scaled by the total cloud
  cover, the level scan) against the Pallas kernel
  pallas_generator.generator_scan in interpret mode fed JAX's own draws
  (cloud_generator.py draw) on the same scalars: equal, bit for bit.
* the wrapper on CPU tensors is its plain version and launches nothing; on
  another device it raises and does not fall back.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ecrad_tpu.data import MERIDIAN_INPUT
from ecrad_tpu.io.input import read_input
from ecrad_tpu.solvers import pallas_generator
from ecrad_torch.config import Config, Overlap
from ecrad_torch.data import DATA_DIR
from ecrad_torch.interface import setup_radiation
from ecrad_torch.solvers import cloud_generator, cuda_generator, threefry

torch.set_num_threads(2)

NLEV, NG = 137, 14
LW_SEED_OFFSET = 997          # ecrad_torch.pipeline.LW_SEED_OFFSET
NCOL_SCAN, NLEV_SCAN = 19, 23
OVERLAPS = ["EXPONENTIAL_RANDOM", "MAXIMUM_RANDOM", "EXPONENTIAL"]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "float64": (torch.float64, jnp.float64)}


def _seeds(which):
    """The meridian file's seeds (~2.5e8), the same + 997 (the LW stream),
    or seeds at and near the ends of the uint32 range."""
    real = read_input(MERIDIAN_INPUT).iseed.astype(np.int64)
    assert real.max() > 1e8
    return {"meridian": real, "meridian_lw": real + LW_SEED_OFFSET,
            "uint32_ends": np.array([2**32 - 1, 2**32 - 2, 2**32 - 997,
                                     2**31, 2**31 - 1, 2**31 + 1, 0, 1])
            }[which]


@pytest.mark.parametrize("which", ["meridian", "meridian_lw", "uint32_ends"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_uniform_at_bit_equal_to_jax(dtype, which):
    """Each of the four split keys: the trigger's key at counter g over
    (ng,), the planes' keys at counter l * ng + g over (nlev, ng)."""
    tdt, jdt = DTYPES[dtype]
    seeds = _seeds(which)

    def draw(s):
        ks = jax.random.split(jax.random.key(s), 4)
        return (jax.random.uniform(ks[0], (NG,), jdt),
                *(jax.random.uniform(k, (NLEV, NG), jdt) for k in ks[1:]))

    ref = jax.vmap(draw)(jnp.asarray(seeds, jnp.uint32))
    keys = threefry.split(threefry.seed_keys(torch.as_tensor(seeds)), 4)
    lev = torch.arange(NLEV, dtype=torch.int64)[:, None]
    g = torch.arange(NG, dtype=torch.int64)
    for i, ((k1, k2), r) in enumerate(zip(keys, ref)):
        counter = g if i == 0 else lev * NG + g
        expand = (slice(None),) + (None,) * counter.dim()
        got = threefry.uniform_at((k1[expand], k2[expand]), counter[None],
                                  tdt)
        assert got.dtype == tdt and got.shape == r.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(r))


def _scan_case(overlap, dtype, seed=3):
    """Seeds (meridian, + 997 and the uint32 ends), the port's packed
    scalars and total cloud cover, and the exp-exp flag, for a random
    cloud-fraction profile."""
    rng = np.random.default_rng(seed)
    frac = rng.uniform(0, 1, (NCOL_SCAN, NLEV_SCAN)) \
        * (rng.uniform(0, 1, (NCOL_SCAN, NLEV_SCAN)) > 0.4)
    frac[0] = 0.0                                # a cloud-free column
    op = rng.uniform(0.3, 0.99, (NCOL_SCAN, NLEV_SCAN - 1))
    seeds = np.concatenate([_seeds("uint32_ends"), _seeds("meridian")[:6],
                            _seeds("meridian_lw")[:5]])
    assert seeds.size == NCOL_SCAN
    scalars, exp_exp, tcc = cloud_generator.scan_scalars(
        Config(overlap_scheme=Overlap[overlap]),
        torch.as_tensor(frac, dtype=dtype), torch.as_tensor(op, dtype=dtype))
    assert exp_exp == (overlap == "EXPONENTIAL")
    return seeds, scalars, tcc, exp_exp


def _jax_cdf(seeds, scalars, tcc, ng, exp_exp, jdt):
    """The JAX package's CDF: its own draws (cloud_generator.py draw), the
    trigger times the total cloud cover, the Pallas level scan in
    interpret mode, in its (nlev, ng, ncol) layout."""
    nlev = scalars.shape[1]

    def draw(s):
        k1, k2, k3, k4 = jax.random.split(jax.random.key(s), 4)
        return (jax.random.uniform(k1, (ng,), jdt),
                jax.random.uniform(k2, (nlev, ng), jdt),
                jax.random.uniform(k3, (nlev, ng), jdt),
                jax.random.uniform(k4, (nlev, ng), jdt))

    trig, rc, ri, ri2 = jax.vmap(draw, out_axes=(1, 2, 2, 2))(
        jnp.asarray(seeds, jnp.uint32))
    trigger = trig * jnp.asarray(tcc.numpy())[None, :]
    knl = jnp.transpose(jnp.asarray(scalars.numpy()), (1, 2, 0))
    with pltpu.force_tpu_interpret_mode():
        cdf = pallas_generator.generator_scan(rc, ri, ri2, knl, trigger,
                                              exp_exp)
    return np.transpose(np.asarray(cdf), (2, 0, 1))


@pytest.mark.parametrize("ng", [1, 14, 32, 112])
@pytest.mark.parametrize("overlap", OVERLAPS)
def test_draw_scan_plain_matches_pallas_fed_jax_draws(overlap, ng):
    seeds, scalars, tcc, exp_exp = _scan_case(overlap, torch.float64)
    got = cuda_generator.generator_cdf_plain(
        torch.as_tensor(seeds), scalars, tcc, ng, exp_exp)
    ref = _jax_cdf(seeds, scalars, tcc, ng, exp_exp, jnp.float64)
    assert (ref > 0).any() and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("overlap", OVERLAPS)
def test_draw_scan_plain_matches_pallas_float32(overlap):
    """The same in float32 at ecCKD's 32 g-points: JAX's float32 draws."""
    seeds, scalars, tcc, exp_exp = _scan_case(overlap, torch.float32, 4)
    got = cuda_generator.generator_cdf_plain(
        torch.as_tensor(seeds), scalars, tcc, 32, exp_exp)
    ref = _jax_cdf(seeds, scalars, tcc, 32, exp_exp, jnp.float32)
    assert got.dtype == torch.float32 and (ref > 0).any()
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.fixture(scope="module")
def fit():
    """The port's Chebyshev fit of the McICA PDF table (setup_radiation)."""
    _, tables = setup_radiation(Config(), "cpu", torch.float64,
                                data_dir=DATA_DIR)
    return tables.pdf_sampler["cheb_fit"]


def test_draw_scan_wrapper_runs_plain_on_cpu(fit):
    """On CPU tensors the wrapper is the plain version and launches
    nothing; the plain version's CDF is the scan's fed draw_planes."""
    seeds, scalars, tcc, exp_exp = _scan_case("EXPONENTIAL_RANDOM",
                                               torch.float64, 5)
    iseed = torch.as_tensor(seeds)
    rng = np.random.default_rng(5)
    fsd = torch.as_tensor(rng.uniform(0.4, 1.5, scalars.shape[:2]))
    thr = Config().cloud_fraction_threshold
    before = cuda_generator.generator_draw_scan.launches
    got = cuda_generator.generator_draw_scan(iseed, scalars, tcc, NG,
                                             exp_exp, fsd, fit, thr)
    np.testing.assert_array_equal(
        got.numpy(), cuda_generator.generator_draw_scan_plain(
            iseed, scalars, tcc, NG, exp_exp, fsd, fit, thr).numpy())
    assert (got.numpy() > 0).any()
    trig, rc, ri, ri2 = cuda_generator.draw_planes(iseed, NLEV_SCAN, NG,
                                                   torch.float64)
    np.testing.assert_array_equal(
        cuda_generator.generator_cdf_plain(iseed, scalars, tcc, NG,
                                           exp_exp).numpy(),
        cuda_generator.generator_scan_plain(
            rc, ri, ri2, scalars, trig * tcc[:, None], exp_exp).numpy())
    assert cuda_generator.generator_draw_scan.launches == before


def test_draw_scan_wrapper_raises_off_the_cpu(fit):
    """Tensors on a device other than the CPU go to the kernel: a device
    it does not take raises, with no fallback to the plain version."""
    scalars = torch.zeros((3, 5, 8), device="meta")
    tcc = torch.zeros(3, device="meta")
    fsd = torch.zeros((3, 5), device="meta")
    before = cuda_generator.generator_draw_scan.launches
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_generator.generator_draw_scan(
            torch.zeros(3, dtype=torch.int64, device="meta"), scalars, tcc,
            4, False, fsd, fit, Config().cloud_fraction_threshold)
    assert cuda_generator.generator_draw_scan.launches == before


def test_seed_words_are_the_low_32_bits():
    """The seeds the kernel reads: int32 words holding the uint32 seeds
    of seed_keys, for seeds at and above 2^31 too."""
    seeds = torch.as_tensor(np.concatenate([_seeds("uint32_ends"),
                                            [2**32 + 5, -1]]))
    words = threefry.seed_words(seeds)
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(
        words.numpy().view(np.uint32).astype(np.int64),
        threefry.seed_keys(seeds)[1].numpy())
