"""The port's McICA cloud generator against the JAX package (CPU, f64).

* cloud_generator_device against JAX's (its lax.scan path) for the three
  overlap schemes, on the same seeds: the same threefry draws go through
  the same cumulators and scan, so the cloudy pattern is equal, the total
  cloud cover is equal for exp-ran and max-ran (exp-exp multiplies the
  overlap parameters as exp(sum(log alpha)), where XLA's and libm's
  exp/log differ by an ulp: rtol 1e-14), and od_scaling agrees to f64
  roundoff (rtol 1e-10: the Chebyshev sampling runs exp/log/sqrt).
* generator_scan_plain against the Pallas kernel
  pallas_generator.generator_scan in interpret mode on the same planes:
  a pure select chain, so equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ecrad_tpu.config import Config as JaxConfig, Overlap as JaxOverlap
from ecrad_tpu.data import DATA_DIR
from ecrad_tpu.interface import setup_radiation as jax_setup
from ecrad_tpu.solvers import pallas_generator
from ecrad_tpu.solvers.cloud_generator import \
    cloud_generator_device as jax_generator
from ecrad_torch.config import Config, Overlap
from ecrad_torch.interface import tables_from_numpy
from ecrad_torch.solvers import cloud_generator, cuda_generator

torch.set_num_threads(2)

NCOL, NLEV, NG = 23, 31, 14
RTOL_OD_SCALING = 1e-10
RTOL_TCC_EXP_EXP = 1e-14
OVERLAPS = ["EXPONENTIAL_RANDOM", "MAXIMUM_RANDOM", "EXPONENTIAL"]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    frac = rng.uniform(0, 1, (NCOL, NLEV)) \
        * (rng.uniform(0, 1, (NCOL, NLEV)) > 0.4)
    frac[0] = 0.0                                # a cloud-free column
    # meridian-sized seeds (~2.5e8) and small ones
    iseed = np.concatenate([np.arange(1, 12),
                            250_000_000 + 7919 * np.arange(NCOL - 11)])
    return (iseed, frac, rng.uniform(0.3, 0.99, (NCOL, NLEV - 1)),
            rng.uniform(0.4, 1.5, (NCOL, NLEV)))


@pytest.fixture(scope="module")
def pdf_tables():
    """JAX tables of a configuration the port covers (band-wise cloud
    optics), for their McICA PDF sampler."""
    _, tables = jax_setup(JaxConfig(use_general_cloud_optics=False),
                          data_dir=DATA_DIR)
    return tables


@pytest.mark.parametrize("overlap,sampler",
                         [(o, "cheb") for o in OVERLAPS]
                         + [("EXPONENTIAL_RANDOM", "lut")])
def test_cloud_generator_matches_jax(pdf_tables, overlap, sampler):
    """sampler "lut": PDF tables without the Chebyshev fit, so both
    packages sample the inverse-CDF table bilinearly (sample_pdf_jnp)."""
    iseed, frac, op, fsd = _inputs()
    jcfg = JaxConfig(overlap_scheme=JaxOverlap[overlap])
    jpdf = dict(pdf_tables.pdf_sampler)
    pdf = tables_from_numpy(pdf_tables, "cpu", torch.float64).pdf_sampler
    if sampler == "lut":
        del jpdf["cheb_fit"], pdf["cheb_fit"]
    od_ref, tcc_ref = jax_generator(
        jcfg, jpdf, jnp.asarray(iseed), jnp.asarray(frac),
        jnp.asarray(op), jnp.asarray(fsd), NG)
    od, tcc = cloud_generator.cloud_generator_device(
        Config(overlap_scheme=Overlap[overlap]), pdf, torch.as_tensor(iseed),
        torch.as_tensor(frac), torch.as_tensor(op), torch.as_tensor(fsd), NG)
    if overlap == "EXPONENTIAL":
        np.testing.assert_allclose(tcc.numpy(), np.asarray(tcc_ref),
                                   rtol=RTOL_TCC_EXP_EXP, atol=0)
    else:
        np.testing.assert_array_equal(tcc.numpy(), np.asarray(tcc_ref))
    np.testing.assert_array_equal(od.numpy() > 0, np.asarray(od_ref) > 0)
    assert (od.numpy() > 0).any()
    np.testing.assert_allclose(od.numpy(), np.asarray(od_ref),
                               rtol=RTOL_OD_SCALING, atol=0)


@pytest.mark.parametrize("exp_exp", [False, True])
@pytest.mark.parametrize("ng", [NG, 112])
def test_generator_scan_plain_matches_pallas(exp_exp, ng):
    iseed, frac, op, _ = _inputs(1)
    cfg = Config(overlap_scheme=Overlap.EXPONENTIAL if exp_exp
                 else Overlap.EXPONENTIAL_RANDOM)
    rc, ri, ri2, scalars, trigger, ee, _ = cloud_generator.scan_inputs(
        cfg, torch.as_tensor(iseed), torch.as_tensor(frac),
        torch.as_tensor(op), ng)
    assert ee == exp_exp
    got = cuda_generator.generator_scan_plain(rc, ri, ri2, scalars, trigger,
                                              exp_exp)
    knl = lambda x: jnp.transpose(jnp.asarray(x.numpy()), (1, 2, 0))
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_generator.generator_scan(
            knl(rc), knl(ri), knl(ri2), knl(scalars),
            jnp.asarray(trigger.numpy().T), exp_exp)
    ref = np.transpose(np.asarray(ref), (2, 0, 1))
    assert (ref > 0).any()
    np.testing.assert_array_equal(got.numpy(), ref)


def test_generator_scan_wrapper_runs_plain_on_cpu():
    """On CPU tensors the wrapper is the plain version, and launches
    nothing."""
    iseed, frac, op, _ = _inputs(2)
    args = cloud_generator.scan_inputs(
        Config(), torch.as_tensor(iseed), torch.as_tensor(frac),
        torch.as_tensor(op), NG)[:6]
    before = cuda_generator.generator_scan.launches
    np.testing.assert_array_equal(
        cuda_generator.generator_scan(*args).numpy(),
        cuda_generator.generator_scan_plain(*args).numpy())
    assert cuda_generator.generator_scan.launches == before
