"""The port's two-stream coefficients (ecrad_torch/solvers/two_stream.py)
elementwise against ecrad_tpu/solvers/two_stream.py, f64 on the CPU.

Same formulas evaluated in the same order, so the bar is f64 roundoff:
rtol 1e-12 (atol 1e-14 for entries that are zero to roundoff).  The LW
sources are differences of terms of size |coeff| = |dB|/(1.66 od), up to
~3e4 here, and XLA's exp differs from libm's by an ulp, so their
absolute error scales as 3e4 * 2e-16 * few: atol 1e-10 (against Planck
values up to 50)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ecrad_tpu.solvers import two_stream as jts
from ecrad_torch.solvers import two_stream as tts

torch.set_num_threads(2)

RTOL, ATOL = 1e-12, 1e-14
SHAPE = (7, 23, 16)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    # optical depths spanning the thin (<= 1e-3) and thick branches
    od = 10.0 ** rng.uniform(-6, 1.5, SHAPE)
    return dict(
        od=od, ssa=rng.uniform(0.0, 1.0, SHAPE),
        g=rng.uniform(0.0, 0.95, SHAPE),
        ptop=rng.uniform(0.1, 50.0, SHAPE),
        pbot=rng.uniform(0.1, 50.0, SHAPE),
        mu0=rng.uniform(1e-3, 1.0, SHAPE[:1] + (1, 1)))


ATOL_LW_SOURCE = 1e-10


def _close(got, ref, atol=ATOL):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=atol)


@pytest.mark.parametrize("fn", ["delta_eddington", "lw_ref_trans",
                                "lw_no_scattering_trans", "sw_ref_trans",
                                "sw_direct_trans"])
def test_two_stream_matches_jax(fn):
    p = _inputs()
    args = {
        "delta_eddington": ("od", "ssa", "g"),
        "lw_ref_trans": ("od", "ssa", "g", "ptop", "pbot"),
        "lw_no_scattering_trans": ("od", "ptop", "pbot"),
        "sw_ref_trans": ("mu0", "od", "ssa", "g"),
        "sw_direct_trans": ("mu0", "od"),
    }[fn]
    ref = getattr(jts, fn)(*[jnp.asarray(p[a]) for a in args])
    got = getattr(tts, fn)(*[torch.as_tensor(p[a]) for a in args])
    _close(got, ref, ATOL_LW_SOURCE if fn.startswith("lw_") else ATOL)


def test_sw_conservative_limit():
    """ssa -> 1 (k -> 0): the expm1 form stays finite and energy
    conserving, as in the JAX package."""
    p = _inputs(1)
    ssa = np.ones(SHAPE)
    ref = jts.sw_ref_trans(jnp.asarray(p["mu0"]), jnp.asarray(p["od"]),
                           jnp.asarray(ssa), jnp.asarray(p["g"]))
    got = tts.sw_ref_trans(torch.as_tensor(p["mu0"]),
                           torch.as_tensor(p["od"]), torch.as_tensor(ssa),
                           torch.as_tensor(p["g"]))
    _close(got, ref)
    r, t = got[0], got[1]
    assert torch.all(r + t <= 1.0 + 1e-12)
