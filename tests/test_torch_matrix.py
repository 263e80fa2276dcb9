"""The port's plane-form small-matrix algebra (``ecrad_torch/solvers/
matrix.py``) against the JAX package's (``ecrad_tpu/solvers/matrix.py``),
CPU, f64, on the same seeded inputs.

The port stacks a plane matrix as one ``(m, n, *batch)`` tensor where the
JAX package keeps a list of lists of planes; both do the same elementwise
arithmetic entry by entry, so they agree to roundoff.  Covered: products,
LU solves, the Pade exponential (norms that need no squaring, a few, and
a long chain, and the LW ``max_squarings`` cap), the block-triangular
SW exponential, ``_phi1`` on both sides of its series switch, and the
3x3 exchange exponential on random inputs and on the confluent-eigenvalue
input of driver/test_fast_expm.F90.
"""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import jax.numpy as jnp

from ecrad_tpu.solvers import matrix as JM
from ecrad_torch.solvers import matrix as TM

torch.set_num_threads(2)

BATCH = (4, 5)
# Same operations in the same order on both sides: f64 roundoff, relative
# to the largest entry of each result (a few entries of an exponential
# with many squarings are far below its norm).
RTOL = 1e-12


def _assert_close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _planes(A):
    """(*batch, m, n) numpy -> the port's (m, n, *batch) tensor."""
    return torch.as_tensor(np.moveaxis(np.moveaxis(A, -2, 0), -1, 1))


def _back(X):
    """The port's (m, n, *batch) -> (*batch, m, n) numpy."""
    return np.moveaxis(np.moveaxis(X.numpy(), 0, -1), 0, -1)


def _jax(A):
    return JM.planes_from(jnp.asarray(A))


def _jback(P):
    return np.asarray(JM.planes_to(P))


def _dd(rng, m, n=None):
    """A strongly diagonally dominant batch (the LU takes no pivots)."""
    A = rng.standard_normal(BATCH + (m, n or m))
    if n is None:
        A[..., np.arange(m), np.arange(m)] += np.abs(A).sum(-1) + 1.0
    return A


def _exchange_generator(rng, m, scale):
    """Exchange-structured generator: non-negative off-diagonal transfer
    rates, columns summing to minus a loss (the SPARTACUS Gammas)."""
    T = np.abs(rng.standard_normal(BATCH + (m, m))) * scale / m
    T[..., np.arange(m), np.arange(m)] = 0.0
    G = T.copy()
    G[..., np.arange(m), np.arange(m)] = -T.sum(-2) - np.abs(
        rng.standard_normal(BATCH + (m,)))
    return G


@pytest.mark.parametrize("m", [3, 6, 9])
def test_products_and_solves_match_jax(m):
    rng = np.random.default_rng(m)
    A, B = _dd(rng, m), rng.standard_normal(BATCH + (m, 3))
    x = rng.standard_normal(BATCH + (m,))
    _assert_close(_back(TM.pl_matmul(_planes(A), _planes(B))),
                  _jback(JM.pl_matmul(_jax(A), _jax(B))))
    xt = torch.as_tensor(np.moveaxis(x, -1, 0))
    xj = [jnp.asarray(x[..., i]) for i in range(m)]
    _assert_close(np.moveaxis(TM.pl_matvec(_planes(A), xt).numpy(), 0, -1),
                  np.stack([np.asarray(v) for v in JM.pl_matvec(_jax(A), xj)],
                           -1))
    _assert_close(_back(TM.pl_solve_mat(_planes(A), _planes(B))),
                  _jback(JM.pl_solve_mat(_jax(A), _jax(B))))
    _assert_close(np.moveaxis(TM.pl_solve_vec(_planes(A), xt).numpy(), 0,
                              -1),
                  np.stack([np.asarray(v)
                            for v in JM.pl_solve_vec(_jax(A), xj)], -1))
    # and it is a solve
    np.testing.assert_allclose(
        A @ _back(TM.pl_solve_mat(_planes(A), _planes(B))), B, rtol=0,
        atol=1e-12)


# generator scales: no squaring, a few, and a long chain (within the
# 13-squaring cap, where the exponential is exact)
@pytest.mark.parametrize("scale", [0.5, 40.0, 2.0e3])
@pytest.mark.parametrize("m", [3, 6, 9])
def test_pl_expm_matches_jax(m, scale):
    rng = np.random.default_rng(100 + m)
    G = _exchange_generator(rng, m, scale)
    got = _back(TM.pl_expm(_planes(G)))
    _assert_close(got, _jback(JM.pl_expm(_jax(G))))
    norm = np.abs(G).sum(-2).max()
    if scale > 1.0:
        assert norm > 2 * TM._THETA3        # really squares
    # a mechanism check against scipy, at the Pade-7 local error amplified
    # by the squarings (as tests/test_plane_algebra.py)
    ref = np.stack([sla.expm(g) for g in G.reshape((-1, m, m))]).reshape(
        G.shape)
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-12)


def test_pl_expm_max_squarings_matches_jax():
    """The LW exponential runs with max_squarings=6: the same chain cap on
    both sides, also where the norm would want more squarings."""
    rng = np.random.default_rng(7)
    G = _exchange_generator(rng, 6, 800.0)
    got = _back(TM.pl_expm(_planes(G), max_squarings=6))
    _assert_close(got, _jback(JM.pl_expm(_jax(G), max_squarings=6)))
    assert np.abs(G).sum(-2).max() > 2 ** 6 * TM._THETA3   # capped


@pytest.mark.parametrize("scale", [2.0, 40.0, 3000.0])
def test_pl_expm_blockut_matches_jax(scale):
    rng = np.random.default_rng(41)
    G = _exchange_generator(rng, 9, scale)
    G[..., 6:, :6] = 0.0                     # the SW block structure
    Gt, Gp = _planes(G), _jax(G)
    got = TM.pl_expm_blockut(Gt[:6, :6], Gt[:6, 6:], Gt[6:, 6:])
    ref = JM.pl_expm_blockut([row[:6] for row in Gp[:6]],
                             [row[6:] for row in Gp[:6]],
                             [row[6:] for row in Gp[6:]])
    for a, b in zip(got, ref):
        _assert_close(_back(a), _jback(b))
    dense = _back(TM.pl_expm(Gt))
    np.testing.assert_allclose(_back(got[0]), dense[..., :6, :6],
                               rtol=1e-10, atol=1e-13)


def test_phi1_matches_jax():
    x = np.concatenate([np.linspace(-0.2, 0.2, 41), [-30.0, -1.0, 3.0]])
    _assert_close(TM._phi1(torch.as_tensor(x)).numpy(),
                  JM._phi1(jnp.asarray(x)))


def _abcd(rng, shape):
    return [np.abs(rng.random(shape)) * s for s in (1.0, 2.0, 0.5, 3.0)]


def test_fast_expm_exchange_3_matches_jax():
    rng = np.random.default_rng(5)
    abcd = _abcd(rng, (6, 7))
    # confluent eigenvalues (tmp2 < 1e-3) and a tiny lam2 in the batch
    abcd[0][0, 0], abcd[1][0, 0], abcd[2][0, 0], abcd[3][0, 0] = \
        1e-4, 1e-4, 1e-4, 1e-4
    got = TM.pl_fast_expm_exchange_3(*map(torch.as_tensor, abcd))
    ref = JM.pl_fast_expm_exchange_3(*map(jnp.asarray, abcd))
    _assert_close(_back(got), _jback(ref))
    G = np.zeros((6, 7, 3, 3))
    a, b, c, d = abcd
    G[..., 0, 0], G[..., 0, 1] = -a, b
    G[..., 1, 0], G[..., 1, 1], G[..., 1, 2] = a, -b - c, d
    G[..., 2, 1], G[..., 2, 2] = c, -d
    ref_dense = np.stack([sla.expm(g) for g in G.reshape(-1, 3, 3)])
    np.testing.assert_allclose(_back(got).reshape(-1, 3, 3), ref_dense,
                               rtol=1e-9, atol=1e-12)


def test_fast_expm_exchange_3_repeated_eigenvalue_case():
    """driver/test_fast_expm.F90: two (near-)repeated eigenvalues."""
    a, b, c, d = 9.0408579e-02, 9.2716664e-07, 2.2503915e-03, \
        8.8152386e-02
    got = _back(TM.pl_fast_expm_exchange_3(
        *[torch.tensor([x], dtype=torch.float64) for x in (a, b, c, d)]))[0]
    ref = _jback(JM.pl_fast_expm_exchange_3(
        *[jnp.asarray([x]) for x in (a, b, c, d)]))[0]
    _assert_close(got, ref)
    G = np.array([[-a, b, 0.0], [a, -b - c, d], [0.0, c, -d]])
    np.testing.assert_allclose(got, sla.expm(G), rtol=1e-9, atol=1e-12)
