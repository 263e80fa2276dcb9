"""Small-matrix algebra in plane form for the reference's SPARTACUS
solvers (radiation/radiation_matrix.F90: solve_vec L737, solve_mat L769,
expm L805, fast_expm_exchange_3 L952).

A plane matrix is a tensor ``(m, n, *batch)``: the small matrix dims lead
and every entry ``A[i, j]`` is a whole ``batch`` plane.  Every function
is elementwise arithmetic entry by entry, so it runs in any floating
dtype (bfloat16 included, where ``torch.linalg`` has no solver) and on
any device.  Batch dims broadcast between operands.
"""

from __future__ import annotations

import torch

# Pade-7 coefficients (radiation_matrix.F90:813-818)
_THETA3 = 3.925724783138660
_C = (17297280.0, 8648640.0, 1995840.0, 277200.0, 25200.0, 1512.0, 56.0,
      1.0)
# Hard cap of the masked squaring chain: exact for 1-norms up to
# 2^13 * theta3 ~ 3.2e4, above anything the solvers produce (od capped by
# max_cloud_od, transfer rates by max_3d_transfer_rate).
_STATIC_SQUARINGS = 13


def _eye(m, like):
    """(m, m, 1, ...) identity broadcasting against ``like``'s batch."""
    eye = torch.eye(m, dtype=like.dtype, device=like.device)
    return eye.reshape((m, m) + (1,) * (like.dim() - 2))


def pl_matmul(A, B):
    """C[i, j] = sum_q A[i, q] B[q, j], summed in q order."""
    C = A[:, 0, None] * B[None, 0]
    for q in range(1, A.shape[1]):
        C = C + A[:, q, None] * B[None, q]
    return C


def pl_matvec(A, x):
    """y[i] = sum_q A[i, q] x[q], summed in q order; x (k, *batch)."""
    y = A[:, 0] * x[0]
    for q in range(1, A.shape[1]):
        y = y + A[:, q] * x[q]
    return y


def _pl_lu(A):
    """LU without pivoting (radiation_matrix.F90:639-674), packed."""
    m = A.shape[0]
    LU = A.clone()
    for k in range(m - 1):
        inv_diag = 1.0 / LU[k, k]
        LU[k + 1:, k] = LU[k + 1:, k] * inv_diag
        LU[k + 1:, k + 1:] = LU[k + 1:, k + 1:] \
            - LU[k + 1:, k, None] * LU[k, None, k + 1:]
    return LU


def _lu_sub(LU, b):
    """Forward/back substitution (radiation_matrix.F90:681-706); b is
    (m, ...) with the batch dims last, so one call solves every column of
    a right-hand-side matrix."""
    m = LU.shape[0]
    y = list(b)
    for i in range(1, m):
        for j in range(i):
            y[i] = y[i] - LU[i, j] * y[j]
    x = [None] * m
    x[m - 1] = y[m - 1] / LU[m - 1, m - 1]
    for i in range(m - 2, -1, -1):
        acc = y[i]
        for j in range(i + 1, m):
            acc = acc - LU[i, j] * x[j]
        x[i] = acc / LU[i, i]
    return torch.stack(x)


def pl_solve_vec(A, b):
    """Solve A x = b; A (m, m, *batch), b (m, *batch)."""
    return _lu_sub(_pl_lu(A), b)


def pl_solve_mat(A, B):
    """Solve A X = B; A (m, m, *batch), B (m, n, *batch)."""
    return _lu_sub(_pl_lu(A), B)


def _scaling(colsums, max_squarings):
    """Squarings and the 2^-expo scale of Pade scaling-and-squaring from
    the column sums (radiation_matrix.F90:819-830): expo = ceil(log2(norm /
    theta3)), clipped to [0, max_squarings]."""
    norm = colsums[0]
    for cs in colsums[1:]:
        norm = torch.maximum(norm, cs)
    frac, expo = torch.frexp(torch.clamp(norm / _THETA3, min=1e-300))
    expo = torch.where(frac == 0.5, expo - 1, expo)
    expo = torch.clamp(expo, 0, max_squarings)
    return expo, torch.ldexp(torch.ones_like(norm), -expo)


def _abs_colsums(A):
    """(n, *batch): sum over rows of |A|, in row order."""
    cs = torch.abs(A[0])
    for i in range(1, A.shape[0]):
        cs = cs + torch.abs(A[i])
    return cs


def pl_expm(A, max_squarings=_STATIC_SQUARINGS):
    """Matrix exponential by Pade-7 scaling-and-squaring
    (radiation_matrix.F90:805-903): each matrix of the batch squares its
    own ``expo`` times; the loop runs to the batch's largest.  Exact for
    1-norms up to 2^max_squarings * theta3."""
    m = A.shape[0]
    expo, s = _scaling(list(_abs_colsums(A)), max_squarings)
    eye = _eye(m, A)
    As = A * s
    A2 = pl_matmul(As, As)
    P = A2
    U = _C[3] * A2 + _C[1] * eye
    V = _C[2] * A2 + _C[0] * eye
    for cu, cv in ((_C[5], _C[4]), (_C[7], _C[6])):
        P = pl_matmul(P, A2)
        U = U + cu * P
        V = V + cv * P
    U = pl_matmul(As, U)
    R = pl_solve_mat(V - U, 2.0 * U) + eye
    for it in range(int(expo.max()) if expo.numel() else 0):
        R = torch.where(it < expo, pl_matmul(R, R), R)
    return R


def _but_matmul(A, B):
    """Block-upper-triangular product of (A11, A13, A33) triples: A11
    (p, p), A13 (p, q), A33 (q, q), lower-left block structurally zero."""
    A11, A13, A33 = A
    B11, B13, B33 = B
    return (pl_matmul(A11, B11),
            pl_matmul(A11, B13) + pl_matmul(A13, B33),
            pl_matmul(A33, B33))


def _but_solve(W, B):
    """Solve W X = B blockwise: X11 = W11^-1 B11; X33 = W33^-1 B33;
    X13 = W11^-1 (B13 - W13 X33)."""
    W11, W13, W33 = W
    B11, B13, B33 = B
    X11 = pl_solve_mat(W11, B11)
    X33 = pl_solve_mat(W33, B33)
    X13 = pl_solve_mat(W11, B13 - pl_matmul(W13, X33))
    return X11, X13, X33


def pl_expm_blockut(A11, A13, A33):
    """Exponential of the block-upper-triangular [[A11, A13], [0, A33]]
    (the SPARTACUS SW Gamma: diffuse 6x6, direct 3x3, their coupling;
    radiation_spartacus_sw.F90:327-380), every product and solve blockwise
    as in :func:`pl_expm`.  Returns (E11, E13, E33)."""
    p, q = A11.shape[0], A33.shape[0]
    colsums = list(_abs_colsums(A11)) \
        + list(_abs_colsums(A13) + _abs_colsums(A33))
    expo, s = _scaling(colsums, _STATIC_SQUARINGS)
    I_p, I_q = _eye(p, A11), _eye(q, A33)
    As = (A11 * s, A13 * s, A33 * s)
    A2 = _but_matmul(As, As)

    def poly(c2, c0):
        return (c2 * A2[0] + c0 * I_p, c2 * A2[1], c2 * A2[2] + c0 * I_q)

    P, U, V = A2, poly(_C[3], _C[1]), poly(_C[2], _C[0])
    for cu, cv in ((_C[5], _C[4]), (_C[7], _C[6])):
        P = _but_matmul(P, A2)
        U = tuple(u + cu * x for u, x in zip(U, P))
        V = tuple(v + cv * x for v, x in zip(V, P))
    U = _but_matmul(As, U)
    R = _but_solve(tuple(v - u for u, v in zip(U, V)),
                   tuple(2.0 * u for u in U))
    R = (R[0] + I_p, R[1], R[2] + I_q)
    for it in range(int(expo.max()) if expo.numel() else 0):
        keep = it < expo
        R = tuple(torch.where(keep, x, r)
                  for x, r in zip(_but_matmul(R, R), R))
    return R


def _phi1(x):
    """(e^x - 1)/x with the x -> 0 limit: series below |x| < 0.1, the exp
    form above."""
    small = torch.abs(x) < 0.1
    safe = torch.where(small, torch.ones_like(x), x)
    series = 1.0 + x / 2.0 * (1.0 + x / 3.0 * (
        1.0 + x / 4.0 * (1.0 + x / 5.0 * (1.0 + x / 6.0))))
    return torch.where(small, series, (torch.exp(safe) - 1.0) / safe)


def pl_fast_expm_exchange_3(a, b, c, d):
    """expm of the conservative-exchange generator (-a b 0; a -b-c d;
    0 c -d), a..d >= 0 planes, by Putzer's algorithm on the eigenvalues
    (0, lam1, lam2) with stable divided differences (sinh(h)/h from exp,
    series where the eigenvalues are confluent).  Returns (3, 3,
    *batch)."""
    tmp1 = 0.5 * (a + b + c + d)
    disc = torch.clamp(tmp1 * tmp1 - (a * c + a * d + b * d), min=0.0)
    tmp2 = torch.sqrt(disc)
    lam1 = -tmp1 + tmp2
    lam2 = -tmp1 - tmp2

    small = tmp2 < 1e-3
    h2 = tmp2 * tmp2
    one = torch.ones_like(tmp2)
    ex = torch.exp(torch.where(small, one, tmp2))
    sinh_over = torch.where(
        small, 1.0 + h2 / 6.0 * (1.0 + h2 / 20.0),
        (ex - 1.0 / ex) * 0.5 / torch.where(small, one, tmp2))
    dd1_12 = torch.exp(-tmp1) * sinh_over

    tiny2 = torch.abs(lam2) < 1e-3
    lam2_safe = torch.where(tiny2, one, lam2)
    dd2_exact = (dd1_12 - _phi1(lam1)) / lam2_safe
    s1 = lam1 + lam2
    dd2_series = (0.5 + s1 / 6.0
                  + (lam1 * lam1 + lam1 * lam2 + lam2 * lam2) / 24.0)
    dd2 = torch.where(tiny2, dd2_series, dd2_exact)

    zero = torch.zeros_like(a)
    M = torch.stack([torch.stack([-a, b, zero]),
                     torch.stack([a, -b - c, d]),
                     torch.stack([zero, c, -d])])
    eye = _eye(3, M)
    MM = pl_matmul(M, M - lam1 * eye)
    return eye + _phi1(lam1) * M + dd2 * MM
