"""Multilinear PCA and two-stage dimension reduction for aligned stacks.

Rebuild of ``MPCA`` / ``TwoSDR`` (reference
src/utils_ralib.py:436-564, used by notebook 03 before t-SNE/clustering):
the alternating row/column subspace iteration over an (N, p, q) aligned
particle stack.  The reference builds giant (p*n, q) reshapes on the host
and calls sparse ``eigs``; here every scatter matrix is a batched einsum
(matmul work on an accelerator) and the eigendecompositions are
dense ``eigh`` on the tiny (p, p)/(q, q) matrices — identical math, no
sparse solver, device-resident until the final factors.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp


def _top_eigvecs(S, k: int):
    """Top-k eigenvectors of a small symmetric matrix, descending."""
    w, v = jnp.linalg.eigh(S)  # ascending
    return w[::-1][:k], v[:, ::-1][:, :k]


def _alternate(X, p0: int, q0: int, iters: int = 30, tol: float = 1e-7):
    """Alternating projection subspace iteration shared by MPCA/TwoSDR.

    X: (n, p, q) centered stack.  Returns (At (p, p0), Bt (q, q0)).
    Stops when the captured energy gain per sample drops below ``tol``
    (the reference's ``rss`` criterion, src/utils_ralib.py:468-473).
    """
    n = X.shape[0]
    SA = jnp.einsum("npq,npr->qr", X, X)  # column scatter (q, q)
    At = None
    Bt = None
    prev_energy = None
    for _ in range(iters):
        _, Bt = _top_eigvecs(SA, q0)               # (q, q0)
        XB = jnp.einsum("npq,qb->npb", X, Bt)      # (n, p, q0)
        SB = jnp.einsum("npb,nrb->pr", XB, XB)     # row scatter (p, p)
        _, At = _top_eigvecs(SB, p0)               # (p, p0)
        XA = jnp.einsum("npq,pa->naq", X, At)      # (n, p0, q)
        SA = jnp.einsum("naq,nar->qr", XA, XA)
        # captured energy |At^T X Bt|^2 per sample
        core = jnp.einsum("pa,npq,qb->nab", At, X, Bt)
        energy = float(jnp.sum(core ** 2)) / n
        if prev_energy is not None and energy - prev_energy < tol:
            break
        prev_energy = energy
    return At, Bt


def MPCA(arr, p0: int, q0: int):
    """Multilinear PCA: project each image onto the top p0 x q0 row/column
    subspaces.

    Returns (factors (n, p0*q0), At (p, p0), Bt (q, q0), mean (p*q,)) with
    the reference's ``Y @ kron(At, Bt)`` factor ordering
    (src/utils_ralib.py:436-494): factors[i, a*q0+b] = (At^T X_i Bt)[a, b].
    """
    arr = jnp.asarray(arr, jnp.float32)
    n, p, q = arr.shape
    mY = jnp.mean(arr.reshape(n, p * q), axis=0)
    X = arr - mY.reshape(p, q)[None]
    At, Bt = _alternate(X, p0, q0)
    core = jnp.einsum("pa,npq,qb->nab", At, X, Bt)
    factors = core.reshape(n, p0 * q0)
    return (np.asarray(factors), np.asarray(At), np.asarray(Bt),
            np.asarray(mY))


def TwoSDR(arr, p0: int, q0: int, r: int):
    """Two-stage dimension reduction: MPCA to p0 x q0, then a rank-r PCA of
    the core tensors (src/utils_ralib.py:497-564).

    Returns (factors (n, r), Gt (p0*q0, r), At, Bt, mean) matching the
    reference's ``Y @ (kron(At, Bt) @ Gt)``.
    """
    arr = jnp.asarray(arr, jnp.float32)
    n, p, q = arr.shape
    mY = jnp.mean(arr.reshape(n, p * q), axis=0)
    X = arr - mY.reshape(p, q)[None]
    At, Bt = _alternate(X, p0, q0)
    core = jnp.einsum("pa,npq,qb->nab", At, X, Bt).reshape(n, p0 * q0)
    # top-r left singular vectors of Vt = core.T (p0q0, n), descending —
    # eigh of the small (p0q0, p0q0) gram matrix
    G = core.T @ core
    _, Gt = _top_eigvecs(G, r)
    factors = core @ Gt
    return (np.asarray(factors), np.asarray(Gt), np.asarray(At),
            np.asarray(Bt), np.asarray(mY))
