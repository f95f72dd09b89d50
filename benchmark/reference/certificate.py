"""The SDP certificate of a rank-r point, worked out again (numpy, scipy).

At a critical point Y of the rank-r relaxation the Lagrange multipliers are
Λ_i = sym((QY)_i Y_iᵀ) for a pose's d × d block and λ_k = (QY)_k · Y_k for
a bearing; translations carry none. S = Q − Λ, and SY is the Riemannian
gradient. Y certifies the SDP's optimum when S + ηI is positive definite,
with η = clamp(rel_eta · f, min_eta, max_eta) (CORA's tolerance).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from benchmark.reference.problem import layout
from benchmark.reference.pyfg import Graph


def certificate_matrix(g: Graph, Q: sp.spmatrix, Y: np.ndarray) -> sp.csc_matrix:
    d, n, m, N = g.d, g.n, g.m, g.size
    sph, _ = layout(g)
    G = Q @ Y
    P = np.einsum("nir,njr->nij", G[:sph].reshape(n, d, -1),
                  Y[:sph].reshape(n, d, -1))
    lam = 0.5 * (P + P.transpose(0, 2, 1))
    i = (np.arange(n)[:, None, None] * d + np.arange(d)[None, :, None]
         + np.zeros((1, 1, d), np.int64))
    j = i.transpose(0, 2, 1)
    rows = np.concatenate([i.ravel(), sph + np.arange(m)])
    cols = np.concatenate([j.ravel(), sph + np.arange(m)])
    vals = np.concatenate([lam.ravel(),
                           np.einsum("kr,kr->k", Y[sph:sph + m], G[sph:sph + m])])
    return (Q - sp.csr_matrix((vals, (rows, cols)), shape=(N, N))).tocsc()


def eta(f: float, cert: dict) -> float:
    return float(np.clip(cert["rel_eta"] * f, cert["min_eta"], cert["max_eta"]))


def nonpositive_pivots(S: sp.csc_matrix, shift: float) -> int:
    """Pivots ≤ 0 of an LDLᵀ of S + shift·I (sparse LU in symmetric mode,
    diagonal pivots only): 0 exactly when S + shift·I is positive definite,
    by Sylvester's law of inertia. Where the factorization had to pivot off
    the diagonal, or found the matrix singular, the inertia is unknown and
    every row counts."""
    M = (S + shift * sp.identity(S.shape[0], format="csc")).tocsc()
    try:
        lu = spla.splu(M, permc_spec="MMD_AT_PLUS_A", diag_pivot_thresh=0.0,
                       options=dict(SymmetricMode=True))
    except RuntimeError:  # exactly singular
        return S.shape[0]
    if not np.array_equal(lu.perm_r, lu.perm_c):
        return S.shape[0]
    return int(np.count_nonzero(lu.U.diagonal() <= 0.0))


def feasibility(g: Graph, Y: np.ndarray) -> float:
    """Largest departure from the constraints: Y_i Y_iᵀ = I per pose block,
    ‖b_k‖ = 1 per bearing."""
    d, n, m = g.d, g.n, g.m
    sph, tr = layout(g)
    B = Y[:sph].reshape(n, d, -1)
    gram = np.einsum("nir,njr->nij", B, B) - np.eye(d)[None]
    out = float(np.abs(gram).max()) if n else 0.0
    if m:
        out = max(out, float(np.abs(np.linalg.norm(Y[sph:tr], axis=1) - 1).max()))
    return out
