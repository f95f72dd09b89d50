"""CORA's objective, written out plainly from its residuals (numpy, scipy).

The stacked state Y (N × r) holds, in this order, a d × r block per pose
(its rotation), a row per range measurement (its unit bearing) and a row
per pose and per landmark (its translation). With Y_i a pose's block and
t_i, b_k rows, the residuals are

    rotation     √κ (Y_i − R_ij Y_j)                       (d × r)
    translation  √τ (t_j − t_i − t_ijᵀ Y_i)                (1 × r)
    range        √ω (t_b − t_a + dist_k b_k)               (1 × r)

for each relative-pose edge (i → j) and each range (a, b). The data matrix
is Q = Σ JᵀWJ over them, and the cost f(Y) = ½ Σ w‖residual‖² = ½ tr(YᵀQY),
which `cost` evaluates from the residuals, without forming Q.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from benchmark.reference.pyfg import Graph


def layout(g: Graph):
    """(first bearing row, first translation row)."""
    return g.n * g.d, g.n * g.d + g.m


def data_matrix(g: Graph, dtype=np.float64) -> sp.csr_matrix:
    """Q = JᵀWJ, assembled in `dtype` (the control's float32 as well)."""
    d, E, m, N = g.d, len(g.e_i), g.m, g.size
    sph, tr = layout(g)
    rows, cols, vals, w = [], [], [], []
    # rotation residuals: E·d rows
    e = np.arange(E)
    for k in range(d):
        rr = e * d + k
        rows += [rr]
        cols += [g.e_i * d + k]
        vals += [np.ones(E)]
        for c in range(d):
            rows += [rr]
            cols += [g.e_j * d + c]
            vals += [-g.e_R[:, k, c]]
    w += [np.repeat(g.kappa, d)]
    off = E * d
    # translation residuals: E rows
    rows += [off + e, off + e]
    cols += [tr + g.e_j, tr + g.e_i]
    vals += [np.ones(E), -np.ones(E)]
    for k in range(d):
        rows += [off + e]
        cols += [g.e_i * d + k]
        vals += [-g.e_t[:, k]]
    w += [g.tau]
    off += E
    # range residuals: m rows
    q = np.arange(m)
    rows += [off + q, off + q, off + q]
    cols += [tr + g.r_b, tr + g.r_a, sph + q]
    vals += [np.ones(m), -np.ones(m), g.r_dist]
    w += [g.r_prec]
    n_res = off + m
    J = sp.csr_matrix((np.concatenate(vals).astype(dtype),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n_res, N), dtype=dtype)
    W = sp.diags(np.concatenate(w).astype(dtype), dtype=dtype)
    return (J.T @ W @ J).tocsr()


def cost(g: Graph, Y: np.ndarray) -> float:
    """f(Y) = ½ Σ w‖residual‖², from the residuals (float64)."""
    Y = np.asarray(Y, np.float64)
    d, r = g.d, Y.shape[1]
    sph, tr = layout(g)
    blocks = Y[:sph].reshape(g.n, d, r)
    t = Y[tr:]
    rot = blocks[g.e_i] - np.einsum("ekc,ecr->ekr", g.e_R, blocks[g.e_j])
    trans = (t[g.e_j] - t[g.e_i]
             - np.einsum("ek,ekr->er", g.e_t, blocks[g.e_i]))
    rng = t[g.r_b] - t[g.r_a] + g.r_dist[:, None] * Y[sph:tr]
    return 0.5 * float(np.einsum("e,ekr,ekr->", g.kappa, rot, rot)
                       + np.einsum("e,er,er->", g.tau, trans, trans)
                       + np.einsum("e,er,er->", g.r_prec, rng, rng))
