"""The least work of a TNT level's iterations, from the graph alone.

It reads the same work whatever implements the levels (the chain kernels
or the canonical ops), so a faster implementation shows as a higher share.
Counts are of float32 state and data, each input byte read once and each
output byte written once:

- a tCG iteration applies the Riemannian Hessian to the direction (Q's edge
  data and the multipliers Λ read, Q·V and Λ·V formed), the
  preconditioner's banded solves and the tangent projections; it reads the
  state Y and the direction and writes the Hessian-vector product and the
  preconditioned residual;
- an outer iteration forms Q·Y, Λ, the gradient and its projection, one
  preconditioner apply and the retraction; it reads Y and the step and
  writes the new Y and the gradient.

The preconditioner is counted as the Cholesky factor of Q's pose, bearing
and translation rows in the benchmark's own reverse Cuthill-McKee order
(a band), with the landmark rows as dense spikes beside it.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee

from benchmark.reference.pyfg import Graph

F32 = 4  # bytes of a float32
IDX = 4  # bytes of an int32 index


def band_entries(g: Graph, Q: sp.spmatrix) -> tuple[int, int, int]:
    """(bandwidth, entries of the banded factor, entries of the landmark
    spikes) of Q's pattern without the landmark rows, in RCM order."""
    N, l = g.size, g.l
    keep = N - l  # landmark translations are the last l rows
    P = (abs(Q[:keep, :keep]) > 0).astype(np.int8).tocsr()
    perm = reverse_cuthill_mckee(P, symmetric_mode=True)
    C = P[perm][:, perm].tocoo()
    b = int(np.max(np.abs(C.row - C.col))) if C.nnz else 0
    band = keep * (b + 1) - b * (b + 1) // 2
    spikes = l * keep + l * (l + 1) // 2
    return b, band, spikes


def level_work(g: Graph, band: int, spikes: int, r: int) -> dict:
    """Bytes and flops of one tCG iteration and one outer iteration of a
    level at rank r."""
    d, n, m, N, E = g.d, g.n, g.m, g.size, len(g.e_i)
    edge_bytes = E * ((d * d + d + 2) * F32 + 2 * IDX) + m * (2 * F32 + 2 * IDX)
    lam_bytes = (n * d * d + m) * F32
    factor_bytes = (band + spikes) * F32
    vec = N * r * F32
    # Q·V from the residuals: per edge R·V_j, t_ijᵀV_i, the weighted
    # residuals and their transposes; per range three rows
    qv = E * (4 * d * d * r + 7 * d * r + 6 * r) + m * 10 * r
    lam_v = n * 2 * d * d * r + m * 2 * r
    proj = n * 4 * d * d * r + m * 4 * r
    precond = 4 * (band + spikes) * r
    retract = n * 4 * d * d * r + m * 3 * r
    return {
        "tcg_bytes": edge_bytes + lam_bytes + factor_bytes + 4 * vec,
        "tcg_flops": qv + lam_v + 2 * proj + precond,
        "outer_bytes": edge_bytes + factor_bytes + 4 * vec,
        "outer_flops": qv + lam_v + proj + precond + retract,
    }


def least_seconds(work: dict, peaks: dict, tcg_its: int, outer_its: int) -> float:
    """max(bytes / bandwidth, flops / f32 rate), summed over iterations."""
    def t(kind):
        return max(work[f"{kind}_bytes"] / peaks["hbm_bytes_per_s"],
                   work[f"{kind}_flops"] / peaks["f32_flops_per_s"])
    return tcg_its * t("tcg") + outer_its * t("outer")
