"""Solution rounding and gauge alignment.

Parity with the reference:
  * `projectSolution` (`src/CORA.cpp:352-441`): thin SVD of the rank-r
    solution, keep the top d singular pairs, majority-vote determinant
    sign fix with a reflector, per-block SO(d) projection, sphere-row
    renormalization.
  * `alignEstimateToOrigin` (`src/CORA_problem.cpp:1236-1306`): rotate so
    the first rotation block is the identity, then center translations.

These run **once per solve** on an (N, r≤10) matrix, so they execute on
the host in numpy.
"""

from __future__ import annotations

import numpy as np

from cora_tpu_torch.graph.data import ProblemData


def _project_to_SOd_np(M: np.ndarray) -> np.ndarray:
    """Batched (…,d,d) → SO(d) via SVD with determinant correction
    (reference `projectToSOd`, `CORA_utils.cpp:188-202`)."""
    U, _, Vt = np.linalg.svd(M)
    det = np.linalg.det(U) * np.linalg.det(Vt)
    U[det < 0, :, -1] *= -1
    return U @ Vt


def project_solution(pd: ProblemData, Y, verbose: bool = False):
    """Round a rank-r solution to rank d (reference `projectSolution`)."""
    Y = np.asarray(Y)
    dtype = Y.dtype
    d = pd.d
    U, s, _ = np.linalg.svd(Y, full_matrices=False)
    Yd = U[:, :d] * s[None, :d]

    nd = pd.rot_size
    Yrot = Yd[:nd].reshape(pd.n, d, d)
    Ysph = Yd[nd:nd + pd.m]
    Ytr = Yd[nd + pd.m:]

    if pd.n:
        # majority vote over block determinants (`CORA.cpp:379-413`)
        dets = np.linalg.det(Yrot)
        if (dets > 0).sum() < pd.n / 2:
            Yd[:, -1] *= -1
            Yrot = Yd[:nd].reshape(pd.n, d, d)
            Ysph = Yd[nd:nd + pd.m]
            Ytr = Yd[nd + pd.m:]
        Yrot = _project_to_SOd_np(Yrot)

    norms = np.linalg.norm(Ysph, axis=1, keepdims=True)
    Ysph = Ysph / np.maximum(norms, np.finfo(Y.dtype).tiny)
    return np.concatenate(
        [Yrot.reshape(nd, d), Ysph, Ytr], axis=0
    ).astype(dtype)


def align_estimate_to_origin(pd: ProblemData, Y) -> np.ndarray:
    """Gauge-fix a rank-d solution (reference `alignEstimateToOrigin`)."""
    Y = np.asarray(Y)
    d = pd.d
    Y_aligned = Y
    if pd.n:
        first_rot = Y[:d, :d]
        Y_aligned = Y @ first_rot.T
    # center translations at the origin
    tr0 = pd.rot_size + pd.m
    Y_aligned = Y_aligned.copy()
    Y_aligned[tr0:] -= Y_aligned[tr0:].mean(axis=0, keepdims=True)
    return Y_aligned


def check_variables_are_valid(pd: ProblemData, Y, atol=1e-6) -> None:
    """Sanity checks on manifold feasibility (reference
    `checkVariablesAreValid`, `CORA_problem.cpp:1199-1234`)."""
    Y = np.asarray(Y)
    d = pd.d
    Yrot = Y[: pd.rot_size].reshape(pd.n, d, -1)
    for i in range(pd.n):
        RRt = Yrot[i] @ Yrot[i].T
        if not np.allclose(RRt, np.eye(d), atol=atol):
            raise ValueError(f"pose {i}: R Rᵀ is not the identity")
        if Y.shape[1] == d and abs(np.linalg.det(Yrot[i]) - 1) > atol:
            raise ValueError(f"pose {i}: det(R) != 1")
    Ysph = Y[pd.rot_size: pd.rot_size + pd.m]
    norms = np.linalg.norm(Ysph, axis=1)
    if pd.m and not np.allclose(norms, 1.0, atol=atol):
        raise ValueError("range bearing variable is not unit-norm")
