"""Initialization strategies: random and odometry dead-reckoning.

Odometry initialization mirrors the reference experiments' path
(`examples/paper_experiments.cpp:358-534`):

  * poses are grouped into per-robot chains by symbol character;
  * odometry measurements (same character, adjacent indices) are
    dead-reckoned as homogeneous-matrix chains; the first robot starts at
    the identity, later robots at random poses;
  * landmarks are randomized (uniform in [−10, 10]^d);
  * sphere variables are the normalized translation differences of their
    endpoints (random unit vectors for coincident endpoints);
  * the stacked state is right-multiplied by a random r×r rotation so the
    iterate is generically dense in all r columns.

Host numpy, seeded by `np.random.default_rng(seed)` and drawing in the
same order as the JAX package's `cora_tpu/models/init.py`, so both give
the same start bit for bit.
"""

from __future__ import annotations

import numpy as np

from cora_tpu_torch.graph.problem import Problem
from cora_tpu_torch.measurements import RelativePoseMeasurement
from cora_tpu_torch.symbol import Symbol


def get_robot_pose_chains(problem: Problem) -> list[list[Symbol]]:
    """Per-robot pose chains, sorted by index
    (reference `getRobotPoseChains`, `paper_experiments.cpp:89-112`)."""
    return [problem.pose_symbols(c) for c in problem.robot_chars()]


def get_odom_chains(problem: Problem) -> list[list[RelativePoseMeasurement]]:
    """Odometry chains: same-character, adjacent-index rel-pose measurements
    (reference `getOdomChains`, `paper_experiments.cpp:358-424`)."""
    chains: dict[str, list[RelativePoseMeasurement]] = {
        c: [] for c in problem.robot_chars()
    }
    for meas in problem.rel_pose_measurements:
        if (
            meas.first_id.chr == meas.second_id.chr
            and meas.first_id.index + 1 == meas.second_id.index
        ):
            chains[meas.first_id.chr].append(meas)
    return [
        sorted(chains[c], key=lambda m: m.first_id.index)
        for c in problem.robot_chars()
    ]


def _random_start_pose(dim: int, rng: np.random.Generator) -> np.ndarray:
    """Random SE(d) start for robots ≥ 2."""
    A = rng.standard_normal((dim, dim))
    U, _, Vt = np.linalg.svd(A)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        U[:, -1] *= -1
        R = U @ Vt
    H = np.eye(dim + 1)
    H[:dim, :dim] = R
    H[:dim, dim] = rng.uniform(-10, 10, size=dim)
    return H


def odometry_initialization(
    problem: Problem, rank: int | None = None, seed: int = 0
) -> np.ndarray:
    """Dead-reckoned initial iterate (reference `getOdomInitialization`)."""
    rng = np.random.default_rng(seed)
    dim = problem.dim
    rank = rank or problem.relaxation_rank
    N = problem.data_matrix_size
    x0 = np.zeros((N, rank))

    first = True
    for chain in get_odom_chains(problem):
        if not chain:
            continue
        if first:
            cur = np.eye(dim + 1)
            first = False
        else:
            cur = _random_start_pose(dim, rng)

        sym = chain[0].first_id
        ri = problem.rotation_idx(sym) * dim
        ti = problem.translation_idx(sym)
        # stacked-state convention: rotation block rows hold Rᵀ
        x0[ri:ri + dim, :dim] = cur[:dim, :dim].T
        x0[ti, :dim] = cur[:dim, dim]

        for meas in chain:
            cur = cur @ meas.homogeneous_matrix()
            ri = problem.rotation_idx(meas.second_id) * dim
            ti = problem.translation_idx(meas.second_id)
            x0[ri:ri + dim, :dim] = cur[:dim, :dim].T
            x0[ti, :dim] = cur[:dim, dim]

    # isolated poses (no odometry) stay at zero rotation blocks, which are
    # invalid — set them to identity so the manifold projection is benign
    in_chain = {s for chain in get_odom_chains(problem) for m in chain
                for s in (m.first_id, m.second_id)}
    for sym in problem.pose_symbol_idxs:
        if sym not in in_chain:
            ri = problem.rotation_idx(sym) * dim
            x0[ri:ri + dim, :dim] = np.eye(dim)

    # landmarks: uniform random in [-10, 10]^d (`paper_experiments.cpp:476-487`)
    for sym in problem.landmark_symbol_idxs:
        x0[problem.translation_idx(sym), :dim] = rng.uniform(-10, 10, size=dim)

    # sphere variables: normalized endpoint differences (`:489-507`).
    # NOTE sign: the data-matrix convention puts y_e = (t_i − t_j)/r_e in
    # the null space (range residual is r_e·y_e + t_j − t_i; see the
    # reference's own null-space test, `test_construct_problem.cpp:110-125`).
    # The reference initializes with +diff — the *antipodal* point — which
    # costs ~4·ω·r² per range; we use the consistent sign.
    for e, meas in enumerate(problem.range_measurements):
        row = problem.num_poses_dim + e
        diff = (
            x0[problem.translation_idx(meas.first_id)]
            - x0[problem.translation_idx(meas.second_id)]
        )
        nrm = np.linalg.norm(diff)
        if nrm < 1e-5:
            v = rng.uniform(-1, 1, size=rank)
            x0[row] = v / np.linalg.norm(v)
        else:
            x0[row] = diff / nrm

    # right-multiply by a random rotation for generic density (`:509-531`)
    A = rng.uniform(-1, 1, size=(rank, rank))
    Q, _ = np.linalg.qr(A)
    if np.linalg.det(Q) < 0:
        Q[:, -1] *= -1
    return x0 @ Q
