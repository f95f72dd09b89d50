"""Synthetic range-aided SLAM problem generator.

Used for scaling benchmarks (BASELINE.json configs 4–5: 100k+ pose
graphs) and for compile checks. Generates a noisy 2D/3D
odometry chain with `n_landmarks` landmarks and range measurements to
them — the same structural family as the plaza/single_drone datasets.
"""

from __future__ import annotations

import numpy as np

from cora_tpu_torch.graph.problem import Problem
from cora_tpu_torch.measurements import RangeMeasurement, RelativePoseMeasurement
from cora_tpu_torch.symbol import Symbol
from cora_tpu_torch.types import Formulation, Preconditioner


def _rot2d(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]])


def synthetic_problem(
    n_poses: int = 1000,
    n_landmarks: int = 4,
    n_ranges: int | None = None,
    dim: int = 2,
    trans_stddev: float = 0.05,
    rot_stddev: float = 0.01,
    range_stddev: float = 0.3,
    seed: int = 0,
    noiseless: bool = False,
    preconditioner: Preconditioner = Preconditioner.REGULARIZED_CHOLESKY,
    formulation: Formulation = Formulation.EXPLICIT,
) -> Problem:
    """A noisy odometry chain with landmark range measurements.

    With `noiseless=True`, measurements are exact (covariances unchanged),
    so the ground truth lies in the null space of Q — handy for
    correctness tests at any scale.
    """
    noise = 0.0 if noiseless else 1.0
    rng = np.random.default_rng(seed)
    n_ranges = n_ranges if n_ranges is not None else n_poses // 2

    problem = Problem(
        dim=dim, relaxation_rank=dim,
        formulation=formulation, preconditioner=preconditioner,
    )

    # ground-truth trajectory: smooth random walk
    Rs = [np.eye(dim)]
    ts = [np.zeros(dim)]
    step = np.zeros(dim)
    step[0] = 1.0
    for i in range(1, n_poses):
        if dim == 2:
            dR = _rot2d(rng.normal(0.0, 0.15))
        else:
            w = rng.normal(0.0, 0.1, 3)
            dR = _expm_so3(w)
        Rs.append(Rs[-1] @ dR)
        ts.append(ts[-1] + Rs[-1] @ step)
    Rs, ts = np.stack(Rs), np.stack(ts)

    landmarks = rng.uniform(ts.min(0) - 5, ts.max(0) + 5, size=(n_landmarks, dim))

    for i in range(n_poses):
        sym = Symbol("a", i)
        problem.add_pose_variable(sym)
        problem.set_pose_gt(sym, Rs[i], ts[i])
    for k in range(n_landmarks):
        sym = Symbol("L", k)
        problem.add_landmark_variable(sym)
        problem.set_landmark_gt(sym, landmarks[k])

    cov = np.eye(3 if dim == 2 else 6)
    cov[:dim, :dim] *= trans_stddev ** 2
    cov[dim:, dim:] *= rot_stddev ** 2

    for i in range(n_poses - 1):
        R_rel = Rs[i].T @ Rs[i + 1]
        t_rel = Rs[i].T @ (ts[i + 1] - ts[i])
        # measurement noise
        t_meas = t_rel + noise * rng.normal(0, trans_stddev, dim)
        if dim == 2:
            R_meas = R_rel @ _rot2d(noise * rng.normal(0, rot_stddev))
        else:
            R_meas = R_rel @ _expm_so3(noise * rng.normal(0, rot_stddev, 3))
        problem.add_relative_pose_measurement(
            RelativePoseMeasurement(Symbol("a", i), Symbol("a", i + 1), R_meas, t_meas, cov)
        )

    pose_ids = rng.choice(n_poses, size=n_ranges, replace=False) if n_ranges <= n_poses \
        else rng.integers(0, n_poses, size=n_ranges)
    seen = set()
    for i in pose_ids:
        k = int(rng.integers(0, n_landmarks))
        if (int(i), k) in seen:
            continue
        seen.add((int(i), k))
        dist = np.linalg.norm(landmarks[k] - ts[i]) + noise * rng.normal(0, range_stddev)
        problem.add_range_measurement(
            RangeMeasurement(Symbol("a", int(i)), Symbol("L", k), max(dist, 0.1),
                             range_stddev ** 2)
        )
    return problem


def _expm_so3(w: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(w)
    if theta < 1e-12:
        return np.eye(3)
    K = np.array(
        [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]
    ) / theta
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)
