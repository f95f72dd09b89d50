"""Solution export: TUM and g2o trajectory writers.

Parity with `saveSolnToTum` / `saveSolnToG20`
(reference `src/CORA_utils.cpp:204-350`) and with the JAX package's
`cora_tpu/io/exporters.py` (the same bytes for the same solution):
per-robot pose chains in symbol order, rotation blocks transposed out of
the stacked state, 2D poses padded with z=0 / yaw-only quaternions.
"""

from __future__ import annotations

import numpy as np

from cora_tpu_torch.graph.problem import Problem
from cora_tpu_torch.symbol import Symbol


def get_rotation(problem: Problem, soln: np.ndarray, sym: Symbol) -> np.ndarray:
    """R for pose `sym` from a rank-d solution (rows store Rᵀ)."""
    d = problem.dim
    i = problem.rotation_idx(sym)
    return np.asarray(soln[i * d:(i + 1) * d, :d]).T


def get_translation(problem: Problem, soln: np.ndarray, sym: Symbol) -> np.ndarray:
    return np.asarray(soln[problem.translation_idx(sym), :problem.dim])


def _quat_from_rot3(R: np.ndarray) -> tuple[float, float, float, float]:
    """Rotation matrix → (qx, qy, qz, qw), Shepperd's method."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0)) * 2
        q = [0.0, 0.0, 0.0]
        q[i] = 0.25 * s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        qw = (R[k, j] - R[j, k]) / s
        qx, qy, qz = q
    return qx, qy, qz, qw


def _pose_to_xyzquat(problem: Problem, soln, sym):
    R = get_rotation(problem, soln, sym)
    t = get_translation(problem, soln, sym)
    if problem.dim == 2:
        x, y, z = t[0], t[1], 0.0
        R3 = np.eye(3)
        R3[:2, :2] = R
    else:
        x, y, z = t
        R3 = R
    return x, y, z, R3


def save_soln_to_tum(
    pose_symbols: list[Symbol], problem: Problem, soln, fpath: str
) -> None:
    """`ts x y z qx qy qz qw` per pose (reference `saveSolnToTum`)."""
    with open(fpath, "w") as f:
        for time, sym in enumerate(pose_symbols):
            x, y, z, R3 = _pose_to_xyzquat(problem, soln, sym)
            qx, qy, qz, qw = _quat_from_rot3(R3)
            f.write(f"{time} {x} {y} {z} {qx} {qy} {qz} {qw}\n")


def save_soln_to_g2o(
    pose_symbols: list[Symbol], problem: Problem, soln, fpath: str
) -> None:
    """VERTEX_SE2 / VERTEX_SE3:QUAT records (reference `saveSolnToG20`)."""
    with open(fpath, "w") as f:
        for time, sym in enumerate(pose_symbols):
            x, y, z, R3 = _pose_to_xyzquat(problem, soln, sym)
            if problem.dim == 3:
                qx, qy, qz, qw = _quat_from_rot3(R3)
                f.write(f"VERTEX_SE3:QUAT {time} {x} {y} {z} {qx} {qy} {qz} {qw}\n")
            else:
                theta = float(np.arctan2(R3[1, 0], R3[0, 0]))
                f.write(f"VERTEX_SE2 {time} {x} {y} {theta}\n")


def save_solution(problem: Problem, soln, fpath: str, fmt: str = "tum") -> None:
    """One file per robot (reference appends robot char to the filename)."""
    for c in problem.robot_chars():
        syms = problem.pose_symbols(c)
        path = fpath if len(problem.robot_chars()) == 1 else f"{fpath}.{c}"
        if fmt == "tum":
            save_soln_to_tum(syms, problem, soln, path)
        else:
            save_soln_to_g2o(syms, problem, soln, path)
