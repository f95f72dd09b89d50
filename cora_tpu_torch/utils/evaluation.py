"""Trajectory evaluation: absolute trajectory error (ATE) against ground
truth, with optimal gauge alignment.

The reference repo evaluates trajectories externally; the BASELINE target
is "ATE vs reference within bound". Since the certified solution of the
SDP relaxation is the *global* optimum of the estimation problem, cost
parity with the reference implies trajectory parity; this module provides
the direct ATE-vs-ground-truth measurement for the benchmark harness.
"""

from __future__ import annotations

import numpy as np

from cora_tpu_torch.graph.problem import Problem


def get_translation(problem: Problem, soln: np.ndarray, sym) -> np.ndarray:
    """Translation of pose or landmark `sym` from a rank-d solution."""
    return np.asarray(soln[problem.translation_idx(sym), :problem.dim])


def umeyama_alignment(
    X: np.ndarray, Y: np.ndarray, with_scale: bool = False
) -> tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity/rigid alignment R, t (, s) mapping X → Y.

    X, Y: (n, d) point sets. Returns (R, t, s) minimizing ‖s R x + t − y‖².
    """
    mu_x = X.mean(axis=0)
    mu_y = Y.mean(axis=0)
    Xc, Yc = X - mu_x, Y - mu_y
    C = Yc.T @ Xc / len(X)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(X.shape[1])
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[-1, -1] = -1
    R = U @ S @ Vt
    if with_scale:
        var_x = (Xc ** 2).sum() / len(X)
        s = np.trace(np.diag(D) @ S) / var_x
    else:
        s = 1.0
    t = mu_y - s * R @ mu_x
    return R, t, s


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: bool = True) -> float:
    """Root-mean-square absolute trajectory error after rigid alignment."""
    if align:
        R, t, s = umeyama_alignment(est, gt)
        est = est @ (s * R).T + t
    return float(np.sqrt(((est - gt) ** 2).sum(axis=1).mean()))


def trajectory_from_solution(problem: Problem, soln) -> np.ndarray:
    """(n, d) pose positions in symbol order."""
    syms = problem.pose_symbols()
    return np.stack([get_translation(problem, soln, s) for s in syms])


def gt_trajectory(problem: Problem) -> np.ndarray:
    """(n, d) ground-truth pose positions (from PyFG vertex records)."""
    syms = problem.pose_symbols()
    return np.stack([problem.pose_gt[s][1] for s in syms])


def evaluate_ate(problem: Problem, soln) -> float:
    return ate_rmse(trajectory_from_solution(problem, soln), gt_trajectory(problem))
