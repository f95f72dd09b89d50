"""Absolute trajectory error of an estimate against ground truth (numpy)."""

from __future__ import annotations

import numpy as np


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """RMSE of the pose positions after the rigid alignment (rotation and
    translation, no scale) that best maps `est` onto `gt` (Umeyama)."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    U, _, Vt = np.linalg.svd(G.T @ E)
    D = np.eye(est.shape[1])
    D[-1, -1] = np.sign(np.linalg.det(U @ Vt))
    R = U @ D @ Vt
    res = G - E @ R.T
    return float(np.sqrt((res ** 2).sum(1).mean()))
