"""One robot's odometry chain with range measurements to a few landmarks,
written as PyFG text (numpy only).

The family of `cora_tpu_torch.models.synthetic.synthetic_problem`, copied
here so that the benchmark's graphs stay as they are when the program
changes. The draws are split into two streams: `geometry_seed` (from the
configuration) fixes the trajectory, the landmarks and which pose ranges to
which landmark; `noise_seed` (from `--seed`) draws the measurement noise.
Every seed of a cell then solves a graph of the same structure and sizes.
Numbers are written with 17 significant digits, so a parser reads back the
same doubles.
"""

from __future__ import annotations

import numpy as np


def _rot2d(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]])


def expm_so3(w):
    """exp of the skew matrix of w (Rodrigues)."""
    theta = np.linalg.norm(w)
    if theta < 1e-12:
        return np.eye(3)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / theta
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def quat_xyzw(R):
    """Unit quaternion (x, y, z, w) of a 3×3 rotation (Shepperd's method)."""
    tr = np.trace(R)
    if tr > 0:
        s = 2.0 * np.sqrt(tr + 1.0)
        return [(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                (R[1, 0] - R[0, 1]) / s, 0.25 * s]
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = 2.0 * np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k])
    q = [0.0, 0.0, 0.0, (R[k, j] - R[j, k]) / s]
    q[i] = 0.25 * s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    return q


def num(x) -> str:
    return " ".join(f"{float(v):.17g}" for v in np.ravel(x))


def generate(p: dict, noise_seed: int) -> str:
    """The chain of `p` (n_poses, n_landmarks, n_ranges, dim, trans_stddev,
    rot_stddev, range_stddev, geometry_seed) as PyFG text, its noise drawn
    from `noise_seed`. Poses are `a0…`, landmarks `L0…`; each range joins
    a distinct pose to one landmark, so there are exactly `n_ranges`."""
    d = p["dim"]
    n, nl, nr = p["n_poses"], p["n_landmarks"], p["n_ranges"]
    sig_t, sig_r, sig_rng = p["trans_stddev"], p["rot_stddev"], p["range_stddev"]
    if nr > n:
        raise ValueError("each range needs a pose of its own")
    geo = np.random.default_rng(p["geometry_seed"])
    noise = np.random.default_rng(noise_seed)

    Rs, ts = [np.eye(d)], [np.zeros(d)]
    step = np.zeros(d)
    step[0] = 1.0
    for _ in range(1, n):
        dR = _rot2d(geo.normal(0.0, 0.15)) if d == 2 \
            else expm_so3(geo.normal(0.0, 0.1, 3))
        Rs.append(Rs[-1] @ dR)
        ts.append(ts[-1] + Rs[-1] @ step)
    Rs, ts = np.stack(Rs), np.stack(ts)
    lm = geo.uniform(ts.min(0) - 5, ts.max(0) + 5, size=(nl, d))
    pose_ids = geo.choice(n, size=nr, replace=False)
    lm_ids = geo.integers(0, nl, size=nr)

    lines = []
    for i in range(n):
        if d == 2:
            th = np.arctan2(Rs[i][1, 0], Rs[i][0, 0])
            lines.append(f"VERTEX_SE2 {i}.0 a{i} {num(ts[i])} {num(th)}")
        else:
            lines.append(f"VERTEX_SE3:QUAT {i}.0 a{i} {num(ts[i])} "
                         f"{num(quat_xyzw(Rs[i]))}")
    for k in range(nl):
        lines.append(f"VERTEX_{'XY' if d == 2 else 'XYZ'} L{k} {num(lm[k])}")

    nc = 3 if d == 2 else 6
    cov = np.diag([sig_t ** 2] * d + [sig_r ** 2] * (nc - d))
    cov_ut = num(cov[np.triu_indices(nc)])
    for i in range(n - 1):
        R_rel = Rs[i].T @ Rs[i + 1]
        t = Rs[i].T @ (ts[i + 1] - ts[i]) + noise.normal(0, sig_t, d)
        if d == 2:
            th = np.arctan2(R_rel[1, 0], R_rel[0, 0]) + noise.normal(0, sig_r)
            lines.append(f"EDGE_SE2 {i + 1}.0 a{i} a{i + 1} {num(t)} {num(th)} "
                         f"{cov_ut}")
        else:
            R = R_rel @ expm_so3(noise.normal(0, sig_r, 3))
            lines.append(f"EDGE_SE3:QUAT {i + 1}.0 a{i} a{i + 1} {num(t)} "
                         f"{num(quat_xyzw(R))} {cov_ut}")
    for i, k in zip(pose_ids.tolist(), lm_ids.tolist()):
        dist = np.linalg.norm(lm[k] - ts[i]) + noise.normal(0, sig_rng)
        lines.append(f"EDGE_RANGE {i}.0 a{i} L{k} {num(max(dist, 0.1))} "
                     f"{num(sig_rng ** 2)}")
    return "\n".join(lines) + "\n"
