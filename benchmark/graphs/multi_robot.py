"""A multi-robot range-aided SLAM graph as PyFG text (numpy only).

The family of `multi_robot_pyfg` in `scripts/torch_port_reference.py`,
copied here so that the benchmark's graphs stay as they are when the
program or its scripts change. Robots `A`, `B`, … drive smooth random walks
that steer back towards the origin, so they share one area, and log
odometry (noise `trans_stddev` m and `rot_stddev` rad) with ground truth in
the vertex records. Inter-robot `EDGE_RANGE`s join time-synchronous poses
(|Δt| ≤ 2 steps), as a UWB network measures them; the other ranges go from
a random pose to a landmark `L…` (noise `range_stddev` m). Loop closures
join poses of one robot 2-6 steps apart. Every measurement is unique per
pair.

As in `plaza_chain`, the draws are split: `geometry_seed` fixes the walks,
the landmarks and which pairs are measured; `noise_seed` draws the noise.
"""

from __future__ import annotations

import numpy as np

from benchmark.graphs.plaza_chain import _rot2d, expm_so3, num, quat_xyzw

ROBOT_CHARS = "ABCDEFGH"


def generate(p: dict, noise_seed: int) -> str:
    """The graph of `p` (n_robots, poses_per_robot, n_inter_ranges,
    n_landmarks, n_landmark_ranges, n_loop_closures, dim, trans_stddev,
    rot_stddev, range_stddev, geometry_seed), its noise from `noise_seed`."""
    geo = np.random.default_rng(p["geometry_seed"])
    noise = np.random.default_rng(noise_seed)
    nrob, T, dim = p["n_robots"], p["poses_per_robot"], p["dim"]
    sig_t, sig_r, sig_rng = p["trans_stddev"], p["rot_stddev"], p["range_stddev"]
    Rs, ps = [], []
    for _ in range(nrob):
        pos = np.zeros(dim)
        pos[:2] = geo.uniform(-15.0, 15.0, 2)
        yaw = geo.uniform(-np.pi, np.pi)
        R_tr, p_tr = [], []
        for _t in range(T):
            R = _rot2d(yaw)
            if dim == 3:
                R = np.block([[R, np.zeros((2, 1))], [np.zeros((1, 2)), 1.0]])
                R = R @ expm_so3(geo.normal(0.0, 0.05, 3))
            R_tr.append(R)
            p_tr.append(pos.copy())
            yaw += geo.normal(0.0, 0.15)
            if np.linalg.norm(pos[:2]) > 25.0:  # steer back into the area
                home = np.arctan2(-pos[1], -pos[0])
                yaw += 0.3 * np.angle(np.exp(1j * (home - yaw)))
            step = np.zeros(dim)
            step[0] = 0.5
            if dim == 3:
                step[2] = geo.normal(0.0, 0.05)
            pos = pos + R_tr[-1] @ step
        Rs.append(np.stack(R_tr))
        ps.append(np.stack(p_tr))
    lm = geo.uniform(-20.0, 20.0, (p["n_landmarks"], dim))

    def sym(r, t):
        return f"{ROBOT_CHARS[r]}{t}"

    lines = []
    for r in range(nrob):
        for t in range(T):
            if dim == 2:
                th = np.arctan2(Rs[r][t][1, 0], Rs[r][t][0, 0])
                lines.append(f"VERTEX_SE2 {t}.0 {sym(r, t)} "
                             f"{num(ps[r][t])} {num(th)}")
            else:
                lines.append(f"VERTEX_SE3:QUAT {t}.0 {sym(r, t)} "
                             f"{num(ps[r][t])} {num(quat_xyzw(Rs[r][t]))}")
    for k in range(p["n_landmarks"]):
        lines.append(f"VERTEX_{'XY' if dim == 2 else 'XYZ'} L{k} {num(lm[k])}")

    nc = 3 if dim == 2 else 6
    cov = np.diag([sig_t ** 2] * dim + [sig_r ** 2] * (nc - dim))
    cov_ut = num(cov[np.triu_indices(nc)])

    def rel_pose(r, i, j):
        R = Rs[r][i].T @ Rs[r][j]
        t = Rs[r][i].T @ (ps[r][j] - ps[r][i]) + noise.normal(0.0, sig_t, dim)
        if dim == 2:
            th = np.arctan2(R[1, 0], R[0, 0]) + noise.normal(0.0, sig_r)
            lines.append(f"EDGE_SE2 {j}.0 {sym(r, i)} {sym(r, j)} {num(t)} "
                         f"{num(th)} {cov_ut}")
        else:
            R = R @ expm_so3(noise.normal(0.0, sig_r, 3))
            lines.append(f"EDGE_SE3:QUAT {j}.0 {sym(r, i)} {sym(r, j)} "
                         f"{num(t)} {num(quat_xyzw(R))} {cov_ut}")

    for r in range(nrob):
        for t in range(T - 1):
            rel_pose(r, t, t + 1)
    seen = set()
    while len(seen) < p["n_loop_closures"]:
        r = int(geo.integers(nrob))
        i = int(geo.integers(T - 2))
        j = min(i + int(geo.integers(2, 7)), T - 1)
        if j - i >= 2 and (r, i, j) not in seen:
            seen.add((r, i, j))
            rel_pose(r, i, j)

    def range_line(t, a, b, pa, pb):
        dist = abs(np.linalg.norm(pa - pb) + noise.normal(0.0, sig_rng))
        lines.append(f"EDGE_RANGE {t}.0 {a} {b} {num(max(dist, 0.01))} "
                     f"{num(sig_rng ** 2)}")

    seen = set()
    while len(seen) < p["n_inter_ranges"]:
        a, b = sorted(geo.choice(nrob, 2, replace=False).tolist())
        t = int(geo.integers(T))
        u = int(np.clip(t + geo.integers(-2, 3), 0, T - 1))
        if (a, t, b, u) not in seen:
            seen.add((a, t, b, u))
            range_line(t, sym(a, t), sym(b, u), ps[a][t], ps[b][u])
    seen = set()
    while len(seen) < p["n_landmark_ranges"]:
        r, t, k = (int(geo.integers(nrob)), int(geo.integers(T)),
                   int(geo.integers(p["n_landmarks"])))
        if (r, t, k) not in seen:
            seen.add((r, t, k))
            range_line(t, sym(r, t), f"L{k}", ps[r][t], lm[k])
    return "\n".join(lines) + "\n"
