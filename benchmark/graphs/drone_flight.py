"""One drone's flight inside an indoor arena, with odometry between
consecutive poses and an ultra-wideband range from every pose to one fixed
beacon, written as PyFG text (numpy only).

The flight is smooth and stays in the arena: each coordinate of the
position is a sum of a few slow sinusoids (random frequencies, amplitudes
and phases) scaled to the arena's half-width less a margin, sampled every
`dt` seconds. The attitude is a quadrotor's: its thrust axis along the
acceleration plus gravity, its heading a slow sinusoidal sum of its own.
The beacon lies uniform in the arena. As in `plaza_chain`, `geometry_seed`
(from the configuration) fixes the flight and the beacon, and `noise_seed`
(from `--seed`) draws the measurement noise, so every seed of a cell
solves a graph of the same structure and sizes.
"""

from __future__ import annotations

import numpy as np

from benchmark.graphs.plaza_chain import expm_so3, num, quat_xyzw

GRAVITY = 9.81
MARGIN = 0.5  # metres between the flight and the arena's walls
N_TERMS = 3  # sinusoids per coordinate


def smooth(rng, t, f_lo, f_hi):
    """A signal in [-1, 1] of the times `t`: a sum of `N_TERMS` sinusoids
    of frequencies uniform in [f_lo, f_hi] Hz, its amplitudes summing to
    one; with its second derivative."""
    w = 2 * np.pi * rng.uniform(f_lo, f_hi, N_TERMS)
    a = rng.uniform(0.5, 1.0, N_TERMS)
    a /= a.sum()
    arg = np.outer(t, w) + rng.uniform(0.0, 2 * np.pi, N_TERMS)
    return np.sin(arg) @ a, -np.sin(arg) @ (a * w ** 2)


def flight(p: dict, geo):
    """The true poses (rotations n × 3 × 3, positions n × 3) of the flight
    of `p` (n_poses, dt, arena_m, position_hz, heading_hz)."""
    n, t = p["n_poses"], p["dt"] * np.arange(p["n_poses"])
    half = 0.5 * np.asarray(p["arena_m"], float)
    pos, acc = np.zeros((n, 3)), np.zeros((n, 3))
    for k in range(3):
        s, dds = smooth(geo, t, *p["position_hz"])
        pos[:, k] = half[k] + (half[k] - MARGIN) * s
        acc[:, k] = (half[k] - MARGIN) * dds
    psi, _ = smooth(geo, t, *p["heading_hz"])
    psi = np.pi * psi
    z = acc + [0.0, 0.0, GRAVITY]
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    heading = np.stack([np.cos(psi), np.sin(psi), np.zeros(n)], axis=1)
    y = np.cross(z, heading)
    y /= np.linalg.norm(y, axis=1, keepdims=True)
    return np.stack([np.cross(y, z), y, z], axis=2), pos


def generate(p: dict, noise_seed: int) -> str:
    """The flight of `p` (n_poses, n_landmarks = 1, n_ranges = n_poses,
    dim = 3, dt, arena_m, position_hz, heading_hz, trans_stddev,
    rot_stddev, range_stddev, geometry_seed) as PyFG text, its noise drawn
    from `noise_seed`. Poses are `a0…`, the beacon `L0`."""
    n = p["n_poses"]
    if (p["dim"], p["n_landmarks"], p["n_ranges"]) != (3, 1, n):
        raise ValueError("a flight is 3-D, one beacon ranged from every pose")
    sig_t, sig_r = p["trans_stddev"], p["rot_stddev"]
    sig_rng = p["range_stddev"]
    geo = np.random.default_rng(p["geometry_seed"])
    noise = np.random.default_rng(noise_seed)

    Rs, ts = flight(p, geo)
    beacon = geo.uniform(0.0, p["arena_m"])

    lines = [f"VERTEX_SE3:QUAT {i}.0 a{i} {num(ts[i])} {num(quat_xyzw(Rs[i]))}"
             for i in range(n)]
    lines.append(f"VERTEX_XYZ L0 {num(beacon)}")
    cov_ut = num(np.diag([sig_t ** 2] * 3 + [sig_r ** 2] * 3)[
        np.triu_indices(6)])
    for i in range(n - 1):
        t = Rs[i].T @ (ts[i + 1] - ts[i]) + noise.normal(0, sig_t, 3)
        R = Rs[i].T @ Rs[i + 1] @ expm_so3(noise.normal(0, sig_r, 3))
        lines.append(f"EDGE_SE3:QUAT {i + 1}.0 a{i} a{i + 1} {num(t)} "
                     f"{num(quat_xyzw(R))} {cov_ut}")
    for i in range(n):
        dist = np.linalg.norm(beacon - ts[i]) + noise.normal(0, sig_rng)
        lines.append(f"EDGE_RANGE {i}.0 a{i} L0 {num(max(dist, 0.1))} "
                     f"{num(sig_rng ** 2)}")
    return "\n".join(lines) + "\n"
