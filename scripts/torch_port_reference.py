"""Record the JAX package's solves that the PyTorch port is held to on the GPU.

Runs `cora_tpu.solve_cora` on the CPU (XLA path, `use_pallas="never"`) for
the two dataset-shaped synthetic chains with bench.py's configuration and a
numpy-seeded start, and for the plaza2-shaped chain once more from rank d,
and writes `tests/data/torch_port_reference.json`. The single_drone-shaped
chain is also solved from four more starts: its rounded estimate depends on
the start far more than 1 % (see `spread` in the file), so the card is held
to the range the JAX package itself reaches there. Each run also records its
first TNT level's per-iteration f and ‖grad‖ (`level0`), which the card's
first level is held to over its first chunk: a check that does not depend on
where the chaotic rest of the staircase ends.
It also records the single_drone-shaped run's first level once more in
float64 with the canonical `tnt_solve`, and from four starts one ulp away
(`level0_f64`), and solves two
multi-robot graphs written as PyFG text by `multi_robot_pyfg` (`general`:
`tiers_shaped` and `mrclam5a_shaped`) from the odometry start, both also
from four more seeds (`spread`).
Last, the translation-implicit runs (`implicit`, float64): the
plaza2-shaped chain from the numpy start truncated to its rotation and
bearing rows (seeds 4, 5, 6: `spread`) and `mrclam5a_shaped` from the
odometry start.
`chip_smoke.py` reads that file: it rebuilds the same graphs and start with
`cora_tpu_torch`, solves them on the card and gates the result against it.

    JAX_PLATFORMS=cpu python scripts/torch_port_reference.py
    JAX_PLATFORMS=cpu python scripts/torch_port_reference.py --implicit-only
    JAX_PLATFORMS=cpu python scripts/torch_port_reference.py --general-spread mrclam5a_shaped

Takes about 40 minutes on an 8-core CPU; the run that wrote the committed
file took (`cpu_wall_s` in it) 111 s, 84.5 s and 187 s for the three chain
runs, 3.5 min for the single_drone-shaped spread, 44.2 s for `level0_f64`
(its four one-ulp runs are not timed apart), 100.5 s for `tiers_shaped`
and 12.5 min for its spread, and 44.6 s for `mrclam5a_shaped`. Times move
by up to 20 % between runs. `--implicit-only` recomputes the `implicit`
section alone and writes every other key back unchanged: 9.2 min, of which
238.3 s, 125.3 s and 131.8 s for the three plaza2-shaped runs (the first
compiles) and 46.9 s for `mrclam5a_shaped`. `--general-spread NAME`
recomputes one general run's `spread` alone (its first seed's run is the
record's own) and writes every other key back unchanged: 76.4 s of solves
for `mrclam5a_shaped` (38.9, 7.4, 12.9 and 17.2 s for seeds 5-8).
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "torch_port_reference.json")

# synthetic chains with the real datasets' sizes (plaza2: 4091 poses, 4
# landmarks, 1807 ranges, 2D; single_drone: 1754 poses, 1 landmark, 1754
# ranges, 3D)
PLAZA2 = dict(n_poses=4091, n_landmarks=4, n_ranges=1807, dim=2, seed=0)
SINGLE_DRONE = dict(n_poses=1754, n_landmarks=1, n_ranges=1754, dim=3, seed=0)
# (graph, staircase start rank d + init_rank_jump): bench.py starts at
# rank d + 2; the package default, rank d, is the run whose first level
# fails its certificate and takes the saddle escape
RUNS = {
    "plaza2_shaped": (PLAZA2, 2),
    "single_drone_shaped": (SINGLE_DRONE, 2),
    "plaza2_shaped_from_rank_d": (PLAZA2, 0),
}
# bench.py's main-path config, with the wall-clock caps raised so that the
# outcome does not depend on the machine's speed
CONFIG = dict(
    max_staircase_iterations=60,
    ramp_tcg_iterations=24,
    seed=4,
    max_computation_time=600.0,
    polish_time_budget=120.0,
)
X0_SEED = 4
# starts of the single_drone-shaped spread (the first is X0_SEED's run)
SPREAD_SEEDS = (4, 5, 6, 7, 8)
# iterations of the first TNT level recorded per run
HISTORY_ITERS = 64
# the float64 first level from starts one ulp away (seeds of the
# perturbation), and the relative gaps in f that count as parting
PERTURB_SEEDS = (1, 2, 3, 4)
PART_TOLS = (1e-12, 1e-8, 1e-3)
# multi-robot graphs with the real datasets' totals (SURVEY.md:371): tiers,
# 4 robots, 9 768 poses, 1 landmark, 7 789 ranges (6 000 of them between
# robots); mrclam5a, 5 robots, 1 080 poses, 316 inter-robot ranges
GENERAL = {
    "tiers_shaped": dict(n_robots=4, poses_per_robot=2442,
                         n_inter_ranges=6000, n_landmarks=1,
                         n_landmark_ranges=1789, n_loop_closures=0, dim=2,
                         seed=0),
    "mrclam5a_shaped": dict(n_robots=5, poses_per_robot=216,
                            n_inter_ranges=316, n_landmarks=0,
                            n_landmark_ranges=0, n_loop_closures=10, dim=2,
                            seed=0),
}
# both start at bench.py's rank d + 2 from the odometry start
GENERAL_JUMP = 2
# the general runs recorded from five seeds: `tiers_shaped`, whose JAX result
# moves by more than 1 % with the seed, and `mrclam5a_shaped`, whose level
# count the port's gate reads (levels + 2)
GENERAL_SPREAD = ("tiers_shaped", "mrclam5a_shaped")
# the translation-implicit (marginalized) runs, in float64 as
# `examples/config.json` and `SolverConfig` default to: the plaza2-shaped
# chain from the numpy start truncated to its rotation and bearing rows
# (from X0_SEED, then two more starts for `spread`), and `mrclam5a_shaped`
# from the odometry start
IMPLICIT_SPREAD_SEEDS = (4, 5, 6)


def numpy_start(n_rows: int, rank: int, seed: int):
    """The shared start: uniform in [-1, 1]; each package projects it."""
    import numpy as np

    return np.random.default_rng(seed).uniform(-1.0, 1.0, size=(n_rows, rank))


ROBOT_CHARS = "ABCDEFGH"


def _rot2d(theta):
    import numpy as np

    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]])


def _expm_so3(w):
    import numpy as np

    theta = np.linalg.norm(w)
    if theta < 1e-12:
        return np.eye(3)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / theta
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def _quat_xyzw(R):
    """Unit quaternion (x, y, z, w) of a 3×3 rotation (Shepperd's method)."""
    import numpy as np

    tr = np.trace(R)
    if tr > 0:
        s = 2.0 * np.sqrt(tr + 1.0)
        q = [(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s, 0.25 * s]
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k])
        q = [0.0, 0.0, 0.0, (R[k, j] - R[j, k]) / s]
        q[i] = 0.25 * s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
    return q


def multi_robot_pyfg(n_robots: int, poses_per_robot: int, n_inter_ranges: int,
                     n_landmarks: int, n_landmark_ranges: int,
                     n_loop_closures: int, dim: int = 2, seed: int = 0) -> str:
    """A multi-robot range-aided SLAM graph as PyFG text (numpy only).

    Robots `A`, `B`, … drive smooth random walks that steer back towards
    the origin, so they share one area, and log odometry (`EDGE_SE2` /
    `EDGE_SE3:QUAT`, noise 0.05 m and 0.01 rad) with ground truth in the
    vertex records. Inter-robot `EDGE_RANGE`s join time-synchronous poses
    (|Δt| ≤ 2 steps), as a UWB network measures them; the other ranges go
    from a random pose to a landmark `L…` (range noise 0.1 m). Loop
    closures join poses of one robot 2-6 steps apart. Every measurement is
    unique per pair, as the parsers require."""
    import numpy as np

    rng = np.random.default_rng(seed)
    T = poses_per_robot
    sig_t, sig_r, sig_rng = 0.05, 0.01, 0.1
    Rs, ps = [], []
    for _ in range(n_robots):
        p = np.zeros(dim)
        p[:2] = rng.uniform(-15.0, 15.0, 2)
        yaw = rng.uniform(-np.pi, np.pi)
        R_tr, p_tr = [], []
        for _t in range(T):
            if dim == 2:
                R = _rot2d(yaw)
            else:
                R = _rot2d(yaw)
                R = np.block([[R, np.zeros((2, 1))], [np.zeros((1, 2)), 1.0]])
                R = R @ _expm_so3(rng.normal(0.0, 0.05, 3))
            R_tr.append(R)
            p_tr.append(p.copy())
            yaw += rng.normal(0.0, 0.15)
            if np.linalg.norm(p[:2]) > 25.0:  # steer back into the area
                home = np.arctan2(-p[1], -p[0])
                yaw += 0.3 * np.angle(np.exp(1j * (home - yaw)))
            step = np.zeros(dim)
            step[0] = 0.5
            if dim == 3:
                step[2] = rng.normal(0.0, 0.05)
            p = p + R_tr[-1] @ step
        Rs.append(np.stack(R_tr))
        ps.append(np.stack(p_tr))
    lm = rng.uniform(-20.0, 20.0, (n_landmarks, dim))

    def sym(r, t):
        return f"{ROBOT_CHARS[r]}{t}"

    def num(x):
        return " ".join(f"{float(v):.12g}" for v in np.ravel(x))

    lines = []
    for r in range(n_robots):
        for t in range(T):
            if dim == 2:
                th = np.arctan2(Rs[r][t][1, 0], Rs[r][t][0, 0])
                lines.append(f"VERTEX_SE2 {t}.0 {sym(r, t)} "
                             f"{num(ps[r][t])} {num(th)}")
            else:
                lines.append(f"VERTEX_SE3:QUAT {t}.0 {sym(r, t)} "
                             f"{num(ps[r][t])} {num(_quat_xyzw(Rs[r][t]))}")
    for k in range(n_landmarks):
        lines.append(f"VERTEX_{'XY' if dim == 2 else 'XYZ'} L{k} {num(lm[k])}")

    nc = 3 if dim == 2 else 6
    cov = np.diag([sig_t ** 2] * dim + [sig_r ** 2] * (nc - dim))
    cov_ut = num(cov[np.triu_indices(nc)])

    def rel_pose(r, i, j):
        R = Rs[r][i].T @ Rs[r][j]
        t = Rs[r][i].T @ (ps[r][j] - ps[r][i]) + rng.normal(0.0, sig_t, dim)
        if dim == 2:
            th = np.arctan2(R[1, 0], R[0, 0]) + rng.normal(0.0, sig_r)
            lines.append(f"EDGE_SE2 {j}.0 {sym(r, i)} {sym(r, j)} {num(t)} "
                         f"{num(th)} {cov_ut}")
        else:
            R = R @ _expm_so3(rng.normal(0.0, sig_r, 3))
            lines.append(f"EDGE_SE3:QUAT {j}.0 {sym(r, i)} {sym(r, j)} "
                         f"{num(t)} {num(_quat_xyzw(R))} {cov_ut}")

    for r in range(n_robots):
        for t in range(T - 1):
            rel_pose(r, t, t + 1)
    seen = set()
    while len(seen) < n_loop_closures:
        r = int(rng.integers(n_robots))
        i = int(rng.integers(T - 2))
        j = min(i + int(rng.integers(2, 7)), T - 1)
        if j - i >= 2 and (r, i, j) not in seen:
            seen.add((r, i, j))
            rel_pose(r, i, j)

    def range_line(t, a, b, pa, pb):
        dist = abs(np.linalg.norm(pa - pb) + rng.normal(0.0, sig_rng))
        lines.append(f"EDGE_RANGE {t}.0 {a} {b} {num(max(dist, 0.01))} "
                     f"{num(sig_rng ** 2)}")

    seen = set()
    while len(seen) < n_inter_ranges:
        a, b = sorted(rng.choice(n_robots, 2, replace=False).tolist())
        t = int(rng.integers(T))
        u = int(np.clip(t + rng.integers(-2, 3), 0, T - 1))
        if (a, t, b, u) not in seen:
            seen.add((a, t, b, u))
            range_line(t, sym(a, t), sym(b, u), ps[a][t], ps[b][u])
    seen = set()
    while len(seen) < n_landmark_ranges:
        r, t, k = (int(rng.integers(n_robots)), int(rng.integers(T)),
                   int(rng.integers(n_landmarks)))
        if (r, t, k) not in seen:
            seen.add((r, t, k))
            range_line(t, sym(r, t), f"L{k}", ps[r][t], lm[k])
    return "\n".join(lines) + "\n"


def noisy_chain_pyfg(n_poses: int, n_landmarks: int, ranges_per_pose: int,
                     noise_scale: float, seed: int = 0) -> str:
    """A 2D odometry chain as PyFG text (numpy only) whose every pose
    ranges to `ranges_per_pose` distinct landmarks, with noise drawn
    `noise_scale` times the noise it states (0.05 m and 0.01 rad of
    odometry, 0.1 m of range). Measurements that disagree with their
    stated noise raise the rank of the relaxation's optimum: with 200
    poses, 16 landmarks, 4 ranges a pose and `noise_scale` 100 it is 11, so
    a staircase from rank 10 fails its certificate there and escapes, on a
    graph the chain kernels take (one robot, pose → landmark ranges, at
    most 8 a pose)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sig_t, sig_r, sig_rng = 0.05, 0.01, 0.1
    yaw, p = 0.0, np.zeros(2)
    ths, ps = [], []
    for _ in range(n_poses):
        ths.append(yaw)
        ps.append(p.copy())
        yaw += rng.normal(0.0, 0.15)
        p = p + _rot2d(yaw) @ np.array([1.0, 0.0])
    ps = np.stack(ps)
    lm = rng.uniform(ps.min(0) - 5.0, ps.max(0) + 5.0, (n_landmarks, 2))

    def num(x):
        return " ".join(f"{float(v):.12g}" for v in np.ravel(x))

    lines = [f"VERTEX_SE2 {t}.0 A{t} {num(ps[t])} {num(ths[t])}"
             for t in range(n_poses)]
    lines += [f"VERTEX_XY L{k} {num(lm[k])}" for k in range(n_landmarks)]
    cov_ut = num(np.diag([sig_t ** 2] * 2 + [sig_r ** 2])[np.triu_indices(3)])
    for t in range(n_poses - 1):
        dt = _rot2d(ths[t]).T @ (ps[t + 1] - ps[t]) \
            + noise_scale * rng.normal(0.0, sig_t, 2)
        dth = ths[t + 1] - ths[t] + noise_scale * rng.normal(0.0, sig_r)
        lines.append(f"EDGE_SE2 {t + 1}.0 A{t} A{t + 1} {num(dt)} {num(dth)} "
                     f"{cov_ut}")
    for t in range(n_poses):
        for k in rng.choice(n_landmarks, ranges_per_pose, replace=False):
            dist = abs(np.linalg.norm(ps[t] - lm[k])
                       + noise_scale * rng.normal(0.0, sig_rng))
            lines.append(f"EDGE_RANGE {t}.0 A{t} L{k} {num(max(dist, 0.01))} "
                         f"{num(sig_rng ** 2)}")
    return "\n".join(lines) + "\n"


def permuted_bandwidth(problem, pd) -> int:
    """Scalar bandwidth of the pose band of Q after the sphere elimination,
    under the RCM pose ordering: the `bw_actual` that the JAX package's
    `factor_banded` measures (`cora_tpu/precond/banded.py:283-284`). The
    banded factor is exact up to 96."""
    import numpy as np
    import scipy.sparse as sp

    from cora_tpu.precond.banded import build_permutation, pose_ordering

    perm, _ = build_permutation(pd, order=pose_ordering(pd))
    Q = abs(problem.data_matrix().tocsr())
    sph = np.arange(pd.rot_size, pd.rot_size + pd.m)
    M = Q[perm][:, perm]
    if pd.m:
        C = Q[perm][:, sph]
        M = M + C @ C.T
    B = sp.tril(M[:pd.n * (pd.d + 1), :pd.n * (pd.d + 1)]).tocoo()
    return int((B.row - B.col).max())


def bench_config(**kw):
    """bench.py's main-path config (bench.py:43-62) with the raised caps;
    `kw` sets or overrides fields (the implicit runs' dtype and
    formulation)."""
    import numpy as np

    from cora_tpu.types import (
        Formulation,
        Preconditioner,
        SolverConfig,
        TNTParams,
    )

    fields = dict(
        preconditioner=Preconditioner.REGULARIZED_CHOLESKY,
        formulation=Formulation.EXPLICIT,
        dtype=np.float32,
        max_staircase_iterations=CONFIG["max_staircase_iterations"],
        ramp_tcg_iterations=CONFIG["ramp_tcg_iterations"],
        polish_time_budget=CONFIG["polish_time_budget"],
        tnt=TNTParams(max_computation_time=CONFIG["max_computation_time"]),
        use_pallas="never",
    )
    fields.update(kw)
    return SolverConfig(**fields)


class LevelRecorder:
    """Keeps the staircase's TNT solves (XLA path), in call order."""

    def __init__(self):
        from cora_tpu.solve import staircase

        self.levels = []
        self._solve = staircase.tnt_solve

        def recording(*args, **kwargs):
            self.levels.append(self._solve(*args, **kwargs))
            return self.levels[-1]

        staircase.tnt_solve = recording

    def first(self):
        lv = self.levels[0]
        return dict(f=lv.objective_values[:HISTORY_ITERS].tolist(),
                    grad_norm=lv.gradient_norms[:HISTORY_ITERS].tolist())


def level0_f64():
    """The single_drone-shaped run's first level in float64: JAX's canonical
    `tnt_solve` (XLA path) from the fixture's projected rank-5 start, with
    the staircase's first-level arguments and the bench caps. The same
    level from starts one ulp away (`perturbed`) shows how far the JAX
    package's own float64 trajectory holds: for each, the iteration at
    which f first parts from the unperturbed run by more than 1e-12, 1e-8
    and 1e-3 (relative), and where the level ends."""
    import jax.numpy as jnp
    import numpy as np

    from cora_tpu.models.synthetic import synthetic_problem
    from cora_tpu.ops.riemannian import project_to_manifold
    from cora_tpu.solve.tnt import tnt_solve

    g, jump = RUNS["single_drone_shaped"]
    cfg = bench_config(seed=CONFIG["seed"], init_rank_jump=jump)
    problem = synthetic_problem(**g)
    pd = problem.device_data(dtype=np.float64)
    precon = problem.preconditioner_fn(cfg.preconditioner, dtype=np.float64,
                                       max_cond=cfg.reg_chol_max_cond)
    X0 = numpy_start(problem.data_matrix_size, g["dim"] + jump, X0_SEED)

    def level(X):
        return tnt_solve(pd, project_to_manifold(pd, jnp.asarray(X)), precon,
                         cfg.tnt, ramp_iterations=cfg.max_staircase_iterations,
                         ramp_tcg=cfg.ramp_tcg_iterations,
                         lift_grad_norm=cfg.lift_grad_norm,
                         stall_window=cfg.ramp_stall_window,
                         stall_tol=cfg.ramp_stall_tol)

    t0 = time.time()
    res = level(X0)
    wall = time.time() - t0
    rec = dict(graph="single_drone_shaped", rank=g["dim"] + jump,
               f=res.objective_values.tolist(),
               grad_norm=res.gradient_norms.tolist(),
               final_f=float(res.f), final_grad_norm=float(res.gradfx_norm),
               iterations=int(res.num_iterations), status=res.status,
               cpu_wall_s=round(wall, 1), perturbed=[])
    for seed in PERTURB_SEEDS:
        ulp = np.random.default_rng(seed).standard_normal(X0.shape) * 2.0 ** -52
        other = level(X0 * (1.0 + ulp))
        n = min(res.num_iterations, other.num_iterations)
        gap = (np.abs(other.objective_values[:n] - res.objective_values[:n])
               / np.abs(res.objective_values[:n]))
        parts = {}
        for tol in PART_TOLS:
            at = np.flatnonzero(gap > tol)
            parts[f"{tol:g}"] = int(at[0]) + 1 if at.size else None
        rec["perturbed"].append(dict(
            seed=seed, final_f=float(other.f),
            final_grad_norm=float(other.gradfx_norm),
            iterations=int(other.num_iterations), status=other.status,
            parts=parts))
    print("level0_f64", json.dumps({k: v for k, v in rec.items()
                                    if k not in ("f", "grad_norm")}),
          flush=True)
    return rec


def solve_general(name, seed, rec_levels, **kw):
    """`solve_cora` on a multi-robot PyFG graph from the odometry start:
    (problem, result, ATE, CPU wall s); `kw` overrides config fields."""
    import tempfile

    from cora_tpu.io.pyfg import parse_pyfg_python
    from cora_tpu.solve.staircase import extract_solution, solve_cora
    from cora_tpu.types import Initialization
    from cora_tpu.utils.evaluation import evaluate_ate

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, name + ".pyfg")
        with open(path, "w") as fh:
            fh.write(multi_robot_pyfg(**GENERAL[name]))
        problem = parse_pyfg_python(path)
    cfg = bench_config(seed=seed, init_rank_jump=GENERAL_JUMP,
                       initialization=Initialization.ODOMETRY, **kw)
    rec_levels.levels.clear()
    t0 = time.time()
    res = solve_cora(problem, config=cfg)
    wall = time.time() - t0
    ate = float(evaluate_ate(problem, extract_solution(problem, cfg, res)))
    return problem, res, ate, wall


def implicit_runs(recorder):
    """The translation-implicit runs (`implicit`): float64, RegularizedCholesky,
    the bench caps, `formulation=IMPLICIT`, on the XLA path."""
    import numpy as np

    from cora_tpu.models.synthetic import synthetic_problem
    from cora_tpu.solve.staircase import extract_solution, solve_cora
    from cora_tpu.types import Formulation
    from cora_tpu.utils.evaluation import evaluate_ate

    kw = dict(dtype=np.float64, formulation=Formulation.IMPLICIT)

    def record(res, ate, wall):
        return dict(certified=bool(res.certified),
                    sdp_cost=float(res.sdp_cost), f=float(res.result.f),
                    ate=ate, ranks=list(res.ranks_visited),
                    grad_norm_f64=float(res.grad_norm_f64),
                    final_certified=bool(res.final_certified),
                    level0=recorder.first(), cpu_wall_s=round(wall, 1))

    out = {}
    g, jump = PLAZA2, 2
    problem = synthetic_problem(**g)
    height = problem.rot_and_range_matrix_size
    cfg = bench_config(seed=CONFIG["seed"], init_rank_jump=jump, **kw)
    runs = []
    for seed in IMPLICIT_SPREAD_SEEDS:
        x0 = numpy_start(problem.data_matrix_size, g["dim"] + jump,
                         seed)[:height]
        recorder.levels.clear()
        t0 = time.time()
        res = solve_cora(problem, x0=x0, config=cfg)
        wall = time.time() - t0
        ate = float(evaluate_ate(problem,
                                 extract_solution(problem, cfg, res)))
        runs.append(record(res, ate, wall))
        print(f"plaza2_shaped_implicit x0 seed {seed}: " + json.dumps(
            {k: v for k, v in runs[-1].items() if k != "level0"}), flush=True)
    rec = dict(graph=g, init_rank_jump=jump, x0_seed=X0_SEED,
               state_height=height, **runs[0])
    rec["spread"] = dict(x0_seeds=list(IMPLICIT_SPREAD_SEEDS),
                         **{k: [r[k] for r in runs]
                            for k in ("certified", "f", "ate", "ranks")})
    out["plaza2_shaped_implicit"] = rec

    name = "mrclam5a_shaped"
    problem, res, ate, wall = solve_general(name, CONFIG["seed"], recorder,
                                            **kw)
    rec = dict(pyfg=GENERAL[name], init_rank_jump=GENERAL_JUMP,
               initialization="odometry",
               state_height=problem.rot_and_range_matrix_size,
               **record(res, ate, wall))
    print(name + "_implicit", json.dumps(
        {k: v for k, v in rec.items() if k != "level0"}), flush=True)
    out[name + "_implicit"] = rec
    return out


def general_spread(name, recorder, first):
    """The general run `name` from each of SPREAD_SEEDS (`spread`); `first`
    is the run's record at CONFIG's seed, which is not solved again."""
    spread = dict(seeds=list(SPREAD_SEEDS), certified=[], f=[], ate=[],
                  ranks=[])
    for seed in SPREAD_SEEDS:
        rec = first
        if seed != CONFIG["seed"]:
            _, res, ate, wall = solve_general(name, seed, recorder)
            rec = dict(certified=bool(res.certified), f=float(res.result.f),
                       ate=ate, ranks=list(res.ranks_visited))
            print(f"  spread seed {seed}: f {rec['f']:.6f} ATE {ate:.4f} "
                  f"ranks {rec['ranks']} (CPU wall {wall:.1f} s)", flush=True)
        for k in ("certified", "f", "ate", "ranks"):
            spread[k].append(rec[k])
    return spread


def main():
    sys.path.insert(0, REPO)
    args = sys.argv[1:]
    if "--implicit-only" in args or "--general-spread" in args:
        # add (or redo) the `implicit` section, or one general run's
        # `spread`, alone; every other key of the committed file is read
        # and written back unchanged
        with open(OUT) as fh:
            out = json.load(fh)
        if "--implicit-only" in args:
            out["implicit"] = implicit_runs(LevelRecorder())
        else:
            name = args[args.index("--general-spread") + 1]
            rec = out["general"][name]
            rec["spread"] = general_spread(name, LevelRecorder(), rec)
        with open(OUT, "w") as fh:
            json.dump(out, fh, indent=1)
            fh.write("\n")
        return

    import numpy as np

    from cora_tpu.models.synthetic import synthetic_problem
    from cora_tpu.solve.staircase import extract_solution, solve_cora
    from cora_tpu.utils.evaluation import evaluate_ate

    out = {"config": CONFIG, "x0_seed": X0_SEED, "graphs": {}}
    recorder = LevelRecorder()
    levels = recorder.levels

    def solve(problem, g, jump, seed):
        cfg = bench_config(seed=CONFIG["seed"], init_rank_jump=jump)
        x0 = numpy_start(problem.data_matrix_size, g["dim"] + jump, seed)
        t0 = time.time()
        levels.clear()
        res = solve_cora(problem, x0=x0, config=cfg)
        wall = time.time() - t0
        ate = float(evaluate_ate(problem, extract_solution(problem, cfg, res)))
        return res, ate, wall

    for name, (g, jump) in RUNS.items():
        problem = synthetic_problem(**g)
        res, ate, wall = solve(problem, g, jump, X0_SEED)
        rec = dict(
            graph=g,
            init_rank_jump=jump,
            certified=bool(res.certified),
            sdp_cost=float(res.sdp_cost),
            f=float(res.result.f),
            ate=ate,
            ranks=list(res.ranks_visited),
            grad_norm_f64=float(res.grad_norm_f64),
            final_certified=bool(res.final_certified),
            level0=recorder.first(),
        )
        print(name, json.dumps(rec), f"(CPU wall {wall:.1f} s)", flush=True)
        out["graphs"][name] = rec
        if name == "single_drone_shaped":
            spread = dict(x0_seeds=list(SPREAD_SEEDS), certified=[], f=[],
                          ate=[], ranks=[])
            for seed in SPREAD_SEEDS:
                if seed != X0_SEED:
                    res, ate, wall = solve(problem, g, jump, seed)
                spread["certified"].append(bool(res.certified))
                spread["f"].append(float(res.result.f))
                spread["ate"].append(ate)
                spread["ranks"].append(list(res.ranks_visited))
                print(f"  spread x0 seed {seed}: f {res.result.f:.6f} ATE "
                      f"{ate:.4f} (CPU wall {wall:.1f} s)", flush=True)
            rec["spread"] = spread

    out["level0_f64"] = level0_f64()

    out["general"] = {}
    for name in GENERAL:
        problem, res, ate, wall = solve_general(name, CONFIG["seed"],
                                                recorder)
        rec = dict(
            pyfg=GENERAL[name],
            init_rank_jump=GENERAL_JUMP,
            initialization="odometry",
            certified=bool(res.certified),
            sdp_cost=float(res.sdp_cost),
            f=float(res.result.f),
            ate=ate,
            ranks=list(res.ranks_visited),
            grad_norm_f64=float(res.grad_norm_f64),
            final_certified=bool(res.final_certified),
            level0=recorder.first(),
            bandwidth=permuted_bandwidth(
                problem, problem.device_data(dtype=np.float64)),
            cpu_wall_s=round(wall, 1),
        )
        print(name, json.dumps({k: v for k, v in rec.items()
                                if k != "level0"}), flush=True)
        if name in GENERAL_SPREAD:
            rec["spread"] = general_spread(name, recorder, rec)
        out["general"][name] = rec

    out["implicit"] = implicit_runs(recorder)

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")


if __name__ == "__main__":
    main()
