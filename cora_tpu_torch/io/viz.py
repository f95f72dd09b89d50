"""Solution / iterate visualization (reference `CORA_vis` equivalent).

The reference's optional visualization subsystem (`src/CORA_vis.cpp`,
`include/CORA/CORA_vis.h`) replays logged TNT iterates in a Pangolin
window: every iterate is rounded + gauge-aligned
(`projectAndAlignIterates`, `CORA_vis.h:18-45`), poses/landmarks/ranges
are drawn, and the display decimates to at most 5000 poses and 2000
ranges (`CORA_vis.cpp`). As the JAX package's `cora_tpu/io/viz.py` does,
this renders the same content offline with matplotlib — PNG stills of a
solution and GIF/MP4 animations of the solve — which also covers the
reference's `examples/data_viz.py` helper (odometry/range animation +
range-measurement calibration plots) without its external PyFactorGraph
dependency. matplotlib is imported when a plot is drawn, never at import.

Environment: `CORA_MAX_LOOPS` bounds GIF loop count the way it bounds
playback loops in the reference (`CORA_vis.cpp:79-85`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cora_tpu_torch.graph.problem import Problem
from cora_tpu_torch.solve.rounding import (
    align_estimate_to_origin,
    project_solution,
)

# display decimation, matching the reference's caps (`src/CORA_vis.cpp`)
MAX_VIZ_POSES = 5000
MAX_VIZ_RANGES = 2000


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def project_and_align_iterates(problem: Problem, iterates, config=None):
    """Round + gauge-align every logged TNT iterate (reference
    `CORAVis::projectAndAlignIterates`, `src/CORA_vis.cpp`).

    Iterates logged in the translation-implicit formulation are lifted to
    the explicit state first (translations recovered on the host in
    float64). Returns a list of (N, d) aligned arrays.
    """
    from cora_tpu_torch.types import Formulation, SolverConfig

    config = config or SolverConfig()
    pd = problem.device_data(dtype=np.float64, device="cpu")
    out = []
    for Y in iterates:
        Y = np.asarray(Y, np.float64)
        if (
            config.formulation == Formulation.IMPLICIT
            and Y.shape[0] == pd.rot_range_size
        ):
            op = problem.operator(config.formulation, dtype=np.float64,
                                  device="cpu")
            Y = op.implicit.translation_explicit_solution(
                torch.as_tensor(Y)).numpy()
        if Y.shape[1] > problem.dim:
            Y = project_solution(pd, Y)
        out.append(align_estimate_to_origin(pd, Y))
    return out


def _decimate(idx_count: int, cap: int) -> np.ndarray:
    if idx_count <= cap:
        return np.arange(idx_count)
    return np.linspace(0, idx_count - 1, cap).astype(int)


def _soln_points(problem: Problem, soln: np.ndarray):
    """Pose positions per robot, landmark positions, range endpoint pairs."""
    d = problem.dim
    tr0 = problem.rot_and_range_matrix_size
    trans = np.asarray(soln)[tr0:, :d]

    robots = {}
    for ch in problem.robot_chars():
        syms = problem.pose_symbols(ch)
        rows = np.asarray([problem.pose_symbol_idxs[s] for s in syms])
        rows = rows[_decimate(len(rows), MAX_VIZ_POSES)]
        robots[ch] = trans[rows]

    landmarks = (
        trans[problem.num_poses:]
        if problem.num_landmarks
        else np.zeros((0, d))
    )

    ranges = []
    keep = set(_decimate(len(problem.range_measurements), MAX_VIZ_RANGES))
    for k, m in enumerate(problem.range_measurements):
        if k not in keep:
            continue
        i = problem.translation_idx(m.first_id) - tr0
        j = problem.translation_idx(m.second_id) - tr0
        ranges.append((trans[i], trans[j]))
    return robots, landmarks, ranges


def plot_solution(
    problem: Problem,
    soln: np.ndarray,
    path: str | None = None,
    show_ranges: bool = True,
    show_gt: bool = False,
    title: str | None = None,
):
    """Render a rank-d solution: per-robot trajectories, landmarks, range
    edges (the reference's render content, `CORA_vis.cpp` drawing loop).

    Returns the matplotlib figure; saves to `path` when given.
    """
    plt = _mpl()
    d = problem.dim
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d" if d == 3 else None)

    robots, landmarks, ranges = _soln_points(problem, soln)

    if show_ranges:
        for a, b in ranges:
            seg = np.stack([a, b])
            ax.plot(*seg.T, color="0.8", lw=0.3, zorder=1)
    for ch, traj in robots.items():
        ax.plot(*traj.T, lw=1.0, label=f"robot {ch}", zorder=2)
    if len(landmarks):
        ax.scatter(*landmarks.T, marker="*", s=120, color="tab:red",
                   label="landmarks", zorder=3)
    if show_gt and problem.pose_gt:
        from cora_tpu_torch.utils.evaluation import gt_trajectory

        gt = gt_trajectory(problem)
        gt = gt - gt.mean(axis=0, keepdims=True)
        ax.plot(*gt.T, color="k", lw=0.6, ls="--", label="ground truth",
                zorder=2)

    ax.set_aspect("equal" if d == 2 else "auto")
    ax.legend(loc="best", fontsize=8)
    if title:
        ax.set_title(title)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def animate_iterates(
    problem: Problem,
    iterates,
    path: str,
    config=None,
    fps: int = 10,
    max_frames: int = 100,
    show_ranges: bool = False,
):
    """Animate a solve from its logged TNT iterates (the reference's
    playback loop, `CORA_vis.cpp::dataPlaybackLoop/renderLoop`) into a
    GIF/MP4 at `path`. Run the solve with `SolverConfig(log_iterates=True)`.
    """
    plt = _mpl()
    from matplotlib import animation

    aligned = project_and_align_iterates(problem, iterates, config)
    frames = [aligned[i] for i in _decimate(len(aligned), max_frames)]
    if not frames:
        raise ValueError("no iterates to animate (set log_iterates=True)")

    d = problem.dim
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d" if d == 3 else None)

    all_pts = np.concatenate([f[problem.rot_and_range_matrix_size:, :d]
                              for f in (frames[0], frames[-1])])
    lo, hi = all_pts.min(axis=0), all_pts.max(axis=0)
    pad = 0.1 * np.maximum(hi - lo, 1e-6)

    artists = {}

    def draw(k):
        ax.cla()
        robots, landmarks, ranges = _soln_points(problem, frames[k])
        if show_ranges:
            for a, b in ranges:
                seg = np.stack([a, b])
                ax.plot(*seg.T, color="0.85", lw=0.3)
        for ch, traj in robots.items():
            ax.plot(*traj.T, lw=1.0, label=f"robot {ch}")
        if len(landmarks):
            ax.scatter(*landmarks.T, marker="*", s=120, color="tab:red")
        ax.set_xlim(lo[0] - pad[0], hi[0] + pad[0])
        ax.set_ylim(lo[1] - pad[1], hi[1] + pad[1])
        if d == 3:
            ax.set_zlim(lo[2] - pad[2], hi[2] + pad[2])
        else:
            ax.set_aspect("equal")
        ax.set_title(f"iterate {k + 1}/{len(frames)}")
        return []

    max_loops = int(os.environ.get("CORA_MAX_LOOPS", "0"))
    anim = animation.FuncAnimation(
        fig, draw, frames=len(frames), interval=1000 / fps, blit=False
    )
    if path.endswith(".gif"):
        writer = animation.PillowWriter(fps=fps)
        # PillowWriter loops forever by default; CORA_MAX_LOOPS bounds it
        anim.save(path, writer=writer)
        if max_loops:
            try:
                from PIL import Image

                im = Image.open(path)
                im.save(path, save_all=True, loop=max_loops)
            except (ImportError, OSError):
                pass  # the GIF keeps PillowWriter's endless loop
    else:
        anim.save(path, fps=fps)
    plt.close(fig)
    return path


def play_iterates(
    problem: Problem,
    iterates,
    config=None,
    fps: int = 10,
    max_frames: int = 200,
    show_ranges: bool = False,
    block: bool = True,
):
    """LIVE playback window of a solve's TNT iterates — the interactive
    analog of the reference's two-thread render/playback visualization
    (`src/CORA_vis.cpp:55` thread spawn + `dataPlaybackLoop`): frames are
    drawn at `fps` into an interactive matplotlib window while the
    program continues (set ``block=False`` to return immediately after
    scheduling the animation; the reference's render thread equivalent).
    Falls back gracefully under a non-interactive backend (Agg): every
    frame is still rendered, which is what the smoke test exercises.

    Run the solve with ``SolverConfig(log_iterates=True)`` first.
    """
    plt = _mpl()

    aligned = project_and_align_iterates(problem, iterates, config)
    frames = [aligned[i] for i in _decimate(len(aligned), max_frames)]
    if not frames:
        raise ValueError("no iterates to play (set log_iterates=True)")

    d = problem.dim
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d" if d == 3 else None)
    all_pts = np.concatenate([f[problem.rot_and_range_matrix_size:, :d]
                              for f in (frames[0], frames[-1])])
    lo, hi = all_pts.min(axis=0), all_pts.max(axis=0)
    pad = 0.1 * np.maximum(hi - lo, 1e-6)

    def draw(k):
        ax.cla()
        robots, landmarks, ranges = _soln_points(problem, frames[k])
        if show_ranges:
            for a, b in ranges:
                seg = np.stack([a, b])
                ax.plot(*seg.T, color="0.85", lw=0.3)
        for ch, traj in robots.items():
            ax.plot(*traj.T, lw=1.0, label=f"robot {ch}")
        if len(landmarks):
            ax.scatter(*landmarks.T, marker="*", s=120, color="tab:red")
        ax.set_xlim(lo[0] - pad[0], hi[0] + pad[0])
        ax.set_ylim(lo[1] - pad[1], hi[1] + pad[1])
        if d == 3:
            ax.set_zlim(lo[2] - pad[2], hi[2] + pad[2])
        else:
            ax.set_aspect("equal")
        ax.set_title(f"iterate {k + 1}/{len(frames)}")

    interactive = plt.get_backend().lower() not in ("agg", "pdf", "svg")
    if interactive:
        plt.ion()
        fig.show()
    for k in range(len(frames)):
        draw(k)
        if interactive:
            fig.canvas.draw_idle()
            fig.canvas.flush_events()
            plt.pause(1.0 / fps)
        else:
            fig.canvas.draw()
    if interactive and block:
        plt.ioff()
        plt.show()
    else:
        plt.close(fig)
    return len(frames)


def plot_range_calibration(problem: Problem, path: str | None = None):
    """Range-measurement calibration: measured range vs ground-truth
    distance, plus the residual histogram (the reference's
    `examples/data_viz.py` calibration plots).
    """
    plt = _mpl()
    if not problem.pose_gt:
        raise ValueError("problem has no ground truth for calibration")

    measured, true = [], []
    for m in problem.range_measurements:
        a, b = m.first_id, m.second_id

        def gt_pos(s):
            if s in problem.pose_gt:
                return problem.pose_gt[s][1]
            return problem.landmark_gt[s]

        try:
            pa, pb = gt_pos(a), gt_pos(b)
        except KeyError:
            continue
        measured.append(m.r)
        true.append(np.linalg.norm(pa - pb))
    measured = np.asarray(measured)
    true = np.asarray(true)

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 5))
    ax1.scatter(true, measured, s=4, alpha=0.4)
    lim = [0, max(true.max(), measured.max()) * 1.05]
    ax1.plot(lim, lim, "k--", lw=0.8)
    ax1.set_xlabel("ground-truth distance [m]")
    ax1.set_ylabel("measured range [m]")
    ax1.set_title("range calibration")

    resid = measured - true
    ax2.hist(resid, bins=60)
    ax2.set_xlabel("range residual [m]")
    ax2.set_title(
        f"residuals: mean {resid.mean():.3f}, std {resid.std():.3f}"
    )
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig
