"""Visualization entry point: parse → solve → draw, for one PyFG file.

The port's counterpart of the JAX package's `examples/visualize.py`
(reference `examples/data_viz.py` and the `CORA_vis` app, without
Pangolin):

    python -m cora_tpu_torch.visualize data/plaza2.pyfg out.png
    python -m cora_tpu_torch.visualize data/plaza2.pyfg out.gif --animate
    python -m cora_tpu_torch.visualize data/plaza2.pyfg calib.png --calibration

It takes the same arguments (`dataset output [--animate] [--calibration]
[--fps N] [--max-frames N]`) and runs the same flow: `--calibration` draws
the range-measurement calibration plots with no solve; otherwise
`SolverConfig(seed=0, log_iterates=--animate)` → `solve_cora` → the
animation of the logged TNT iterates, or the rounded, gauge-aligned
solution as a still titled with the cost and the certificate. The solve
runs on `--device` (the card by default) in the config's float64, as the
JAX CLI's does, so on the canonical path. matplotlib is imported only by
the drawing (`io.viz`), so `solve` runs without it.
"""

from __future__ import annotations

import argparse
import os
import sys


def solve(dataset: str, animate: bool = False, device="cuda",
          verbose: bool = True):
    """Parse `dataset` and solve it as the CLI does: (problem, config,
    result)."""
    from cora_tpu_torch.io.pyfg import parse_pyfg
    from cora_tpu_torch.solve.staircase import solve_cora
    from cora_tpu_torch.types import SolverConfig

    problem = parse_pyfg(dataset)
    cfg = SolverConfig(seed=0, log_iterates=animate)
    res = solve_cora(problem, config=cfg, verbose=verbose, device=device)
    return problem, cfg, res


def draw(problem, cfg, res, dataset: str, output: str, animate: bool = False,
         fps: int = 10, max_frames: int = 100) -> None:
    """The animation of the solve's iterates, or the solution's still."""
    from cora_tpu_torch.io.viz import animate_iterates, plot_solution
    from cora_tpu_torch.solve.staircase import extract_solution

    if animate:
        animate_iterates(problem, res.result.iterates, output, cfg, fps=fps,
                         max_frames=max_frames)
        return
    soln = extract_solution(problem, cfg, res)
    plot_solution(
        problem, soln, output, show_gt=bool(problem.pose_gt),
        title=f"{os.path.basename(dataset)} "
              f"(cost {res.result.f:.3f}, certified {res.certified})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dataset")
    ap.add_argument("output")
    ap.add_argument("--animate", action="store_true",
                    help="render the solve's TNT iterates as an animation")
    ap.add_argument("--calibration", action="store_true",
                    help="range-measurement calibration plots (no solve)")
    ap.add_argument("--fps", type=int, default=10)
    ap.add_argument("--max-frames", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the solve (default: cuda)")
    args = ap.parse_args(argv)
    if not os.path.isfile(args.dataset):
        print(f"visualize: no dataset {args.dataset}", file=sys.stderr)
        return 2

    if args.calibration:
        from cora_tpu_torch.io.pyfg import parse_pyfg
        from cora_tpu_torch.io.viz import plot_range_calibration

        plot_range_calibration(parse_pyfg(args.dataset), args.output)
    else:
        problem, cfg, res = solve(args.dataset, args.animate, args.device)
        draw(problem, cfg, res, args.dataset, args.output, args.animate,
             args.fps, args.max_frames)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
