"""Experiment entry point: parse → solve → export, for one dataset or a sweep.

The port's counterpart of the JAX package's `examples/run_experiments.py`
and `examples/main.py` (reference `examples/paper_experiments.cpp` and
`run_utils/run_experiments.bash`):

    python -m cora_tpu_torch.experiments --dataset F.pyfg \\
        [--config JSON] [--sweep] [--device cuda]

It takes the same JSON config keys (`init_rank_jump`, `max_rank`,
`preconditioner`, `formulation`, `init_type`, `dtype`, `seed`, `verbose`,
`datasets`, `data_dir`, `output_dir`), prints the same machine-parseable
line per run ("Experiment result, name: …, marginalized: …, t_cert: …",
`paper_experiments.cpp:643-649`), appends it to
`<output_dir>/experiments.txt` and writes the TUM trajectory
`<output_dir>/<name>.tum` (one file per robot). `--sweep` runs the grid
{explicit, implicit} × {random, odom} × init_rank_jump ∈ {0, 1, 2}. The
solve runs on `--device` (the card by default). A failed run prints its
"Experiment FAILED" line, the sweep goes on, and the process then exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import tempfile
import time

import numpy as np

DEFAULT_DATASETS = [
    "plaza1.pyfg",
    "plaza2.pyfg",
    "single_drone.pyfg",
    "tiers.pyfg",
    "mrclam/range_and_rpm/mrclam3b/mrclam3b.pyfg",
    "mrclam/range_and_rpm/mrclam5a/mrclam5a.pyfg",
    "mrclam/range_and_rpm/mrclam6/mrclam6.pyfg",
]


def load_config(path: str | None) -> dict:
    """The default experiment config, updated from the JSON file `path`."""
    cfg = {
        "init_rank_jump": 1,
        "max_rank": 10,
        "preconditioner": "regularized_cholesky",
        "formulation": "explicit",
        "init_type": "random",
        "dtype": "float64",
        "seed": 0,
        "verbose": False,
        "datasets": DEFAULT_DATASETS,
        "data_dir": ".",
        "output_dir": os.path.join(tempfile.gettempdir(),
                                   "cora_tpu_torch_experiments"),
    }
    if path:
        with open(path) as f:
            cfg.update(json.load(f))
    return cfg


def run_one(pyfg_path: str, cfg: dict, results_file=None, device="cuda"):
    """Parse, solve on `device`, print and log the result line, export the
    TUM trajectory; returns (result, solve seconds, ATE)."""
    from cora_tpu_torch.io.exporters import save_solution
    from cora_tpu_torch.io.pyfg import parse_pyfg
    from cora_tpu_torch.models.init import odometry_initialization
    from cora_tpu_torch.solve.staircase import extract_solution, solve_cora
    from cora_tpu_torch.types import Formulation, Preconditioner, SolverConfig
    from cora_tpu_torch.utils.evaluation import evaluate_ate

    name = pathlib.Path(pyfg_path).stem
    problem = parse_pyfg(pyfg_path)
    scfg = SolverConfig(
        max_rank=cfg["max_rank"],
        init_rank_jump=cfg["init_rank_jump"],
        formulation=Formulation(cfg["formulation"]),
        preconditioner=Preconditioner(cfg["preconditioner"]),
        dtype=np.dtype(cfg["dtype"]).type,
        seed=cfg["seed"],
        verbose=cfg["verbose"],
    )

    x0 = None
    if cfg["init_type"] == "odom":
        rank = problem.dim + cfg["init_rank_jump"]
        x0 = odometry_initialization(problem, rank=rank, seed=cfg["seed"])
        if scfg.formulation == Formulation.IMPLICIT:
            x0 = x0[: problem.rot_and_range_matrix_size]

    t0 = time.time()
    res = solve_cora(problem, x0=x0, config=scfg, device=device)
    elapsed = time.time() - t0

    soln = extract_solution(problem, scfg, res)
    ate = evaluate_ate(problem, soln) if problem.pose_gt else float("nan")

    marginalized = scfg.formulation == Formulation.IMPLICIT
    line = (
        f"Experiment result, name: {name}, time: {elapsed:.5f}, "
        f"cost: {res.result.f:.6f}, marginalized: {int(marginalized)}, "
        f"init rank jump: {cfg['init_rank_jump']}, "
        f"init random: {int(cfg['init_type'] == 'random')}, "
        f"certified: {int(res.certified)}, sdp cost: {res.sdp_cost:.6f}, "
        f"suboptimality: {res.suboptimality:.6f}, ate: {ate:.6f}, "
        f"t_cert: {res.elapsed_to_certificate:.5f}"
    )
    print(line, flush=True)
    if results_file:
        results_file.write(line + "\n")
        results_file.flush()

    outdir = pathlib.Path(cfg["output_dir"])
    outdir.mkdir(parents=True, exist_ok=True)
    save_solution(problem, soln, str(outdir / f"{name}.tum"), fmt="tum")
    return res, elapsed, ate


def sweep_grid(cfg: dict) -> list[dict]:
    """{explicit, implicit} × {random, odom} × init_rank_jump ∈ {0, 1, 2}."""
    grid = []
    for form in ("explicit", "implicit"):
        for init in ("random", "odom"):
            for jump in (0, 1, 2):
                grid.append(dict(cfg, formulation=form, init_type=init,
                                 init_rank_jump=jump))
    return grid


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None, help="JSON config path")
    ap.add_argument("--dataset", default=None, help="single .pyfg to run")
    ap.add_argument("--sweep", action="store_true",
                    help="run the full {form}×{init}×{jump} grid")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the solve (default: cuda)")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    datasets = ([args.dataset] if args.dataset else
                [str(pathlib.Path(cfg["data_dir"]) / d)
                 for d in cfg["datasets"]])

    outdir = pathlib.Path(cfg["output_dir"])
    outdir.mkdir(parents=True, exist_ok=True)
    failed = 0
    with open(outdir / "experiments.txt", "a") as results:
        for g in sweep_grid(cfg) if args.sweep else [cfg]:
            for ds in datasets:
                try:
                    run_one(ds, g, results, device=args.device)
                except Exception as e:  # noqa: BLE001 — report, go on
                    failed += 1
                    print(f"Experiment FAILED, name: {pathlib.Path(ds).stem}"
                          f", error: {type(e).__name__}: {e}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
