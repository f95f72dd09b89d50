"""The device loop of the canonical TNT level on a CUDA card: block size,
captured against eager, host reads, busy share.

    python3 scripts/probe_device_loop.py [--blocks 1,2,4,8,16]
        [--graph NAME ...] [--profile-block B] [--out FILE]

For each graph, the staircase's first TNT level (the fixture's bench
configuration, `chip_smoke.bench_config`, with the first level's ramp,
plateau window and lift arguments) from the start `chip_smoke.py` uses:

  * `tiers_shaped` (float32, explicit, odometry start; phase 5);
  * `mrclam5a_shaped` (float32, explicit, odometry start; phase 5);
  * `plaza2_shaped_implicit` (float64, implicit, the fixture's numpy
    start; phase 6).

It runs the level once under `device_loop(sync_debug=True)` at two
iterations (every warm-up, capture and first replay under
`torch.cuda.set_sync_debug_mode("error")`), then at each block size B:
cold (the three captures included) and warm (replays only), with the
wall, captures, replays, host reads, blocks and tCG iterations of each;
then eagerly (`device_loop(graphs=False)`, one tCG iteration per block),
and checks that every run ends on the bits of the first (state, f and the
histories). The level's tCG lengths (its `inner_iterations`) are printed
as a histogram. With `--profile-block B` the warm level at B runs once
more under `torch.profiler` (CUDA activity): its device kernels, their
summed device time and the device-busy share (device time over wall).
One JSON line per graph; `--out` also writes them to FILE.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def level_case(name, reference, device="cuda"):
    """(tnt_solve positional args, keyword args) of the graph's first
    level, as the staircase makes them."""
    import numpy as np
    import torch

    import chip_smoke as smoke
    from cora_tpu_torch.io.pyfg import parse_pyfg
    from cora_tpu_torch.models.init import odometry_initialization
    from cora_tpu_torch.models.synthetic import synthetic_problem
    from cora_tpu_torch.ops.riemannian import project_to_manifold
    from cora_tpu_torch.precond import implicit_precond
    from cora_tpu_torch.types import Formulation, Initialization
    from torch_port_reference import multi_robot_pyfg

    if name in reference["general"]:
        ref = reference["general"][name]
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, name + ".pyfg")
            with open(path, "w") as fh:
                fh.write(multi_robot_pyfg(**ref["pyfg"]))
            problem = parse_pyfg(path)
        cfg = smoke.bench_config(reference, ref["init_rank_jump"], "auto",
                                 initialization=Initialization.ODOMETRY)
        x0 = odometry_initialization(problem, rank=problem.dim
                                     + cfg.init_rank_jump, seed=cfg.seed)
        op = None
    else:
        ref = reference["implicit"][name]
        if ref.get("graph"):
            problem = synthetic_problem(**ref["graph"])
            cfg = smoke.bench_config(reference, ref["init_rank_jump"],
                                     "auto", dtype=np.float64,
                                     formulation=Formulation.IMPLICIT)
            x0 = smoke.numpy_start(reference, problem, problem.dim
                                   + cfg.init_rank_jump)
        else:  # a multi-robot graph of `general`, from the odometry start
            base = reference["general"][name.removesuffix("_implicit")]
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, name + ".pyfg")
                with open(path, "w") as fh:
                    fh.write(multi_robot_pyfg(**base["pyfg"]))
                problem = parse_pyfg(path)
            cfg = smoke.bench_config(reference, ref["init_rank_jump"],
                                     "auto", dtype=np.float64,
                                     formulation=Formulation.IMPLICIT,
                                     initialization=Initialization.ODOMETRY)
            x0 = odometry_initialization(problem, rank=problem.dim
                                         + cfg.init_rank_jump, seed=cfg.seed)
        x0 = x0[:problem.rot_and_range_matrix_size]
        op = problem.operator(cfg.formulation, cfg.dtype, device)
    pd = problem.device_data(dtype=cfg.dtype, device=device)
    precon = problem.preconditioner_fn(cfg.preconditioner, dtype=cfg.dtype,
                                       max_cond=cfg.reg_chol_max_cond,
                                       device=device)
    if op is not None:
        precon = implicit_precond(precon)
    X = project_to_manifold(pd, torch.as_tensor(np.asarray(x0)).to(
        device, pd.dtype())).contiguous()
    kw = dict(ramp_iterations=cfg.max_staircase_iterations,
              ramp_tcg=cfg.ramp_tcg_iterations,
              lift_grad_norm=cfg.lift_grad_norm,
              stall_window=cfg.ramp_stall_window,
              stall_tol=cfg.ramp_stall_tol, op=op)
    return (pd, X, precon, cfg.tnt), kw


def summary(res, wall, stats):
    tcg = max(stats["tcg_iters"], 1)
    return dict(wall_s=round(wall, 4), iterations=res.num_iterations,
                status=res.status, tcg_iters=stats["tcg_iters"],
                us_per_tcg=round(1e6 * wall / tcg, 2),
                captures=stats["captures"],
                capture_s=round(stats["capture_s"], 4),
                replays=stats["replays"], eager_calls=stats["eager_calls"],
                host_reads=stats["host_reads"], blocks=stats["blocks"],
                reads_per_tcg=round(stats["host_reads"] / tcg, 4))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks", default="1,2,4,8,16")
    ap.add_argument("--graph", action="append")
    ap.add_argument("--no-eager", action="store_true")
    ap.add_argument("--profile-block", type=int)
    ap.add_argument("--out")
    a = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_device_loop: no CUDA device available")
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import chip_smoke as smoke
    from cora_tpu_torch.solve import tnt

    smoke.exact_matmuls()
    print("[probe] " + smoke.card_line() + f"; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    with open(smoke.REFERENCE) as fh:
        reference = json.load(fh)
    names = a.graph or ["mrclam5a_shaped", "tiers_shaped",
                        "plaza2_shaped_implicit"]
    lines = []
    for name in names:
        t0 = time.time()
        args, kw = level_case(name, reference)
        out = dict(graph=name, N=args[1].shape[0], rank=args[1].shape[1],
                   dtype=str(args[1].dtype), setup_s=round(time.time() - t0,
                                                           2))
        pd, X, precon, params = args
        short = (pd, X, precon, dataclasses.replace(params, max_iterations=2))
        res, wall, stats = smoke.rerun_level(
            (short, dict(kw, ramp_iterations=0)), sync_debug=True)
        out["sync_debug"] = dict(summary(res, wall, stats), raised=False)
        print(f"[probe] {name}: sync-debug level " + json.dumps(
            out["sync_debug"]), flush=True)
        runs, first = {}, None
        for b in [int(x) for x in a.blocks.split(",")]:
            tnt.clear_graphs()
            cold = smoke.rerun_level((args, kw), block=b)
            warm = smoke.rerun_level((args, kw), block=b)
            first = first or cold[0]
            runs[b] = dict(cold=summary(*cold), warm=summary(*warm),
                           same_bits=smoke.same_level(cold[0], first)
                           and smoke.same_level(warm[0], first))
            print(f"[probe] {name} B={b}: " + json.dumps(runs[b]),
                  flush=True)
        out["blocks"] = runs
        tcg = first.inner_iterations
        out["tcg_lengths"] = {int(v): int(c) for v, c in zip(
            *np.unique(tcg, return_counts=True))}
        print(f"[probe] {name}: tCG lengths {json.dumps(out['tcg_lengths'])}",
              flush=True)
        if not a.no_eager:
            eager = smoke.rerun_level((args, kw), graphs=False)
            out["eager"] = dict(summary(*eager),
                                same_bits=smoke.same_level(eager[0], first))
            print(f"[probe] {name} eager: " + json.dumps(out["eager"]),
                  flush=True)
        if a.profile_block:
            with tnt.device_loop(block=a.profile_block):
                out["busy_share"] = smoke.device_busy("probe", name,
                                                      (args, kw))
        tnt.clear_graphs()
        lines.append(json.dumps(out))
        print(lines[-1], flush=True)
        if a.out:
            os.makedirs(os.path.dirname(os.path.abspath(a.out)),
                        exist_ok=True)
            with open(a.out, "w") as fh:
                fh.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
