"""Where the canonical (general-graph) path's time goes on a CUDA card.

    python3 scripts/profile_torch_general.py [--graph NAME ...] [--out FILE]

Writes each multi-robot graph of `tests/data/torch_port_reference.json`
(`general`: `tiers_shaped`, `mrclam5a_shaped`) as PyFG text with
`multi_robot_pyfg`, parses it with the port's `parse_pyfg` and solves it
once from the odometry start with bench.py's configuration (as
`chip_smoke.py` phase 5 does, on a fresh problem object) under
`torch.profiler` with CUDA activity only (host-op events as well would
double the millions of events the profiler parses after the solve).
Prints per graph, as soon as it is done: the solve's
profiled wall, the device kernels it ran, their summed device time, the
device-busy share (device time over wall, kernels do not overlap on the
one stream), the host wall per kernel, and the ten ops with the most
device time. `--out` also writes the full `key_averages` tables there,
rewritten after each graph. The profiler's own parse of the events is
slow: on an H100 host, `tiers_shaped` (a 105 s profiled solve, 4.1 million
kernels) and `mrclam5a_shaped` took 19 minutes together.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(REPO, "tests", "data", "torch_port_reference.json")


def _device_us(e) -> float:
    """An averaged event's own device time in µs (the attribute's name
    changed across torch versions)."""
    v = getattr(e, "self_device_time_total", None)
    return float(v if v is not None else e.self_cuda_time_total)


def profile_graph(name, ref, config):
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cora_tpu_torch.io.pyfg import parse_pyfg
    from cora_tpu_torch.solve.staircase import solve_cora
    from cora_tpu_torch.types import (
        Initialization,
        Preconditioner,
        SolverConfig,
        TNTParams,
    )
    from torch_port_reference import multi_robot_pyfg

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, name + ".pyfg")
        with open(path, "w") as fh:
            fh.write(multi_robot_pyfg(**ref["pyfg"]))
        problem = parse_pyfg(path)
    cfg = SolverConfig(
        preconditioner=Preconditioner.REGULARIZED_CHOLESKY,
        dtype=np.float32,
        max_staircase_iterations=config["max_staircase_iterations"],
        ramp_tcg_iterations=config["ramp_tcg_iterations"],
        seed=config["seed"],
        init_rank_jump=ref["init_rank_jump"],
        polish_time_budget=config["polish_time_budget"],
        tnt=TNTParams(max_computation_time=config["max_computation_time"]),
        initialization=Initialization.ODOMETRY,
    )
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        res = solve_cora(problem, config=cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
    avg = prof.key_averages()
    dev = ([e for e in avg if e.device_type == DeviceType.CUDA]
           or [e for e in avg
               if _device_us(e) > 0 and not e.self_cpu_time_total])
    n_kernels = sum(e.count for e in dev)
    device_s = sum(_device_us(e) for e in dev) * 1e-6
    top = sorted(avg, key=_device_us, reverse=True)[:10]
    summary = dict(
        graph=name, ranks=res.ranks_visited, certified=bool(res.certified),
        f=res.result.f, profiled_wall_s=round(wall, 3),
        device_kernels=n_kernels, device_s=round(device_s, 3),
        busy_share=round(device_s / wall, 4),
        host_us_per_kernel=round(wall / max(n_kernels, 1) * 1e6, 2),
        phases={k: round(v, 4) for k, v in res.phases.items()},
        top_device=[dict(op=e.key[:80], count=e.count,
                         device_s=round(_device_us(e) * 1e-6, 3))
                    for e in top])
    return summary, avg


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--graph", action="append",
                    help="a graph of the fixture's `general` (default: all)")
    ap.add_argument("--out", help="file for the full key_averages tables")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_general: no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    with open(REFERENCE) as fh:
        reference = json.load(fh)
    names = args.graph or list(reference["general"])
    tables = []
    for name in names:
        summary, avg = profile_graph(name, reference["general"][name],
                                     reference["config"])
        print(json.dumps(summary), flush=True)
        if args.out:
            key = ("self_device_time_total"
                   if hasattr(avg[0], "self_device_time_total")
                   else "self_cuda_time_total")
            tables.append(f"== {name}\n" + avg.table(sort_by=key,
                                                     row_limit=60))
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as fh:
                fh.write("\n\n".join(tables))


if __name__ == "__main__":
    main()
