"""One run of one cell: set-up, the measured window of solves, the
reference's comparison and the metrics.

A solve is what a user of `python -m cora_tpu_torch.experiments` waits
for: `parse_pyfg` on a graph file, `solve_cora` with the cell's
`SolverConfig` and a start, and `extract_solution`. Each solve parses a
fresh `Problem`, so none reuses another's captured graphs or factors.

A run solves the traffic's fixed set of (graph, start) pairs
(`core/cell.pool`), in an order drawn from `--seed`: how long a solve takes
moves with its graph's noise and its start far more than between two runs
of one, so every run does the same work. The window holds whole passes
over the set: a pass starts only while `seconds` have not passed, and the
window ends when the last pass ends.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

from benchmark.core import cell as cells
from benchmark.core import trace as tracing

TNT_KERNELS = ("step", "tcg", "chunk", "ladder")


@dataclasses.dataclass
class Solve:
    """What one solve left: its times, counts and outputs (kept as the
    program returned them until the window has closed)."""

    k: str  # "<pass>.<entry of the set>", or "warm-up"
    entry: int = -1
    wall_s: float = 0.0
    parse_s: float = 0.0
    levels: list = dataclasses.field(default_factory=list)
    certs: list = dataclasses.field(default_factory=list)
    rounded: bool = False
    result: object = None
    Q: object = None
    estimate: object = None
    Y_cert: object = None
    path_error: str = ""
    error: str = ""
    numbers: dict = dataclasses.field(default_factory=dict)
    ok: bool = False
    profiled: bool = False

    def certified_point(self):
        """The point whose certificate ended the staircase: the last
        certified call before the rounding (after it, the rank-d
        estimate's certificate)."""
        before = [c for c in self.certs if not c[0] and c[2]]
        if not before:
            return None
        Y = before[-1][1]
        return np.asarray(Y.detach().cpu().numpy() if hasattr(Y, "detach")
                          else Y, np.float64)


class Recorder:
    """Wraps the staircase's level solvers, its certificate calls and its
    rounding, to keep each level's rank and iteration counts and the points
    certified, as `chip_smoke.solve_once` does."""

    NAMES = ("tnt_solve_tiles", "tnt_solve", "_certify_with_retry",
             "project_solution")

    def __init__(self):
        self.current = Solve(k="")

    @contextlib.contextmanager
    def installed(self):
        from cora_tpu_torch.solve import staircase

        orig = {n: getattr(staircase, n) for n in self.NAMES}

        def level(fn):
            def run(*args, **kw):
                res = fn(*args, **kw)
                self.current.levels.append(dict(
                    refine=self.current.rounded, rank=int(args[1].shape[1]),
                    tcg=int(np.sum(res.inner_iterations)),
                    outer=int(res.num_iterations)))
                return res
            return run

        def certify(problem, pd, Y, eta, cert_p, bootstrap):
            cert = orig["_certify_with_retry"](problem, pd, Y, eta, cert_p,
                                               bootstrap)
            self.current.certs.append(
                (self.current.rounded, Y, bool(cert.is_certified)))
            return cert

        def rounding(*args, **kw):
            self.current.rounded = True
            return orig["project_solution"](*args, **kw)

        patched = {"tnt_solve_tiles": level(orig["tnt_solve_tiles"]),
                   "tnt_solve": level(orig["tnt_solve"]),
                   "_certify_with_retry": certify,
                   "project_solution": rounding}
        for n, fn in patched.items():
            setattr(staircase, n, fn)
        try:
            yield self
        finally:
            for n, fn in orig.items():
                setattr(staircase, n, fn)


def solve_once(cell: cells.Cell, path: str, start_seed: int, k: str,
               device: str, rec: Recorder, traced: bool) -> Solve:
    """One user's solve of the graph file at `path`, its start (and
    `SolverConfig.seed`) from `start_seed`."""
    import torch

    from cora_tpu_torch.io.pyfg import parse_pyfg
    from cora_tpu_torch.ops import tnt_kernels
    from cora_tpu_torch.solve.staircase import (
        extract_solution,
        kernel_path_reason,
        solve_cora,
    )

    span = tracing.span if traced else (lambda name: contextlib.nullcontext())
    out = rec.current = Solve(k=k)
    cfg = cells.solver_config(cell, start_seed)
    launches = dict(tnt_kernels.LAUNCHES)
    cuda = device == "cuda"
    try:
        t0 = time.perf_counter()
        with span(tracing.OUTER):
            with span("bench.parse"):
                problem = parse_pyfg(path)
            out.parse_s = time.perf_counter() - t0
            x0 = cells.start(cell, problem.data_matrix_size, problem.dim,
                             start_seed)
            with span("bench.solve_cora"):
                res = solve_cora(problem, x0=x0, config=cfg, device=device)
            with span("bench.extract"):
                est = extract_solution(problem, cfg, res)
                if cuda:
                    torch.cuda.synchronize()
        out.wall_s = time.perf_counter() - t0
    except Exception:  # a solve that raises is a failed answer; go on
        out.error = traceback.format_exc()
        print(f"[bench] solve {k} raised:\n{out.error}", file=sys.stderr)
        return out
    out.result, out.estimate, out.Q = res, est, problem.data_matrix()
    reason = kernel_path_reason(cfg, problem.device_data(cfg.dtype, device))
    ran = {n: tnt_kernels.LAUNCHES[n] - launches[n] for n in TNT_KERNELS}
    took = "chain" if reason is None else "canonical"
    if took != cell.path or (cuda and took == "chain" and not ran["chunk"]) \
            or (took == "canonical" and any(ran.values())):
        out.path_error = (f"solve {k} took the {took} path ({reason}), "
                          f"launches {ran}; the cell runs {cell.path}")
        print(f"[bench] {out.path_error}", file=sys.stderr)
    return out


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: cells.Cell
    setup_s: float
    window_s: float
    solves: list
    graphs: list  # the reference's `Graph` of each entry of the set
    Q_refs: list
    peaks: dict
    trace: dict | None
    timed: list  # the window's solves, whose spans the per-layer metrics average


def read_metric(name: str, run: Run):
    path = cells.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def peaks_of(cell: cells.Cell, kind: str, traced: bool) -> dict:
    """The card's peaks (`peaks/<kind>.json`); a traced run of a cell that
    reports a roofline fails without them."""
    path = cells.BENCH / "peaks" / f"{kind.replace(' ', '_')}.json"
    if path.exists():
        return cells.read_json(path)
    if traced and any(m["name"].endswith("_roofline") for m in cell.per_layer):
        raise RuntimeError(f"no peaks for {kind!r}: add {path.name} under "
                           f"benchmark/peaks/")
    return {}


def load_libraries(cell: cells.Cell) -> float:
    """Build (on a checkout's first run) and load the port's native
    libraries that the cell's solves call; their seconds, which set-up
    includes."""
    from cora_tpu_torch.native import NativeBuildError, pyfg_fast
    from cora_tpu_torch.ops import small_eigh, tnt_kernels

    t0 = time.perf_counter()
    try:
        pyfg_fast._lib()
    except NativeBuildError:  # parse_pyfg falls back to Python, as a user's
        pass
    small_eigh.load_library()
    if cell.path == "chain":
        tnt_kernels.load_library()
    return time.perf_counter() - t0


def run(cell: cells.Cell, seed: int, seconds: float, traced: bool,
        device: str, t_process: float) -> dict:
    """Set up, measure, compare; the result line's object."""
    import torch

    from benchmark.reference import check
    from benchmark.reference import problem as ref_problem
    from benchmark.reference.pyfg import parse as ref_parse

    cuda = device == "cuda"
    t_graphs = time.perf_counter()
    work = cells.pool(cell)
    texts = [cells.graph_text(cell, noise) for noise, _ in work]
    t_graphs = time.perf_counter() - t_graphs
    rec = Recorder()
    with tempfile.TemporaryDirectory() as tmp, rec.installed():
        paths = []
        for j, text in enumerate(texts):
            paths.append(os.path.join(tmp, f"{cell.config['name']}_{j}.pyfg"))
            with open(paths[-1], "w") as f:
                f.write(text)
        # set-up: builds and loads the kernels and the parser, and warms
        # every path of a solve on the cell's graphs, from a start of its own
        build_s = load_libraries(cell) if cuda else 0.0
        t_warm = time.perf_counter()
        warm = solve_once(cell, paths[0], cell.traffic["pool"]["warm_up_seed"],
                          "warm-up", device, rec, False)
        warm_failed = bool(warm.error)
        del warm
        gc.collect()
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.time() - t_process
        print(f"[bench] set-up {setup_s:.3f} s: graphs {t_graphs:.3f} s, "
              f"libraries {build_s:.3f} s, warm-up solve "
              f"{time.perf_counter() - t_warm:.3f} s", file=sys.stderr)

        solves, summary = [], {}
        t_open = time.perf_counter()
        n_pass = 0
        while n_pass == 0 or time.perf_counter() - t_open < seconds:
            for j in cells.order(seed, len(work), n_pass):
                s = solve_once(cell, paths[j], work[j][1], f"{n_pass}.{j}",
                               device, rec, False)
                s.entry = j
                solves.append(s)
            n_pass += 1
        window_s = time.perf_counter() - t_open
        if traced:
            # the traced run profiles one more solve once the window has
            # closed, of the set's `traced_entry`, the same in every run: the
            # window's solves, which the span metrics average, run undisturbed
            j = cell.traffic["pool"]["traced_entry"]
            with tracing.profiled(summary):
                s = solve_once(cell, paths[j], work[j][1], f"traced.{j}",
                               device, rec, True)
            s.entry, s.profiled = j, True
            solves.append(s)

    device_info = {}
    if cuda:
        device_info = {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(0),
                       "count": cell.chips,
                       "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
                       "build_s": build_s}
    for s in solves:  # the program's outputs, then its state freed
        s.Y_cert = s.certified_point()
        s.certs = []
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    graphs = [ref_parse(text) for text in texts]
    Q_refs = [ref_problem.data_matrix(g) for g in graphs]
    cert_params = cell.config["solver"]["cert"]
    for s in solves:
        if s.error:
            continue
        s.numbers = check.judge(graphs[s.entry], Q_refs[s.entry], cert_params,
                                outputs(s))
        ok, _ = check.verdict(s.numbers, cell.limits)
        s.ok = ok and not s.path_error
        print(f"[bench] solve {s.k}: {s.wall_s:.6f} s, parse {s.parse_s:.6f} "
              f"s, ranks {s.result.ranks_visited}, phases "
              + ", ".join(f"{n} {v:.6f}" for n, v in s.result.phases.items())
              + "; " + ", ".join(f"{n} {v:.6g}" for n, v in s.numbers.items()),
              file=sys.stderr)
    worst = check.worst([s.numbers for s in solves])
    ok, shown = check.verdict(worst, cell.limits)
    correct = bool(solves) and ok and not warm_failed \
        and all(s.ok for s in solves)

    kind = device_info.get("kind", "")
    timed = [s for s in solves if not s.error and not s.profiled]
    run_ = Run(cell=cell, setup_s=setup_s, window_s=window_s, solves=solves,
               graphs=graphs, Q_refs=Q_refs,
               peaks=peaks_of(cell, kind, traced) if cuda else {},
               trace=summary or None,
               timed=timed or [s for s in solves if not s.error])
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = read_metric(m["name"], run_)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if traced and summary:
        device_info.update(busy_s=summary["busy_s"],
                           window_s=summary["window_s"])
    result = {"correct": correct, "attempted": len(solves),
              "failed": sum(not s.ok for s in solves), "metrics": metrics,
              "device": device_info}
    if traced and summary:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = shown
    return result


def outputs(s: Solve) -> dict:
    """The program's outputs that the reference judges."""
    res = s.result
    return {"Q": s.Q, "certified": bool(res.certified),
            "final_certified": bool(res.final_certified),
            "sdp_cost": float(res.sdp_cost), "Y_cert": s.Y_cert,
            "final_f": float(res.result.f), "estimate": s.estimate}


def print_result(result: dict) -> None:
    for n, v in result["checks"].items():
        print(f"check {n}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
