#!/usr/bin/env python3
"""Drive the PyTorch port (`cora_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its results before the next starts; any failure
raises and the script exits non-zero:

  1. device — the card's name and power limit (nvidia-smi), the torch and
     CUDA versions, and the build of the CUDA kernels from `ops/csrc/`;
  2. kernels — each of `step`, `tcg`, `chunk` and `ladder` against its
     plain PyTorch version on the card, on the plaza2-shaped graph (2D,
     ranks 4 and 6) and the single_drone-shaped graph (3D, rank 5), with
     the CPU tests' tolerances; both timed (median of 20, CUDA events);
  3. slice — `solve_cora` on both graphs with bench.py's configuration and
     the kernels, from the numpy-seeded start, and on the plaza2-shaped
     graph from rank d (the run that takes a saddle escape), each gated
     against the JAX package's result on the same graph and start
     (`tests/data/torch_port_reference.json`, written by
     `scripts/torch_port_reference.py`), and checked to end on the same
     bits as a warm-up solve from the same start; then the two
     bench-config solves with the plain versions (`use_kernels="never"`)
     on the card. Every solve's first TNT level is also held, iteration
     by iteration over its first chunk, to the JAX run's first level from
     the same projected start: a check that does not depend on where the
     rest of the staircase lands.

The kernels' launch counts are zeroed just before the timed kernel-path
solves and read just after them. The line before the last is one JSON
object with the route, source, launches, error and times of each kernel
the main path launches (`chunk`, `step`, `ladder`; `tcg`, whose loop runs
inside `chunk`, gets a line of its own); the last line is
`{"ok": true, "device": {...}}`. Without a CUDA device the script exits
non-zero before printing any result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
REFERENCE = os.path.join(REPO, "tests", "data", "torch_port_reference.json")
SOURCE = "cora_tpu_torch/ops/csrc/tnt_kernels.cu"
REPLACES = {
    "step": "cora_tpu/ops/pallas_tcg.py:363",
    "tcg": "cora_tpu/ops/pallas_tcg.py:401",
    "chunk": "cora_tpu/ops/pallas_tcg.py:733",
    "ladder": "cora_tpu/ops/pallas_tcg.py:792",
}
# the CPU tests' tolerances (tests/test_torch_kernels_plain.py)
TOL_STATE, TOL_F, TOL_GN, TOL_PGN = 2e-5, 1e-4, 1e-4, 1e-3
TOL_MDEC = TOL_SNORM = 2e-2
# the first TNT level against the JAX run's: f and ‖grad‖ per iteration over
# the first chunk, ten times the CPU test's tolerances (tests/
# test_torch_solve.py) for float32 sums a thousand times longer
FIRST_CHUNK, TOL_LEVEL_F, TOL_LEVEL_GN = 8, 1e-3, 1e-2
REPS = 20
# the kernels the main path launches (`tcg` is the body of `chunk`)
PATH_KERNELS = ("chunk", "step", "ladder")
KERNEL_CASES = [("plaza2_shaped", 4), ("plaza2_shaped", 6),
                ("single_drone_shaped", 5)]


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def absdiff(a, b):
    return float((a - b).abs().max())


def median_ms(fn, torch, prepare=None):
    """Median over REPS of one call's device time (CUDA events)."""
    times = []
    for _ in range(REPS + 2):
        args = prepare() if prepare else ()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn(*args)
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times[2:])


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    if not os.path.isdir(os.path.join(REPO, "cora_tpu_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    sys.path.insert(0, REPO)
    from cora_tpu_torch.ops import tnt_kernels

    t0 = time.time()
    tnt_kernels.load_library()
    build_s = time.time() - t0
    print(smi, flush=True)
    print(f"[device] {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} | CUDA {torch.version.cuda} | python "
          f"{sys.version.split()[0]} | kernels built in {build_s:.1f} s "
          f"({tnt_kernels.BUILD_INFO['path']})", flush=True)


def phase_kernels(problems, hp):
    import numpy as np
    import torch

    from cora_tpu_torch.ops import chain
    from cora_tpu_torch.ops.tnt_kernels import CudaTNT, PlainTNT
    from cora_tpu_torch.solve.tnt_kernel import get_chain_plan

    stats = {k: dict(max_abs_err=0.0, max_rel_err=0.0) for k in REPLACES}

    def note(name, a, b, tol, what):
        e = rel(a, b)
        check(e < tol, f"{name}: {what} rel err {e:.3e} > {tol}")
        s = stats[name]
        s["max_abs_err"] = max(s["max_abs_err"], absdiff(a, b))
        s["max_rel_err"] = max(s["max_rel_err"], e)

    for ci, (gname, rank) in enumerate(KERNEL_CASES):
        problem = problems[gname]
        plan = get_chain_plan(problem, np.float32, "cuda")
        cu, pl = CudaTNT(plan, hp), PlainTNT(plan, hp)
        pd = problem.device_data(np.float32, "cuda")
        gen = torch.Generator().manual_seed(100 + ci)
        Y = chain.random_initial_guess(pd, rank, gen).contiguous()
        V = (0.1 * torch.randn(Y.shape, generator=gen, dtype=torch.float64)
             ).to(Y).contiguous()
        times = {}

        for flag in (1, 0):
            a, b = cu.step(Y, V, flag), pl.step(Y, V, flag)
            note("step", a[0], b[0], TOL_STATE, f"flag {flag} Y")
            note("step", a[2], b[2], TOL_GN, f"flag {flag} grad")
            for i, tol in enumerate((TOL_F, TOL_GN, TOL_PGN)):
                note("step", a[3][i:i + 1], b[3][i:i + 1], tol,
                     f"flag {flag} scalar {i}")
        times["step"] = (median_ms(lambda: cu.step(Y, V, 1), torch),
                         median_ms(lambda: pl.step(Y, V, 1), torch))

        _, QY, G, _ = pl.step(Y, V, False)
        (sa, ta), (sb, tb) = cu.tcg(G, Y, QY, 5.0, 80), pl.tcg(G, Y, QY, 5.0, 80)
        ta, tb = ta.tolist(), tb.tolist()
        check(abs(ta[2] - tb[2]) <= 2, f"tcg iterations {ta[2]} vs {tb[2]}")
        check(ta[1] == tb[1], f"tcg hit {ta[1]} vs {tb[1]}")
        check(abs(ta[0] - tb[0]) <= TOL_MDEC * abs(tb[0]), f"tcg mdec {ta} {tb}")
        check(abs(ta[3] - tb[3]) <= TOL_SNORM * abs(tb[3]), f"tcg |s| {ta} {tb}")
        stats["tcg"]["max_abs_err"] = max(stats["tcg"]["max_abs_err"],
                                         absdiff(sa, sb))
        stats["tcg"]["max_rel_err"] = max(stats["tcg"]["max_rel_err"],
                                         rel(sa, sb))
        times["tcg"] = (median_ms(lambda: cu.tcg(G, Y, QY, 5.0, 80), torch),
                        median_ms(lambda: pl.tcg(G, Y, QY, 5.0, 80), torch))

        def chunk_args():
            fs = torch.tensor([0, 0, 0, 5.0, float("inf"), 1e-4, 0, 0],
                              dtype=torch.float32, device="cuda")
            isc = torch.tensor([0, 0, 0, 0, 0, 8, 80, 60, 24, 10, 1, 0],
                               dtype=torch.int32, device="cuda")
            hist = torch.zeros((5, 80), dtype=torch.float32, device="cuda")
            return (Y.clone(), torch.zeros_like(Y), torch.zeros_like(Y), fs,
                    isc, hist)

        ra, rb = chunk_args(), chunk_args()
        cu.chunk(*ra)
        pl.chunk(*rb)
        check(ra[4][:5].tolist() == rb[4][:5].tolist(),
              f"chunk k/status/streaks {ra[4][:5].tolist()} vs "
              f"{rb[4][:5].tolist()}")
        note("chunk", ra[0], rb[0], TOL_STATE, "Y")
        note("chunk", ra[3][:1], rb[3][:1], TOL_F, "f")
        note("chunk", ra[5][0, :8], rb[5][0, :8], TOL_F, "f history")
        times["chunk"] = (median_ms(cu.chunk, torch, chunk_args),
                          median_ms(pl.chunk, torch, chunk_args))

        al = 4.0 * 0.5 ** np.arange(24)
        al = torch.tensor(np.stack([al, -al], 1).reshape(-1),
                          dtype=torch.float32)
        la, lb = cu.ladder(Y, V, al), pl.ladder(Y, V, al)
        for i, tol in enumerate((TOL_F, TOL_GN, TOL_PGN)):
            note("ladder", la[i], lb[i], tol, f"row {i}")
        times["ladder"] = (median_ms(lambda: cu.ladder(Y, V, al), torch),
                           median_ms(lambda: pl.ladder(Y, V, al), torch))
        torch.cuda.synchronize()
        line = " | ".join(f"{k} {v[0]:.3f} ms (plain {v[1]:.3f} ms)"
                          for k, v in times.items())
        print(f"[kernels] {gname} r={rank}: {line}", flush=True)
        if ci == 0:  # the main path's first level: the reported times
            for k, v in times.items():
                stats[k]["ms"], stats[k]["plain_ms"] = v
    print("[kernels] max errors vs plain: " + " | ".join(
        f"{k} abs {v['max_abs_err']:.3e} rel {v['max_rel_err']:.3e}"
        for k, v in stats.items()), flush=True)
    return stats


def solve_once(problem, cfg, x0, device="cuda"):
    """`solve_cora` from x0: (result, wall s, ATE, the first TNT level's
    result). The staircase's `tnt_solve_tiles` is wrapped for the call to
    keep the level results."""
    import torch

    from cora_tpu_torch.solve import staircase
    from cora_tpu_torch.utils.evaluation import evaluate_ate

    levels = []
    solve_level = staircase.tnt_solve_tiles

    def recording(*args, **kwargs):
        levels.append(solve_level(*args, **kwargs))
        return levels[-1]

    staircase.tnt_solve_tiles = recording
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        res = staircase.solve_cora(problem, x0=x0, config=cfg, device=device)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        staircase.tnt_solve_tiles = solve_level
    ate = float(evaluate_ate(problem,
                             staircase.extract_solution(problem, cfg, res)))
    return res, wall, ate, levels[0]


def check_first_level(name, level, ref):
    """The first TNT level against the JAX run's from the same projected
    start (fixture `level0`): f and ‖grad‖ per iteration over the first
    chunk. Prints how long f stays within TOL_LEVEL_F of the reference
    over the recorded iterations."""
    import numpy as np

    f_ref = np.asarray(ref["level0"]["f"])
    g_ref = np.asarray(ref["level0"]["grad_norm"])
    n = min(len(f_ref), level.num_iterations)
    check(n >= FIRST_CHUNK, f"{name}: first level ran {n} iterations")
    ef = np.abs(level.objective_values[:n] - f_ref[:n]) / np.abs(f_ref[:n])
    eg = np.abs(level.gradient_norms[:n] - g_ref[:n]) / np.abs(g_ref[:n])
    apart = np.flatnonzero(ef > TOL_LEVEL_F)
    print(f"[slice] {name} first level vs JAX: iterations 1-{FIRST_CHUNK} f "
          f"rel err <= {ef[:FIRST_CHUNK].max():.3e}, |grad| rel err <= "
          f"{eg[:FIRST_CHUNK].max():.3e}; f first parts by > {TOL_LEVEL_F} "
          f"at iteration {int(apart[0]) + 1 if apart.size else 'none'} of "
          f"{n} recorded", flush=True)
    check(ef[:FIRST_CHUNK].max() <= TOL_LEVEL_F
          and eg[:FIRST_CHUNK].max() <= TOL_LEVEL_GN,
          f"{name}: first level leaves the JAX trajectory: f rel "
          f"{ef[:FIRST_CHUNK]}, |grad| rel {eg[:FIRST_CHUNK]}")


def gate(name, problem, res, ate, ref):
    """bench.py's gates (bench.py:311-317) against the JAX run on the same
    graph and start: `certified` equal, final cost within 1 %, ATE at most
    0.05 m above, at most 5 levels. The final cost is recomputed here in
    float64 from Q and the returned state, which must lie on the manifold.

    Where the fixture holds a `spread` (the single_drone-shaped graph), the
    JAX package's own rounded estimate moves by far more than 1 % with the
    start (its `f` over five starts), so the port is held to that range
    instead: final cost at most 1 % above, and ATE at most 0.05 m above,
    the worst the JAX package reaches from those starts. A lower cost is a
    better feasible estimate, so it passes."""
    import numpy as np

    from cora_tpu_torch.solve.rounding import check_variables_are_valid

    Y = res.result.x.detach().cpu().double().numpy()
    f64 = 0.5 * float(np.sum(Y * (problem.data_matrix() @ Y)))
    check_variables_are_valid(problem.device_data(np.float64, "cpu"), Y,
                              atol=1e-4)
    spread = ref.get("spread")
    if spread:
        cost_ok = res.result.f <= 1.01 * max(spread["f"])
        ate_ok = ate <= max(spread["ate"]) + 0.05
    else:
        cost_ok = abs(res.result.f - ref["f"]) <= 0.01 * ref["f"]
        ate_ok = ate <= ref["ate"] + 0.05
    gates = {
        "certified_equal": bool(res.certified) == ref["certified"],
        "cost_within_1pct": bool(cost_ok),
        "cost_recomputed_f64": bool(abs(f64 - res.result.f)
                                    <= 1e-4 * abs(res.result.f)),
        "ate_le_ref_plus_0.05": bool(ate_ok),
        "levels_le_5": len(res.ranks_visited) <= 5,
        "finite": bool(np.isfinite(res.result.f) and np.isfinite(ate)),
    }
    check(all(gates.values()), f"{name}: gates {gates}")


def phase_slice(problems, reference):
    import numpy as np
    import torch

    from cora_tpu_torch.ops import tnt_kernels
    from cora_tpu_torch.types import (
        Formulation,
        Preconditioner,
        SolverConfig,
        TNTParams,
    )

    C = reference["config"]
    runs = reference["graphs"]

    def config(name, use_kernels):
        # bench.py:43-62 with the wall-clock caps of the reference run
        return SolverConfig(
            preconditioner=Preconditioner.REGULARIZED_CHOLESKY,
            formulation=Formulation.EXPLICIT,
            dtype=np.float32,
            max_staircase_iterations=C["max_staircase_iterations"],
            ramp_tcg_iterations=C["ramp_tcg_iterations"],
            seed=C["seed"],
            init_rank_jump=runs[name]["init_rank_jump"],
            polish_time_budget=C["polish_time_budget"],
            tnt=TNTParams(max_computation_time=C["max_computation_time"]),
            use_kernels=use_kernels,
        )

    starts = {}
    for name, rec in runs.items():
        rank = rec["graph"]["dim"] + rec["init_rank_jump"]
        starts[name] = np.random.default_rng(reference["x0_seed"]).uniform(
            -1.0, 1.0, (problems[name].data_matrix_size, rank))
    # bench.py's start rank d + 2 for both graphs; the plaza2-shaped run
    # from rank d is the one that fails a certificate and escapes a saddle
    bench = [n for n, rec in runs.items() if rec["init_rank_jump"] == 2]
    warm = {name: solve_once(problems[name], config(name, "auto"),
                             starts[name])[0] for name in bench}
    tnt_kernels.reset_launch_counts()
    results = {name: solve_once(problems[name], config(name, "auto"),
                                starts[name]) for name in runs}
    launches = dict(tnt_kernels.LAUNCHES)
    # the kernels and the float64 polish reduce in a fixed order: a second
    # solve from the same start ends on the same bits
    for name, res in warm.items():
        same = bool(torch.equal(res.result.x, results[name][0].result.x))
        print(f"[slice] {name}: warm-up and timed solve end on the same "
              f"state: {same}", flush=True)
        check(same, f"{name}: two solves from one start differ")
    for name, (res, wall, ate, level) in results.items():
        ref = runs[name]
        check_first_level(name, level, ref)
        gate(name, problems[name], res, ate, ref)
        t_cert = (res.elapsed_to_certificate
                  if np.isfinite(res.elapsed_to_certificate) else wall)
        print(f"[slice] {name} kernels: ranks {res.ranks_visited} certified "
              f"{res.certified} sdp_cost {res.sdp_cost:.6f} f "
              f"{res.result.f:.6f} (reference {ref['f']:.6f}, rel "
              f"{(res.result.f - ref['f']) / ref['f']:+.2e}) grad_norm_f64 "
              f"{res.grad_norm_f64:.3e} final_certified "
              f"{res.final_certified} ATE {ate:.4f} m t_cert {t_cert:.3f} s "
              f"wall {wall:.3f} s phases "
              + json.dumps({k: round(v, 4) for k, v in res.phases.items()}),
              flush=True)
        print(f"[slice] {name} reference (JAX, CPU): " + json.dumps(
            {k: ref[k] for k in ("certified", "sdp_cost", "f", "ate",
                                 "ranks", "spread") if k in ref}), flush=True)
    print(f"[slice] launches in the timed kernel-path solves: "
          f"{json.dumps(launches)}", flush=True)
    for name in bench:
        res, wall, ate, level = solve_once(
            problems[name], config(name, "never"), starts[name])
        check_first_level(name + " (plain)", level, runs[name])
        gate(name + " (plain)", problems[name], res, ate, runs[name])
        print(f"[slice] {name} plain: ranks {res.ranks_visited} certified "
              f"{res.certified} sdp_cost {res.sdp_cost:.6f} f "
              f"{res.result.f:.6f} ATE {ate:.4f} m wall {wall:.3f} s phases "
              + json.dumps({k: round(v, 4) for k, v in res.phases.items()}),
              flush=True)
    return launches


def main():
    phase_device()
    import torch

    from cora_tpu_torch.models.synthetic import synthetic_problem
    from cora_tpu_torch.solve.tnt import HashableParams
    from cora_tpu_torch.types import TNTParams

    with open(REFERENCE) as fh:
        reference = json.load(fh)
    problems = {name: synthetic_problem(**rec["graph"])
                for name, rec in reference["graphs"].items()}
    stats = phase_kernels(problems, HashableParams(TNTParams()))
    launches = phase_slice(problems, reference)
    for name in PATH_KERNELS:
        check(launches[name] > 0,
              f"{name} kernel not launched on the main path: {launches}")

    kernels = [dict(name=k, route="cuda", source=SOURCE, replaces=REPLACES[k],
                    launches=launches[k], max_abs_err=v["max_abs_err"],
                    max_rel_err=v["max_rel_err"], ms=v["ms"],
                    plain_ms=v["plain_ms"])
               for k, v in stats.items()]
    # `tcg` is checked and timed in phase 2, but the main path runs its loop
    # inside `chunk`, not as a launch of its own: the JSON line lists the
    # kernels the path launches
    print("[kernels] tcg (not launched on the main path): " + json.dumps(
        [k for k in kernels if k["name"] not in PATH_KERNELS]), flush=True)
    print(json.dumps({"kernels": [k for k in kernels
                                  if k["name"] in PATH_KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
