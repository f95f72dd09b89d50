#!/usr/bin/env python3
"""Probe the certificate's LOBPCG, the f64 polish and the saddle escape of
the port on one NVIDIA GPU.

    python3 scripts/probe_cert_loop.py check
    python3 scripts/probe_cert_loop.py split [--tree DIR] [--out FILE]
    python3 scripts/probe_cert_loop.py compare --tree DIR [--out FILE]
    python3 scripts/probe_cert_loop.py loops

`check` builds `small_eigh` and holds it to its plain twin on random
symmetric matrices (n = 30, 31, 36, 96; float32 and float64), times it
against `torch.linalg.eigh` (CUDA events, median of 20), and says whether
`torch.linalg.qr` and `torch.linalg.eigh` of an (N, 3k) / (3k, 3k) tensor
can be captured in a CUDA graph under `set_sync_debug_mode("error")`.

`split` solves `tiers_shaped` and `mrclam5a_shaped` (odometry start) and
the plaza2-shaped graph from rank 2 (after a warm-up solve, as
`chip_smoke.py` phase 3 does) with bench.py's configuration, and splits
each solve's `certify` and `polish_f64` phases (`split_timers`):
  host_matrix    `certificate_matrix_host`
  host_decision  the exact banded Cholesky (`factor_banded(...,
                 require_exact=True)`)
  sigma_factor   the σ-escalation factorizations (`factor_banded`)
  device_factor  the factor's upload
  lobpcg1/2      the two LOBPCG stages
  host_lanczos   the host fallback (`verify_psd_host`)
  newton_cg      the polish's f, gradient and CG (`newton_step`)
  armijo         the polish's Armijo ladder (`probe_ladder`)
each timed on the host clock with the device synchronised at its start and
end, and keyed by the phase it ran in (`certify/lobpcg1`, ...). With
`--tree DIR` the solves run the `cora_tpu_torch` of DIR (a copy of another
version, e.g. the parent commit unpacked with `git archive`).
`compare` runs `split` in turns for DIR, this tree, this tree, DIR, each
in a process of its own, and prints the phases side by side.

`loops` solves `tiers_shaped` once, recording its certificate and polish
calls, then reruns its first failed certificate and its first polish:
captured afresh under the sync check, eagerly (both must end on the
solve's bits), and at LOBPCG / CG blocks of 1, 2, 4 and 8 (what chose
`LOBPCG_BLOCK` and `CG_BLOCK`).
"""

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(REPO, "tests", "data", "torch_port_reference.json")


@contextlib.contextmanager
def split_timers():
    """Time the parts of the solve's phases (see the module docstring)
    while inside; yields the dict of seconds per "phase/part", summed over
    calls (the phase is the staircase's `PhaseTimer` phase the part ran
    in, "setup" outside any), with "phase/part:n" its calls (the CG
    iterations for `newton_cg`, the LOBPCG iterations for the stages of
    the host-driven certificate). Wraps the functions where the solver
    looks them up."""
    import torch

    from cora_tpu_torch.precond import banded
    from cora_tpu_torch.solve import certify, polish, staircase, verification

    totals = {}
    phase = ["setup"]
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)

    def add(part, dt):
        key = f"{phase[-1]}/{part}"
        totals[key] = totals.get(key, 0.0) + dt

    def timed(part_of, fn, count):
        def run(*args, **kwargs):
            sync()
            t0 = time.time()
            part, n = part_of(args, kwargs), 1
            try:
                out = fn(*args, **kwargs)
                n = count(out)
                return out
            finally:  # a factorization that raises is timed too
                sync()
                add(part, time.time() - t0)
                add(part + ":n", n)
        return run

    class PhaseTimer(staircase.PhaseTimer):
        @contextlib.contextmanager
        def __call__(self, name):
            phase.append(name)
            try:
                with super().__call__(name):
                    yield
            finally:
                phase.pop()

    @contextlib.contextmanager
    def scope(name):
        part = {"certify/lobpcg1": "lobpcg1",
                "certify/lobpcg2": "lobpcg2"}.get(name)
        if part is None:
            with real_scope(name):
                yield
            return
        sync()
        t0 = time.time()
        try:
            with real_scope(name):
                yield
        finally:
            sync()
            add(part, time.time() - t0)

    def once(out):
        return 1

    # (module, function, its part, what one call counts in "part:n")
    patches = [
        (verification, "certificate_matrix_host", lambda a, k: "host_matrix",
         once),
        (verification, "verify_psd_host", lambda a, k: "host_lanczos", once),
        (banded, "factor_banded",
         lambda a, k: "host_decision" if k.get("require_exact")
         else "sigma_factor", once),
        (banded, "device_factor", lambda a, k: "device_factor", once),
        # CG iterations
        (polish, "newton_step", lambda a, k: "newton_cg", lambda out: out[5]),
        (polish, "probe_ladder", lambda a, k: "armijo", once),
        (staircase, "saddle_escape", lambda a, k: "escape", once),
    ]
    # the LOBPCG stages: named scopes in the device-loop certificate, two
    # `lobpcg_min` calls (the second preconditioned; iterations counted)
    # before it
    real_scope = getattr(certify, "named_scope", None)
    if real_scope is None:
        patches.append((certify, "lobpcg_min",
                        lambda a, k: "lobpcg2" if k.get("precon") is not None
                        else "lobpcg1", lambda out: out[2]))
    saved = [(mod, name, getattr(mod, name)) for mod, name, *_ in patches]
    saved.append((staircase, "PhaseTimer", staircase.PhaseTimer))
    for mod, name, part_of, count in patches:
        setattr(mod, name, timed(part_of, getattr(mod, name), count))
    staircase.PhaseTimer = PhaseTimer
    if real_scope is not None:
        certify.named_scope = scope
    try:
        yield totals
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        if real_scope is not None:
            certify.named_scope = real_scope


@contextlib.contextmanager
def recording():
    """Record the solve's certificate and polish calls while inside: yields
    the list of (kind, args, kwargs, the problem's σ cache before the call,
    result), kind "certify" or "polish"."""
    from cora_tpu_torch.solve import polish, staircase

    calls = []
    real = {"certify": staircase.certify_solution,
            "polish": polish.polish_solution}

    def certify(problem, *args, **kwargs):
        sigma = getattr(problem, "_cert_sigma_cache", 0.0)
        out = real["certify"](problem, *args, **kwargs)
        calls.append(("certify", (problem,) + args, kwargs, sigma, out))
        return out

    def polish_solution(*args, **kwargs):
        out = real["polish"](*args, **kwargs)
        calls.append(("polish", args, kwargs, None, out))
        return out

    staircase.certify_solution = certify
    polish.polish_solution = polish_solution
    try:
        yield calls
    finally:
        staircase.certify_solution = real["certify"]
        polish.polish_solution = real["polish"]


def first_call(calls, kind):
    """The first recorded call of `kind` that ran its device loop: a
    certificate whose LOBPCG ran (not certified, iterations > 0), or a
    polish."""
    for call in calls:
        if call[0] == kind and (kind == "polish" or (
                not call[4].is_certified and call[4].num_iters > 0)):
            return call
    return None


def rerun(call, **opts):
    """A recorded call again under `device_loop(**opts)` (the σ cache as
    it was before it): (result, wall s, the loop's counts)."""
    import torch

    from cora_tpu_torch.ops import lobpcg
    from cora_tpu_torch.solve import certify, polish
    from cora_tpu_torch.utils.graphs import device_loop

    kind, args, kwargs, sigma, _ = call
    stats = lobpcg.LOOP_STATS if kind == "certify" else polish.LOOP_STATS
    lobpcg.reset_loop_stats()
    polish.reset_loop_stats()
    if kind == "certify":
        args[0]._cert_sigma_cache = sigma
    fn = certify.certify_solution if kind == "certify" \
        else polish.polish_solution
    torch.cuda.synchronize()
    t0 = time.time()
    with device_loop(**opts):
        out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.time() - t0, dict(stats)


def same_result(a, b) -> bool:
    """Two certificate or polish results on the same bits."""
    import numpy as np

    if hasattr(a, "theta"):
        return bool(a.is_certified == b.is_certified and a.theta == b.theta
                    and a.num_iters == b.num_iters
                    and np.array_equal(a.x, b.x)
                    and np.array_equal(a.all_eigvecs, b.all_eigvecs))
    return bool(a.f == b.f and a.grad_norm == b.grad_norm
                and a.iterations == b.iterations and a.status == b.status
                and np.array_equal(a.Y, b.Y))


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def median_ms(fn, reps=20):
    import torch

    times = []
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times[2:])


def captures(fn):
    """(ok, message): fn captured in a CUDA graph, warm-up and capture
    under set_sync_debug_mode('error'), then replayed."""
    import torch

    from cora_tpu_torch.utils.graphs import collector_held

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    g = torch.cuda.CUDAGraph()
    prev = torch.cuda.get_sync_debug_mode()
    try:
        torch.cuda.set_sync_debug_mode("error")
        with torch.cuda.stream(s), collector_held():
            fn()
            g.capture_begin()
            try:
                fn()
            finally:
                g.capture_end()
        torch.cuda.current_stream().wait_stream(s)
        g.replay()
        torch.cuda.synchronize()
        return True, "captured and replayed"
    except Exception as e:  # the answer is the finding, so report it
        torch.cuda.synchronize()
        return False, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def check():
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from cora_tpu_torch.ops import small_eigh as se

    print(card_line(), flush=True)
    t0 = time.time()
    se.load_library()
    print(f"[check] small_eigh built in {time.time() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    out = {}
    for dt in (torch.float32, torch.float64):
        for n in (30, 31, 36, 96):
            M = rng.standard_normal((n, n))
            A = torch.as_tensor(M + M.T).to("cuda", dt)
            w, V, info = se.small_eigh(A)
            wp, Vp, _ = se.small_eigh_plain(A.cpu().double())
            torch.cuda.synchronize()
            scale = float(wp.abs().max())
            ev = float((w.cpu().double() - wp).abs().max()) / scale
            I = torch.eye(n, dtype=dt, device="cuda")
            orth = float((V.T @ V - I).abs().max())
            res = float((A @ V - V * w).abs().max()) / scale
            vec = float((V.cpu().double() - Vp).abs().max())
            ms = median_ms(lambda: se.small_eigh(A))
            lib_ms = median_ms(lambda: torch.linalg.eigh(A))
            out[f"{dt}_{n}"] = dict(ev=ev, orth=orth, res=res, vec=vec,
                                    sweeps=int(info), ms=ms, lib_ms=lib_ms)
            print(f"[check] small_eigh {dt} n={n}: sweeps {int(info)}, "
                  f"eigenvalues rel {ev:.3e}, |VtV-I| {orth:.3e}, "
                  f"|AV-VL|/|L| {res:.3e}, vectors vs twin {vec:.3e}; "
                  f"{ms:.4f} ms against torch.linalg.eigh {lib_ms:.4f} ms",
                  flush=True)
    for dt in (torch.float32, torch.float64):
        for N, n in ((37094, 30), (3556, 36)):
            Z = torch.randn(N, n, dtype=dt, device="cuda")
            ok, msg = captures(lambda: torch.linalg.qr(Z))
            print(f"[check] torch.linalg.qr ({N}, {n}) {dt}: {msg}",
                  flush=True)
            out[f"qr_{dt}_{N}"] = ok
            G = Z.T @ Z
            ok, msg = captures(lambda: torch.linalg.eigh(G))
            print(f"[check] torch.linalg.eigh ({n}, {n}) {dt}: {msg}",
                  flush=True)
            ok2, msg = captures(lambda: se.small_eigh(G))
            print(f"[check] small_eigh ({n}, {n}) {dt}: {msg}", flush=True)
            ok3, msg = captures(lambda: torch.linalg.cholesky_ex(G))
            print(f"[check] torch.linalg.cholesky_ex ({n}, {n}) {dt}: {msg}",
                  flush=True)
    print(json.dumps(out))


def solves():
    """[(name, problem, config, x0, warm-up solves)] of `split`: bench.py's
    configuration with the fixture's caps."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from torch_port_reference import multi_robot_pyfg

    from cora_tpu_torch.io.pyfg import parse_pyfg
    from cora_tpu_torch.models.synthetic import synthetic_problem
    from cora_tpu_torch.types import (
        Initialization,
        Preconditioner,
        SolverConfig,
        TNTParams,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    with open(REFERENCE) as fh:
        ref = json.load(fh)
    C = ref["config"]

    def config(jump, **kw):
        return SolverConfig(
            preconditioner=Preconditioner.REGULARIZED_CHOLESKY,
            dtype=np.float32, init_rank_jump=jump,
            max_staircase_iterations=C["max_staircase_iterations"],
            ramp_tcg_iterations=C["ramp_tcg_iterations"], seed=C["seed"],
            polish_time_budget=C["polish_time_budget"],
            tnt=TNTParams(max_computation_time=C["max_computation_time"]),
            use_kernels="auto", **kw)

    out = []
    for name, rec in ref["general"].items():
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, name + ".pyfg")
            with open(path, "w") as fh:
                fh.write(multi_robot_pyfg(**rec["pyfg"]))
            problem = parse_pyfg(path)
        out.append((name, problem, config(
            rec["init_rank_jump"], initialization=Initialization.ODOMETRY),
            None, 0))
    rec = ref["graphs"]["plaza2_shaped_from_rank_d"]
    problem = synthetic_problem(**rec["graph"])
    x0 = np.random.default_rng(ref["x0_seed"]).uniform(
        -1.0, 1.0, (problem.data_matrix_size, rec["graph"]["dim"]))
    out.append(("plaza2_shaped_from_rank_2", problem,
                config(rec["init_rank_jump"]), x0, 1))
    return out


def split(out_path=None):
    import numpy as np
    import torch

    from cora_tpu_torch.solve import staircase

    results = {}
    for name, problem, cfg, x0, warm in solves():
        for _ in range(warm):
            staircase.solve_cora(problem, x0=x0, config=cfg, device="cuda")
        stats = {}
        with split_timers() as parts:
            for mod, attr in (("cora_tpu_torch.ops.lobpcg", "LOOP_STATS"),
                              ("cora_tpu_torch.solve.polish", "LOOP_STATS")):
                m = sys.modules.get(mod) or __import__(mod, fromlist=["x"])
                if hasattr(m, attr):
                    for k in getattr(m, attr):
                        getattr(m, attr)[k] = 0 if k != "capture_s" else 0.0
            torch.cuda.synchronize()
            t0 = time.time()
            res = staircase.solve_cora(problem, x0=x0, config=cfg,
                                       device="cuda")
            torch.cuda.synchronize()
            wall = time.time() - t0
            for mod, attr, key in (
                    ("cora_tpu_torch.ops.lobpcg", "LOOP_STATS", "lobpcg"),
                    ("cora_tpu_torch.solve.polish", "LOOP_STATS", "cg")):
                m = sys.modules[mod]
                if hasattr(m, attr):
                    stats[key] = dict(getattr(m, attr))
        t_cert = res.elapsed_to_certificate
        results[name] = dict(
            t_cert=t_cert if np.isfinite(t_cert) else wall, wall=wall,
            ranks=res.ranks_visited, certified=res.certified,
            f=res.result.f, phases=dict(res.phases), parts=dict(parts),
            loops=stats)
        print(f"[split] {name}: ranks {res.ranks_visited} certified "
              f"{res.certified} f {res.result.f:.6f} t_cert "
              f"{results[name]['t_cert']:.3f} s wall {wall:.3f} s phases "
              + json.dumps({k: round(v, 4) for k, v in res.phases.items()}),
              flush=True)
        print(f"[split] {name}: certify/polish parts "
              + json.dumps({k: round(v, 4) for k, v in parts.items()})
              + (" loops " + json.dumps(stats) if stats else ""), flush=True)
    line = json.dumps(dict(card=card_line(), results=results))
    print(line)
    if out_path:
        with open(out_path, "w") as fh:
            fh.write(line + "\n")
    return results


def loops_check(blocks=(1, 2, 4, 8)):
    """On tiers_shaped: its first failed certificate and first polish
    captured afresh under the sync check and run eagerly, both on the
    solve's bits; then each at every block size (warm, the second run at
    a size), the LOBPCG stages and the Newton-CG timed."""
    from cora_tpu_torch.solve import staircase
    from cora_tpu_torch.utils.graphs import clear_graphs

    print(card_line(), flush=True)
    name, problem, cfg, x0, _ = solves()[0]
    with recording() as calls:
        staircase.solve_cora(problem, x0=x0, config=cfg, device="cuda")
    for kind in ("certify", "polish"):
        call = first_call(calls, kind)
        clear_graphs()
        out, wall, st = rerun(call, sync_debug=True)
        print(f"[loops] {name} {kind}: captured afresh under "
              f"set_sync_debug_mode('error') in {wall:.3f} s: {st}; on the "
              f"solve's bits: {same_result(out, call[4])}", flush=True)
        clear_graphs()
        out, wall, st = rerun(call, graphs=False)
        print(f"[loops] {name} {kind}: eager {wall:.3f} s: {st}; on the "
              f"solve's bits: {same_result(out, call[4])}", flush=True)
        opt = "lobpcg_block" if kind == "certify" else "cg_block"
        for b in blocks:
            for rep in range(2):
                with split_timers() as parts:
                    out, wall, st = rerun(call, **{opt: b})
            loop_s = sum(v for key, v in parts.items()
                         if key.split("/")[-1] in ("lobpcg1", "lobpcg2",
                                                    "newton_cg"))
            print(f"[loops] {name} {kind} {opt}={b}: warm {wall:.3f} s, "
                  f"loop {loop_s:.4f} s; {st}; same bits "
                  f"{same_result(out, call[4])}", flush=True)


def compare(tree, out_path=None):
    """split in turns: tree, this, this, tree; each in its own process."""
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, which in enumerate((tree, REPO, REPO, tree)):
            out = os.path.join(tmp, f"split_{i}.json")
            cmd = [sys.executable, os.path.abspath(__file__), "split",
                   "--out", out] + (["--tree", which] if which != REPO
                                    else [])
            subprocess.run(cmd, check=True, timeout=900)
            with open(out) as fh:
                runs.append(("parent" if which != REPO else "change",
                             json.load(fh)["results"]))
    print(card_line())
    for name in runs[0][1]:
        for label, res in runs:
            r = res[name]
            print(f"[compare] {name} {label}: t_cert {r['t_cert']:.3f} s "
                  "phases " + json.dumps(
                      {k: round(v, 4) for k, v in r["phases"].items()})
                  + " parts " + json.dumps(
                      {k: round(v, 4) for k, v in r["parts"].items() if v})
                  + (" loops " + json.dumps(r["loops"]) if r["loops"]
                     else ""), flush=True)
    line = json.dumps(dict(card=card_line(), runs=runs))
    if out_path:
        with open(out_path, "w") as fh:
            fh.write(line + "\n")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("check", "split", "compare", "loops"))
    ap.add_argument("--tree", default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if a.mode == "compare":
        compare(os.path.abspath(a.tree), a.out)
        return
    sys.path.insert(0, os.path.abspath(a.tree) if a.tree else REPO)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_cert_loop: no CUDA device")
    if a.mode == "check":
        check()
    elif a.mode == "loops":
        loops_check()
    else:
        split(a.out)


if __name__ == "__main__":
    main()
