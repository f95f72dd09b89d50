#!/usr/bin/env python3
"""The `small_eigh` kernels alone on one NVIDIA GPU: build, bits and times.

    python3 scripts/probe_small_eigh.py [--split] [--parent FILE] [--sass DIR]
                                        [--out FILE] [--quick] [--define X]
                                        [--stream] [--cert RANK]

Builds only `cora_tpu_torch/ops/csrc/small_eigh.cu` (seconds): the
package's library, whose one-warp kernel has 3 update warps, and beside it
the same source with `-DSMALL_EIGH_UPDATE_WARPS=1, 2, 4` (one nvcc each, in
parallel). Prints nvcc's `-Xptxas -v` lines of the package's kernels, then:
  (a) bits: on the seeded corpus of `small_eigh_cases.corpus` (random
      symmetric, graded Qᵀ diag(λ) Q with λ over 1e-3 … 1e5 and a
      near-degenerate pair at the bottom, a repeated-eigenvalue and a
      zero-block matrix, one with a NaN) at n = 10, 12, 30, 31, 32, 36, 64,
      96 in float32 and float64, batch 1 and 4, the routed `small_eigh`
      and the cluster family (`small_eigh_cluster`, forced at n ≤ 32)
      against the one-CTA kernel (`small_eigh_cta`), and at n ≤ 32 the
      one-warp kernel of every update-warp count, and the grid forced on
      its CTAs (9 to 49 here); at n = 97, 99, 150, 198, 246, 320, 321,
      324, 384 and 448 the routed cluster family against the global kernel
      (`small_eigh_global`), so that each cluster size the route picks (1,
      2, 4, 8, 16 CTAs) is checked at an n it is picked for, and at 449,
      456, 516, 768 and 1056 the grid (113, 114, 129, 128, 132 CTAs; past n =
      320 the random, graded and NaN cases, batch 2 only to 516), and the
      stream route (`small_eigh_stream`) forced wherever n ≥ 5 and n ≤
      1056 against the same comparator, and routed at 1062, 1200 and 1536
      against the global kernel (the random and NaN cases; the global
      kernel takes ~11, ~17 and ~35 s a call there):
      `torch.equal` on the bits of w, V and info, counted per case; the
      eigenvalues' error against `torch.linalg.eigh` in float64;
  (b) times: median of 20 single calls (CUDA events around each, as
      `chip_smoke.py` times) of the one-CTA kernel, the one-warp kernel of
      each update-warp count (`warp<w>_ms`) and `torch.linalg.eigh`, in
      turns (one-CTA, warp, warp, one-CTA), at n = 10, 30, 36 in both
      dtypes, with the sweeps taken; and each kernel's device ms per call
      over 50 calls back to back (`loop_ms`); the cluster family and the
      grid against their comparator in turns (new, old, old, new; the
      one-CTA kernel at n = 36, the global one at n = 99, 150, 198, 246,
      324, 448 and 516; median of 5 past n = 96, of 3 past 320) in
      float32, beside `torch.linalg.eigh`, with the CTA count; the stream
      route at n = 1062, 1536 and 2112 (median of 3) beside
      `torch.linalg.eigh`, and the global kernel once at 1062;
  (c) with `--split`: builds with `-DSMALL_EIGH_SPLIT` (never set by the
      package's build), whose one-warp kernel stamps `clock64()` in each
      round: the cycles per round of the rotation warp (the next round's
      entries and rotations), of update warp 0 and of its wait at the
      round's barrier, and per stop test, at n = 10 and 30 for each
      update-warp count; and whose cluster family stamps, at n = 99, 198,
      246 and 324, and grid at 516 and 1056: per round the look-ahead
      warp's body (the next round's entries
      and rotations, and their stores into every CTA's table) and its wait
      at the round's barrier, the first update warp's body and its wait;
      per sweep the stop test; the A kernel's whole run, and the V kernel's
      (the time V lags behind A: it runs after it) and its staging of the
      log, and the sort kernel's; and whose stream route stamps, at n =
      1062 and 2112 (107 and 132 CTAs), per round the table's import (the
      round's first loads of A in flight), warp 0's body (the log and the
      look-ahead) and update warp 1's, thread 0's wait at the barrier, per
      sweep the stop test, and the three kernels.
`--stream` runs the stream route alone: bits (forced at n = 5-1056
against the one-CTA kernel, the global kernel and the grid, routed at
1062 against the global kernel), times and, with `--split`, its split
and, in turns with the grid (grid, stream, stream, grid; median of 3,
float32), the stream route forced at n = 516, 768 and 1056 (~3 min of
command). `--cert RANK` reruns `chip_smoke.py` phase 3b's
certificate at RANK with its 3k × 3k matrices forced to the global kernel
(rank 352: ~2.7 minutes) and nothing else.
`--quick` runs (a) only, on fewer cases, each call of a kernel new to the
card waited on with a timeout (a hang shows as such): the first call's
check. `--define X` (repeatable) builds the source with `-DX` too, holds
that build's cluster family to the comparators in (a) and times it in
turns with the package's in (b). With `--parent FILE`, another version's `small_eigh.cu` (the one-CTA
kernel's C interface before its rename, `cora_small_eigh_f32/f64`) is
built too and held to both kernels of this tree bit for bit on the same
corpus. With `--sass DIR`, `cuobjdump -sass` of the package's library goes
to DIR/small_eigh.sass. Prints the card's name and power limit first and,
last, one JSON object of all the numbers. Exits non-zero without a CUDA
device or when a result differs from its comparator's.
"""

import argparse
import concurrent.futures
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
from small_eigh_cases import bits_equal, corpus, ptxas_lines  # noqa: E402

SIZES = (10, 12, 30, 31, 32, 36, 64, 96)
# past the one-CTA kernel: the cluster family against the global kernel,
# routed to 1 CTA (97, 99), 2 (150), 4 (198), 8 (246, 320) and 16 (321,
# 324, 384, 448); the grid routed at 449 (113 CTAs, the last of one pair),
# 456 (114), 516 (129), 768 (128) and 1056 (132)
GLOBAL_SIZES = (97, 99, 150, 198, 246, 320, 321, 324, 384, 448, 449, 456,
                516, 768, 1056)
# past the grid: the stream route against the global kernel (~11, ~17 and
# ~35 s a call there), the random and the NaN case
STREAM_SIZES = (1062, 1200, 1536)
STREAM_CASES = ("random", "nonfinite")
# past these, fewer cases (the global kernel takes seconds a call)
LARGE_N = 320
LARGE_CASES = ("random", "graded", "nonfinite")
TIMED = (10, 30, 36)
# the cluster family and the grid timed against their comparator
# (float32), at 1, 1, 2, 4, 8 and 16 CTAs, and on the grid's 22
CLUSTER_TIMED = (36, 99, 150, 198, 246, 324, 448, 516)
SPLIT = (10, 30)
# the cluster family's and the grid's clock64() split, at 1, 4, 8 and 16
# CTAs and on the grid's 22 and 106
CLUSTER_SPLIT = (99, 198, 246, 324, 516, 1056)
# the stream route's split (107 and 132 CTAs) and times (median of 3,
# beside torch.linalg.eigh)
STREAM_SPLIT = (1062, 2112)
STREAM_TIMED = (1062, 1536, 2112)
# the stream route forced where the grid is routed, in turns with it
STREAM_FORCED_TIMED = (516, 768, 1056)
HANG_S = 60  # a first call of a kernel not done by then has hung
WIDTHS = (1, 2, 3, 4)  # update warps of the one-warp kernel; the package: 3
REPS = 20


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def median_ms(fn, torch, reps=REPS):
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


def loop_ms(fn, torch, count=50):
    """Device ms per call over `count` calls back to back (the queue stays
    full when a call's host work is shorter than its kernel)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(count):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / count


def build(se, defines):
    """nvcc the package's source with `-D<define>`s into its own library
    (once per source hash and flags), bound with ctypes."""
    from cora_tpu_torch.ops.tnt_kernels import compile_library

    so, _ = compile_library("probe_small_eigh", (se.SOURCE,), se.SOURCE,
                            se.NVCC_FLAGS + tuple(f"-D{d}" for d in defines))
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.cora_small_eigh_warp_f32, lib.cora_small_eigh_warp_f64):
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
        fn.restype = ci
    return lib


def run_warp(lib, A, torch, se):
    """(w, V, info) of `lib`'s one-warp kernel on A (n, n) or (B, n, n),
    as `small_eigh` allocates and launches them."""
    n = A.shape[-1]
    Ab = A.reshape(-1, n, n).contiguous()
    w = torch.empty((Ab.shape[0], n), dtype=A.dtype, device=A.device)
    V = torch.empty_like(Ab)
    info = torch.empty(Ab.shape[0], dtype=torch.int32, device=A.device)
    fn = lib.cora_small_eigh_warp_f32 if A.dtype == torch.float32 \
        else lib.cora_small_eigh_warp_f64
    err = fn(Ab.data_ptr(), w.data_ptr(), V.data_ptr(), info.data_ptr(),
             Ab.shape[0], n, se.MAX_SWEEPS,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"one-warp kernel failed: CUDA error {err}")
    lead = A.shape[:-2]
    return w.reshape(*lead, n), V.reshape(A.shape), info.reshape(lead)


def waited(torch, fn):
    """fn()'s result, its kernels waited on with a timeout: an event
    polled, so that a hang raises instead of blocking."""
    out = fn()
    ev = torch.cuda.Event()
    ev.record()
    t0 = time.time()
    while not ev.query():
        if time.time() - t0 > HANG_S:
            raise SystemExit(f"probe_small_eigh: a kernel ran past {HANG_S} s")
        time.sleep(0.01)
    return out


def run_cluster(lib, A, torch, se):
    """(w, V, info) of `lib`'s cluster family on A (n, n), as `small_eigh`
    allocates and launches it."""
    n = A.shape[-1]
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.cora_small_eigh_cluster_f32 if A.dtype == torch.float32 \
        else lib.cora_small_eigh_cluster_f64
    fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp, vp]
    lib.cora_small_eigh_cluster_work.argtypes = [ci, ci]
    lib.cora_small_eigh_cluster_work.restype = ctypes.c_longlong
    w = torch.empty(n, dtype=A.dtype, device=A.device)
    V = torch.empty_like(A)
    info = torch.empty(1, dtype=torch.int32, device=A.device)
    work = torch.empty(lib.cora_small_eigh_cluster_work(n, se.MAX_SWEEPS),
                       dtype=torch.float64, device=A.device)
    err = fn(A.data_ptr(), w.data_ptr(), V.data_ptr(), info.data_ptr(), 1, n,
             se.MAX_SWEEPS, work.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"cluster kernel failed: CUDA error {err}")
    return w, V, info.reshape(())


variant_libs = {}  # --define builds, their cluster family checked in (a)
variant_same = {}


def check_bits(torch, se, libs, quick=False):
    """(a): per (n, dtype, batch, case), whether the routed result, the
    cluster family's and every update-warp count's equal the one-CTA
    kernel's (n ≤ 96) or the global kernel's (n > 96) bit for bit; and the
    eigenvalues' error against float64 eigh."""
    rows, failed = [], []
    for n in SIZES + GLOBAL_SIZES + STREAM_SIZES:
        mats = [corpus(n, s) for s in range(4 if n <= LARGE_N else 2)]
        old = "cta" if n <= se.MAX_N else "global"
        for dt in (torch.float32, torch.float64):
            for batch in ((1,) if quick or n > 516 else (1, len(mats))):
                for name in mats[0]:
                    if quick and name not in ("random", "nonfinite"):
                        continue
                    if n > LARGE_N and name not in LARGE_CASES:
                        continue
                    if n > se.GRID_MAX_N and name not in STREAM_CASES:
                        continue
                    A = torch.as_tensor(np.stack([m[name] for m in mats[:batch]])
                                        if batch > 1 else mats[0][name]
                                        ).to("cuda", dt)
                    routed = waited(torch, lambda: se.small_eigh(A))
                    cta = se.small_eigh(A, kernel=old)
                    same = bits_equal(routed, cta)
                    if 3 <= n <= se.WARP_MAX_N:
                        same = same and bits_equal(waited(
                            torch, lambda: se.small_eigh(
                                A, kernel="cluster")), cta)
                    if 3 <= n <= se.CLUSTER_MAX_N and se.grid_size(n):
                        # the grid forced (9 to 49 CTAs here)
                        same = same and bits_equal(waited(
                            torch, lambda: se.small_eigh(A, kernel="grid")),
                            cta)
                    if se.STREAM_MIN_N <= n <= se.GRID_MAX_N:
                        # the stream route forced (2 to 132 CTAs here)
                        same = same and bits_equal(waited(
                            torch, lambda: se.small_eigh(
                                A, kernel="stream")), cta)
                    if n <= se.WARP_MAX_N and not quick:
                        same = same and all(bits_equal(
                            run_warp(libs[w], A, torch, se), cta)
                            for w in WIDTHS)
                    err = None
                    if name != "nonfinite":
                        w64 = torch.linalg.eigh(A.double())[0]
                        err = float(((routed[0].double() - w64).abs().amax(-1)
                                     / w64.abs().amax(-1)).max())
                    rows.append(dict(n=n, dtype=str(dt)[6:], batch=batch,
                                     case=name, route=se.route(n, dt),
                                     against=old, same=same,
                                     clusters=se.cluster_size(n)
                                     or se.grid_size(n) or se.stream_size(n),
                                     sweeps=routed[2].reshape(-1).tolist(),
                                     eig_err=err))
                    if not same:
                        failed.append((n, str(dt)[6:], batch, name))
                        print(f"[bits] differ n={n} {dt} {name}: " + ", ".join(
                            f"{lab} {float((x.double() - y.double()).abs().nan_to_num(0).max()):.3e}"
                            for lab, x, y in zip(("w", "V", "info"), routed, cta)),
                            flush=True)
                    for d, lib in variant_libs.items():
                        if n >= 3 and n <= se.CLUSTER_MAX_N and batch == 1:
                            ok = bits_equal(run_cluster(lib, A, torch, se), cta)
                            variant_same.setdefault(d, []).append(ok)
    return rows, failed


def time_kernels(torch, se, libs):
    """(b): the kernels in turns, per (n, dtype)."""
    out = []
    for n in TIMED:
        for dt in (torch.float32, torch.float64):
            A = torch.as_tensor(corpus(n)["random"]).to("cuda", dt)
            row = dict(n=n, dtype=str(dt)[6:],
                       sweeps=int(se.small_eigh(A, kernel="cta")[2]))

            def cta():
                return se.small_eigh(A, kernel="cta")

            def warp(w):
                return lambda: run_warp(libs[w], A, torch, se)

            row["cta_ms"] = [median_ms(cta, torch)]
            if n <= se.WARP_MAX_N:
                for w in WIDTHS:
                    row[f"warp{w}_ms"] = [median_ms(warp(w), torch)
                                          for _ in range(2)]
            row["cta_ms"].append(median_ms(cta, torch))
            row["routed_ms"] = median_ms(lambda: se.small_eigh(A), torch)
            row["eigh_ms"] = median_ms(lambda: torch.linalg.eigh(A), torch)
            row["loop_ms"] = {"cta": loop_ms(cta, torch)}
            if n <= se.WARP_MAX_N:
                for w in WIDTHS:
                    row["loop_ms"][f"warp{w}"] = loop_ms(warp(w), torch)
            out.append(row)
            print(f"[times] n={n} {row['dtype']}: " + json.dumps(
                {k: v for k, v in row.items() if k not in ("n", "dtype")}),
                flush=True)
    return out


def time_cluster(torch, se):
    """(b): the cluster family against its comparator in turns (cluster,
    old, old, cluster), float32, beside torch.linalg.eigh."""
    out = []
    rng = np.random.default_rng(11)
    for n in CLUSTER_TIMED:
        M = rng.standard_normal((n, n))
        A = torch.as_tensor(M + M.T).to("cuda", torch.float32)
        old = "cta" if n <= se.MAX_N else "global"
        new = "grid" if n > se.CLUSTER_MAX_N else "cluster"
        reps = REPS if n <= se.MAX_N else 5 if n <= 320 else 3
        run = {k: (lambda k=k: se.small_eigh(A, kernel=k))
               for k in (new, old)}
        t = [median_ms(run[k], torch, reps)
             for k in (new, old, old, new)]
        row = dict(n=n, dtype="float32", route=new,
                   clusters=se.cluster_size(n) or se.grid_size(n),
                   sweeps=int(se.small_eigh(A)[2]), against=old,
                   turns_ms=t, cluster_ms=(t[0] + t[3]) / 2,
                   old_ms=(t[1] + t[2]) / 2,
                   eigh_ms=median_ms(lambda: torch.linalg.eigh(A), torch,
                                     reps))
        for d, lib in (variant_libs.items() if new == "cluster" else ()):
            # --define builds' cluster family, in turns
            t2 = [median_ms(f, torch, reps) for f in (
                run["cluster"], lambda: run_cluster(lib, A, torch, se),
                lambda: run_cluster(lib, A, torch, se), run["cluster"])]
            row[f"vs_{d}_turns_ms"] = t2
        out.append(row)
        print(f"[times] cluster n={n}: {json.dumps(row)}", flush=True)
    return out


def cluster_split(torch, se, lib):
    """(c): the cluster family's and the grid's clock64() stamps (matrix 0,
    CTA 0), per round, per stop test and per kernel, from the
    -DSMALL_EIGH_SPLIT build."""
    out = []
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.cora_small_eigh_cluster_f32, lib.cora_small_eigh_grid_f32):
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp, vp]
    lib.cora_small_eigh_cluster_work.argtypes = [ci, ci]
    lib.cora_small_eigh_cluster_work.restype = ctypes.c_longlong
    lib.cora_small_eigh_grid_work.argtypes = [ci, ci, ci]
    lib.cora_small_eigh_grid_work.restype = ctypes.c_longlong
    for n in CLUSTER_SPLIT:
        A = torch.as_tensor(corpus(n)["random"]).to("cuda", torch.float32)
        w = torch.empty(n, dtype=A.dtype, device="cuda")
        V = torch.empty_like(A)
        info = torch.empty(1, dtype=torch.int32, device="cuda")
        grid = n > se.CLUSTER_MAX_N
        words = (lib.cora_small_eigh_grid_work(n, se.MAX_SWEEPS, 1) if grid
                 else lib.cora_small_eigh_cluster_work(n, se.MAX_SWEEPS))
        work = torch.empty(words, dtype=torch.float64, device="cuda")
        launch = (lib.cora_small_eigh_grid_f32 if grid
                  else lib.cora_small_eigh_cluster_f32)
        err = launch(
            A.data_ptr(), w.data_ptr(), V.data_ptr(), info.data_ptr(), 1, n,
            se.MAX_SWEEPS, work.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"split cluster kernel: CUDA error {err}")
        torch.cuda.synchronize()
        clk = (ctypes.c_longlong * 12)()
        err = lib.cora_small_eigh_cluster_split_clocks(clk)
        if err:
            raise RuntimeError(f"split clocks: CUDA error {err}")
        c = list(clk)
        rounds = max(c[0], 1)
        row = dict(n=n, route="grid" if grid else "cluster",
                   clusters=se.cluster_size(n) or se.grid_size(n), rounds=c[0],
                   sweeps=int(info), lookahead=c[1] / rounds,
                   lookahead_wait=c[2] / rounds, update=c[3] / rounds,
                   update_wait=c[4] / rounds,
                   stop_test=c[5] / max(c[6], 1), a_kernel=c[7],
                   v_kernel=c[8], v_staging=c[9], sort_kernel=c[10])
        out.append(row)
        print(f"[split] cluster {json.dumps(row)}", flush=True)
    return out


def time_stream(torch, se):
    """(b): the stream route at STREAM_TIMED (median of 3 calls, float32)
    beside torch.linalg.eigh; the global kernel, its comparator, one call
    at the first n."""
    out = []
    rng = np.random.default_rng(11)
    for n in STREAM_TIMED:
        M = rng.standard_normal((n, n))
        A = torch.as_tensor(M + M.T).to("cuda", torch.float32)
        row = dict(n=n, dtype="float32", route=se.route(n, A.dtype),
                   ctas=se.stream_size(n), sweeps=int(se.small_eigh(A)[2]),
                   stream_ms=median_ms(lambda: se.small_eigh(A), torch, 3),
                   eigh_ms=median_ms(lambda: torch.linalg.eigh(A), torch, 3))
        if n == STREAM_TIMED[0]:
            row["global_ms"] = median_ms(
                lambda: se.small_eigh(A, kernel="global"), torch, 1)
        out.append(row)
        print(f"[times] stream n={n}: {json.dumps(row)}", flush=True)
    return out


def time_stream_vs_grid(torch, se):
    """`--stream`'s turns: the stream route forced where the grid is routed
    (STREAM_FORCED_TIMED), grid, stream, stream, grid (median of 3 calls
    each), float32, beside the CTAs of each."""
    out = []
    rng = np.random.default_rng(11)
    for n in STREAM_FORCED_TIMED:
        M = rng.standard_normal((n, n))
        A = torch.as_tensor(M + M.T).to("cuda", torch.float32)
        runs = {"grid": lambda: se.small_eigh(A, kernel="grid"),
                "stream": lambda: se.small_eigh(A, kernel="stream")}
        turns = [(k, median_ms(runs[k], torch, 3))
                 for k in ("grid", "stream", "stream", "grid")]
        row = dict(n=n, dtype="float32", grid_ctas=se.grid_size(n),
                   stream_ctas=se.stream_size(n),
                   sweeps=int(se.small_eigh(A)[2]),
                   grid_ms=[t for k, t in turns if k == "grid"],
                   stream_ms=[t for k, t in turns if k == "stream"])
        out.append(row)
        print(f"[times] stream vs grid n={n}: {json.dumps(row)}", flush=True)
    return out


def stream_split(torch, se, lib):
    """(c): the stream route's clock64() stamps (matrix 0, CTA 0) per round
    (warp 0's log and look-ahead, update warp 1's body, thread 0's barrier
    after its own body, the table's import), per stop test and per kernel,
    from the -DSMALL_EIGH_SPLIT build."""
    out = []
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.cora_small_eigh_stream_f32.argtypes = [vp, vp, vp, vp, ci, ci, ci,
                                               vp, vp]
    lib.cora_small_eigh_stream_work.argtypes = [ci, ci, ci]
    lib.cora_small_eigh_stream_work.restype = ctypes.c_longlong
    for n in STREAM_SPLIT:
        A = torch.as_tensor(corpus(n)["random"]).to("cuda", torch.float32)
        w = torch.empty(n, dtype=A.dtype, device="cuda")
        V = torch.empty_like(A)
        info = torch.empty(1, dtype=torch.int32, device="cuda")
        work = torch.empty(lib.cora_small_eigh_stream_work(n, se.MAX_SWEEPS, 1),
                           dtype=torch.float64, device="cuda")
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        err = lib.cora_small_eigh_stream_f32(
            A.data_ptr(), w.data_ptr(), V.data_ptr(), info.data_ptr(), 1, n,
            se.MAX_SWEEPS, work.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        t1.record()
        if err:
            raise RuntimeError(f"split stream kernel: CUDA error {err}")
        torch.cuda.synchronize()
        clk = (ctypes.c_longlong * 8)()
        clu = (ctypes.c_longlong * 12)()
        if lib.cora_small_eigh_stream_split_clocks(clk) \
                or lib.cora_small_eigh_cluster_split_clocks(clu):
            raise RuntimeError("split clocks: CUDA error")
        c, u = list(clk), list(clu)
        rounds = max(c[0], 1)
        row = dict(n=n, route="stream", ctas=se.stream_size(n), rounds=c[0],
                   sweeps=int(info), call_ms=t0.elapsed_time(t1),
                   lookahead=c[1] / rounds, update=c[2] / rounds,
                   barrier=c[3] / rounds, import_=c[4] / rounds,
                   stop_test=c[5] / max(c[6], 1), stop_tests=c[6],
                   a_kernel=c[7], v_kernel=u[8], v_staging=u[9],
                   sort_kernel=u[10])
        out.append(row)
        print(f"[split] stream {json.dumps(row)}", flush=True)
    return out


def stream_bits(torch, se):
    """`--stream`'s bits: the stream route forced against the one-CTA
    kernel (n = 5, 36, 96), the global kernel (n = 99) and the grid (516,
    1056), routed against the global kernel at 1062; float32 and float64,
    the random and graded cases (the random only past 96)."""
    rows, failed = [], []
    for n, old in ((5, "cta"), (36, "cta"), (96, "cta"), (99, "global"),
                   (516, "grid"), (1056, "grid"), (1062, "global")):
        for dt in (torch.float32, torch.float64):
            for name in ("random", "graded") if n <= 96 else ("random",):
                A = torch.as_tensor(corpus(n)[name]).to("cuda", dt)
                new = waited(torch, lambda: se.small_eigh(A, kernel="stream"))
                same = bits_equal(new, se.small_eigh(A, kernel=old))
                rows.append(dict(n=n, dtype=str(dt)[6:], case=name,
                                 against=old, same=same))
                print(f"[bits] stream {json.dumps(rows[-1])}", flush=True)
                if not same:
                    failed.append((n, str(dt)[6:], name))
    return rows, failed


def cert_against_global(torch, se, rank):
    """`--cert RANK`: `chip_smoke.py` phase 3b's failed certificate at a
    random point at `rank` on the plaza2-shaped graph, as routed, then
    again with its 3k × 3k Rayleigh–Ritz matrices forced to the global
    kernel: the same verdict and θ within `chip_smoke.CERT_THETA_TOL`
    (relative), each run's LOBPCG as replayed graphs, with its launches and
    seconds."""
    import chip_smoke as cs

    from cora_tpu_torch.models.synthetic import synthetic_problem

    with open(cs.REFERENCE) as fh:
        reference = json.load(fh)
    problem = synthetic_problem(**reference["graphs"]["plaza2_shaped"]["graph"])
    pd = problem.device_data(np.float32, "cuda")
    cfg = cs.cert_config(reference)
    Y = cs.cert_point(pd, rank)
    k = max(cfg.cert.lobpcg_block_size, rank + 2)
    out = dict(rank=rank, n=3 * k, route=se.KEYS[se.route(3 * k, torch.float32)])
    runs = {}
    for label, force in (("routed", None), ("global", "global")):
        cert, took, lp = cs.certificate_run(problem, pd, cfg, Y, force_3k=force)
        runs[label] = cert
        out[label] = dict(certified=bool(cert.is_certified),
                          theta=float(cert.theta), iterations=cert.num_iters,
                          seconds=took, replays=lp["replays"],
                          eager_calls=lp["eager_calls"],
                          launches={k2: v for k2, v in se.LAUNCHES.items() if v})
        print(f"[cert] rank {rank} {label}: {json.dumps(out[label])}",
              flush=True)
    a, b = runs["routed"], runs["global"]
    out["theta_rel"] = abs(a.theta - b.theta) / max(abs(b.theta), 1e-30)
    out["ok"] = bool(a.is_certified == b.is_certified
                     and out["theta_rel"] <= cs.CERT_THETA_TOL
                     and out["global"]["launches"].get("small_eigh_global", 0) > 0
                     and out["routed"]["replays"] > 0
                     and not out["routed"]["eager_calls"])
    print(f"[cert] {json.dumps(out)}", flush=True)
    return out


def round_split(torch, se, libs):
    """(c): cycles per round of the rotation, the update and the barriers,
    from the `-DSMALL_EIGH_SPLIT` builds' clock64() stamps (matrix 0)."""
    out = []
    for n in SPLIT:
        for w in WIDTHS:
            lib = libs[w]
            A = torch.as_tensor(corpus(n)["random"]).to("cuda", torch.float32)
            info = run_warp(lib, A, torch, se)[2]
            torch.cuda.synchronize()
            clk = (ctypes.c_longlong * 8)()
            err = lib.cora_small_eigh_split_clocks(clk)
            if err:
                raise RuntimeError(f"split clocks: CUDA error {err}")
            c = list(clk)
            rounds = max(c[0], 1)
            row = dict(n=n, update_warps=w, rounds=c[0],
                       rotation_warp=c[1] / rounds, update_warp0=c[2] / rounds,
                       barrier_wait=c[3] / rounds,
                       stop_test=c[4] / max(c[5], 1), total=c[6],
                       sweeps=int(info))
            out.append(row)
            print(f"[split] {json.dumps(row)}", flush=True)
    return out


def build_other(path, se):
    """nvcc another version's small_eigh.cu into its own library."""
    import hashlib

    from cora_tpu_torch.ops.tnt_kernels import BUILD_DIR, _nvcc

    with open(path, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    so = BUILD_DIR / f"other_small_eigh_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_nvcc(), *se.NVCC_FLAGS, "-o", str(so), path],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.cora_small_eigh_f32, lib.cora_small_eigh_f64):
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
        fn.restype = ci
    return lib


def check_other(torch, se, lib):
    """Per case, whether the other version's kernel gives this tree's
    one-CTA and routed bits."""
    same_cta = same_routed = total = 0
    for n in SIZES:
        for dt in (torch.float32, torch.float64):
            for name, M in corpus(n).items():
                A = torch.as_tensor(M).to("cuda", dt).contiguous()
                w = torch.empty(n, dtype=dt, device="cuda")
                V = torch.empty(n, n, dtype=dt, device="cuda")
                info = torch.empty(1, dtype=torch.int32, device="cuda")
                fn = lib.cora_small_eigh_f32 if dt == torch.float32 \
                    else lib.cora_small_eigh_f64
                err = fn(A.data_ptr(), w.data_ptr(), V.data_ptr(),
                         info.data_ptr(), 1, n, se.MAX_SWEEPS,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"other kernel failed: {err}")
                other = (w, V, info.reshape(()))
                total += 1
                same_cta += bits_equal(other, se.small_eigh(A, kernel="cta"))
                same_routed += bits_equal(other, se.small_eigh(A))
    return dict(cases=total, same_as_cta=same_cta, same_as_routed=same_routed)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--parent")
    ap.add_argument("--sass")
    ap.add_argument("--out")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--define", action="append", default=[])
    ap.add_argument("--stream", action="store_true")
    ap.add_argument("--cert", type=int)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_small_eigh: no CUDA device available")
    card = card_line()
    print(card, flush=True)
    sys.path.insert(0, REPO)
    from cora_tpu_torch.ops import small_eigh as se

    if args.cert:
        res = cert_against_global(torch, se, args.cert)
        print(json.dumps(dict(card=card, cert=res)))
        if not res["ok"]:
            raise SystemExit("probe_small_eigh: the certificates differ")
        return
    t0 = time.time()
    variants = {} if args.quick or args.stream else {
        ("width", w): [f"SMALL_EIGH_UPDATE_WARPS={w}"]
        for w in WIDTHS if w != 3}
    for d in args.define:
        variants[("define", d)] = [d]
    if args.split:
        variants.update({("split", w): ["SMALL_EIGH_SPLIT",
                                        f"SMALL_EIGH_UPDATE_WARPS={w}"]
                         for w in (WIDTHS if not args.stream else (3,))})
    with concurrent.futures.ThreadPoolExecutor(len(variants) + 1) as pool:
        package = pool.submit(se.load_library)
        built = {k: pool.submit(build, se, d) for k, d in variants.items()}
        built = {k: f.result() for k, f in built.items()}
        libs = {w: built[("width", w)] for w in WIDTHS
                if ("width", w) in built}
        libs[3] = package.result()
        variant_libs.update({k[1]: v for k, v in built.items()
                             if k[0] == "define"})
    print(f"[build] small_eigh.cu, {len(variants) + 1} builds in "
          f"{time.time() - t0:.1f} s ({se.BUILD_INFO['path']})", flush=True)
    for name, line in ptxas_lines(se.BUILD_INFO["log"]):
        print(f"[ptxas] {name}: {line}", flush=True)
    if args.stream:
        # the stream route alone: its bits, times and (--split) split
        rows, failed = stream_bits(torch, se)
        res = dict(card=card, bits=rows, failed=failed,
                   stream_times=time_stream(torch, se),
                   stream_vs_grid=time_stream_vs_grid(torch, se))
        if args.split:
            res["stream_split"] = stream_split(torch, se, built[("split", 3)])
        if args.out:
            with open(args.out, "w") as fh:
                fh.write(json.dumps(res))
        print(json.dumps(res))
        if failed:
            raise SystemExit(f"probe_small_eigh: results differ: {failed}")
        return
    rows, failed = check_bits(torch, se, libs, args.quick)
    print("[bits] routed, the cluster family and every "
          "update-warp count against one-CTA (n ≤ 96) or global (n > 96), "
          f"equal: {sum(r['same'] for r in rows)} of {len(rows)}", flush=True)
    for r in rows:
        print(f"[bits] {json.dumps(r)}", flush=True)
    res = dict(card=card, bits=rows, failed=failed,
               ptxas=ptxas_lines(se.BUILD_INFO["log"]))
    if args.parent:
        res["parent"] = check_other(torch, se, build_other(args.parent, se))
        print(f"[parent] {json.dumps(res['parent'])}", flush=True)
    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
        from cora_tpu_torch.ops.tnt_kernels import _nvcc

        dump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
        with open(os.path.join(args.sass, "small_eigh.sass"), "w") as fh:
            subprocess.run([dump, "-sass", se.BUILD_INFO["path"]], stdout=fh,
                           stderr=subprocess.STDOUT, timeout=120)
    for d, oks in variant_same.items():
        print(f"[bits] -D{d}: cluster family equal {sum(oks)} of {len(oks)}",
              flush=True)
    if args.quick:
        print(json.dumps({k: v for k, v in res.items() if k != "bits"}))
        if failed:
            raise SystemExit(f"probe_small_eigh: results differ: {failed}")
        return
    res["times"] = time_kernels(torch, se, libs)
    res["cluster_times"] = time_cluster(torch, se)
    res["stream_times"] = time_stream(torch, se)
    if args.split:
        res["split"] = round_split(torch, se, {w: built[("split", w)]
                                               for w in WIDTHS})
        res["cluster_split"] = cluster_split(torch, se, built[("split", 3)])
        res["stream_split"] = stream_split(torch, se, built[("split", 3)])
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(json.dumps(res))
    print(json.dumps({k: v for k, v in res.items() if k != "bits"}))
    if failed:
        raise SystemExit(f"probe_small_eigh: results differ: {failed}")


if __name__ == "__main__":
    main()
