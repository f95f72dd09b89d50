#!/usr/bin/env python3
"""Drive the PyTorch port (`cora_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its results before the next starts; any failure
raises and the script exits non-zero:

  1. device — the card's name and power limit (nvidia-smi), the torch and
     CUDA versions, the build of the CUDA kernels from `ops/csrc/`
     (`tnt_kernels.cu` and `small_eigh.cu`) and, in parallel, of
     `scripts/probe_cluster_sync.cu`; the probe's barrier
     costs (`__syncthreads`, `cluster.sync()` at 2-16 CTAs, at 16 CTAs of
     small_eigh's shared memory too, `grid.sync()` and the counter barrier
     of `small_eigh_grid` at its CTA counts, each also captured in a CUDA
     graph and replayed) and L2 read rates, and the cluster size C of the
     kernels;
  2. kernels — each of `step`, `tcg`, `chunk` and `ladder` against its
     plain PyTorch version on the card, on the plaza2-shaped graph (2D,
     ranks 4 and 6) and the single_drone-shaped graph (3D, rank 5), with
     the CPU tests' tolerances; both timed (median of 20, CUDA events).
     `chunk`, `tcg` and `step` run as one cluster of C CTAs, `ladder` as
     K clusters each batching its share of the 48 trial points; their
     single-CTA comparators (`chunk_block`, `tcg_block`, `step_block`, and
     `ladder_block` with one CTA per α) are held to the plain versions too
     and timed against them in turns (block, cluster, cluster, block),
     with µs per tCG iteration. `tcg` runs a case that stops at the
     boundary after one iteration and one that runs tens of iterations
     (∇F = 0, Δ = 1e8); the second is timed and bounded. `ladder` gives
     the same bits at K = 1 and at the chosen K, agrees at each α with the
     cluster `step` at s = α·Ẏ within 1e-6 (and says at how many α it is
     bit-equal), and is timed at K = 1, 2, 3, 4, 6, 8 where they fit.
     Past rank 10 (HIGH_RANK_CASES: ranks 11, 32 and 80 on the
     plaza2-shaped graph, the JAX package's VMEM guard there being 80,
     and 12 on the single_drone-shaped one) the four kernels are held to
     their plain versions at the same tolerances, the ladder's bits at one
     cluster (in as many launches as shared memory needs) to the chosen
     K's and its scalars to the cluster `step`'s, and each kernel and its
     plain version timed (median of 3) beside its bound.
     `small_eigh` (LOBPCG's Rayleigh–Ritz eigensolver: the one-warp
     kernel for n ≤ 32, the cluster family `small_eigh_cluster` to 448 on
     1-16 CTAs, the grid `small_eigh_grid` to 1056 on co-resident CTAs,
     the stream route `small_eigh_stream` above, A by index in L2; the
     one-CTA kernel `small_eigh_cta`, n ≤ 96, and the global kernel
     `small_eigh_global` past it, their comparators) against
     its plain twin on random symmetric 30 × 30 and 36 × 36 matrices in
     float32 and float64 and on the graded matrices of
     `scripts/small_eigh_cases.py` at n = 10 and 30 (eigenvalues to 1e-5 /
     1e-12 relative, ‖VᵀV − I‖ and ‖AV − VΛ‖); wherever the one-warp
     kernel or the cluster family runs, it must give its comparator's bits
     (w, V, info: the one-CTA kernel's to n = 96, the global kernel's
     past it), and the comparator is held to the twin too; the one-warp
     kernel timed at n = 30 float32 in turns (one-CTA, warp, warp,
     one-CTA) beside the twin and `torch.linalg.eigh`; the cluster family,
     the grid, the stream route and the global kernel bit for bit against
     the one-CTA kernel at n = 36 and 96 (forced), the cluster family
     against the global kernel at
     n = 99, 150, 198, 246 (1, 2, 4 and 8 CTAs), 321, 384 and 448 (16
     CTAs), and the grid at 449 (a batch of two), 516, 768 and 1056, in
     float32 and float64 and against the twin in float64 (1e-12), their
     float32 eigenvalues against float64 eigh; the cluster family and the
     grid timed in turns with their comparator (new, old, old, new) at n =
     36 (the one-CTA kernel), 99, 246, 324, 448 and 516 (the global
     kernel; median of 3 past 320), each beside its bound, with its CTA
     count, and at 1056 one timed call of each; the stream route past
     1056: at n = 1062 (rank 352) bit for bit against the global kernel in
     float32 and float64 (the global kernel's call timed once), against
     the twin in float64 at 1062, 1536 and 2112, forced at 516 and 1056
     bit for bit against the grid, one timed call at 1062 and 2112 beside
     the twin and `torch.linalg.eigh`;
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
     rest of the staircase lands. Each solve prints its total tCG
     iterations and the TNT phases' wall per tCG iteration, and (as in
     phases 5-7) its certificate and polish loops: LOBPCG iterations,
     captures, replays, host reads per LOBPCG iteration, Newton-CG
     iterations and host reads per CG iteration, small_eigh launches, and
     the `certify` / `polish_f64` split (`scripts/probe_cert_loop.py`);
     in the kernel-path solves every failed certificate's LOBPCG and every
     polish's CG must run as replayed graphs;
  3b. ranks — past the main path's ranks, each path with the launch
     counts zeroed before it and read after it: the plaza2-shaped staircase
     from rank 11 (`init_rank_jump` 9, `max_rank` 12) on the chain
     kernels, from the fixture's numpy start at that rank, gated as phase
     3 against the fixture's plaza2-shaped run (the certified optimum does
     not depend on the start rank); a failed certificate at a random
     point at rank 10 (Rayleigh–Ritz n = 36), at rank 31 (n = 99), at rank
     106 (n = 324, 16 CTAs), at rank 150 (n = 456) and at rank 352 (n =
     1062), whose LOBPCG must run as replayed graphs through
     `small_eigh_cluster` (`small_eigh_grid` for rank 150's 3k = 456,
     `small_eigh_stream` for rank 352's 3k = 1062), the k × k matrices
     through their own route, and no other route; the rank-150
     certificate again with its 3k × 3k matrices forced to the global
     kernel, which must reach the same verdict and θ; the visualize CLI's
     solve half
     (`cora_tpu_torch.visualize.solve`) on a one-robot chain written as
     PyFG, in float32 on the chain kernels and with `--animate` (float64,
     iterates logged, the canonical path), both certified and within 1 %
     of each other, and the drawing only where matplotlib imports (the
     script says which it did);
  4. level f64 — the single_drone-shaped graph's first level (rank 5) in
     float64 on the card, with the canonical `tnt_solve` and with the chain
     plain path on a float64 plan, from the fixture's start, against the
     JAX package's float64 level (`level0_f64`): f per iteration within
     1e-12 relative for as long as the JAX package's own level from starts
     one ulp away stays within 1e-12 of it, and the level's end (status,
     iteration count, final f within 1 %) within the ends those runs reach
     (the end is chaotic in the rounding);
  5. general — the general-graph path: `parse_pyfg` → `solve_cora` from
     the odometry start on two multi-robot graphs with inter-robot ranges
     (`tiers_shaped`, `mrclam5a_shaped`, written by `multi_robot_pyfg` in
     `scripts/torch_port_reference.py` to a temporary file): gated as
     phase 3 against the JAX package's run (fixture `general`), with no
     CUDA kernel launched (the canonical path is plain PyTorch); each graph
     is solved once (phase 7 solves `mrclam5a_shaped` again, on a mesh, and
     must end on this solve's bits). The canonical TNT levels run as the
     device loop of `solve/tnt.py`, captured as CUDA graphs: each solve
     prints the loop's captures and their seconds, replays, host reads per
     tCG iteration and µs per tCG iteration; `tiers_shaped`'s first level
     runs again, cut to its ramp, under `torch.profiler` for its
     device-busy share;
     `mrclam5a_shaped`'s first level is captured afresh with every warm-up,
     capture and first replay under `set_sync_debug_mode("error")`, and
     the whole solve is repeated with `use_kernels="never"` (every step
     function eager) and must end on the captured solve's bits. Each
     solve's failed certificates' LOBPCG and its polish CG must run as
     replayed graphs; on `tiers_shaped` at most 0.5 host reads per LOBPCG
     and per CG iteration, and its first failed certificate and first
     polish run again, captured afresh under the sync check and eagerly,
     both on the solve's bits, the eager certificate's Rayleigh–Ritz
     matrices held to small_eigh's plain twin and, at n ≤ 32, to the
     one-CTA kernel's bits;
  6. implicit — the translation-implicit (marginalized) formulation and
     the solve's host surroundings, in float64: the native PyFG tokenizer
     against the Python parser on both multi-robot graphs (identical data
     matrices, both parse times); the implicit operator on the
     plaza2-shaped graph against the host sparse Schur complement (scipy
     `splu` of L, 1e-10), the recovered translations zeroing Q·[Y; t]'s
     translation rows, the pinned row exactly 0; the plaza2-shaped
     implicit solve from the fixture's start (fixture `implicit`; gated as
     phase 3, its first level to 1e-6 over 8 iterations) with its TUM
     export read back; `mrclam5a_shaped` implicit from the odometry start,
     twice: the first with `checkpoint_path` (its failed first level
     writes the checkpoint, and nothing else is left in the directory),
     the second with `log_iterates` (the same bits; the iterate log as
     long as the iterations); then a third call resumes from the
     checkpoint and certifies within 1 % of the uninterrupted f. The first
     solve's first level runs again eagerly and again captured under the
     sync check, both on its bits; each solve prints its device-loop
     counts as phase 5's do. No CUDA kernel is launched in this phase;
  7. parallel — `cora_tpu_torch.parallel` on the card: `init_distributed`
     starts nothing (one process), `make_global_mesh` makes a one-process
     NCCL group on the card. On the plaza2-shaped graph and `tiers_shaped`
     in float32 and float64, and on the 100 000-pose graph of
     bench.py:180-186 in its float32, at r = 4: the block-row and
     edge-sharded products through that group, and the block-row product
     with K = 2, 4, 8 shards emulated in this process, each held to the
     unsharded product (1e-5 / 1e-12 relative to its largest entry). On
     the 100 000-pose graph also their times (median of 20, CUDA events):
     the unsharded product, each sharded one, each shard's local product
     and the assemble step at each K. Then `mrclam5a_shaped`
     through `solve_cora(..., mesh=)`: explicit float32 from the odometry
     start, gated as phase 5 and on phase 5's bits (on one process the
     block-row product's sums are the unsharded product's, copied), and
     implicit float64, gated as phase 6 and within 1e-6 relative in f of
     phase 6's unsharded solve. The mesh solves run the device loop
     eagerly (its collectives stay outside any graph: no capture). No CUDA
     kernel is launched in this phase (the sharded path runs the canonical
     ops).
     The group is destroyed at the end.

The kernels' launch counts are zeroed just before the timed kernel-path
solves and read just after them; the main path must launch the cluster
`chunk`, `step` and `ladder` and `small_eigh` (its failed certificates),
and never a comparator (`small_eigh_cluster` only for a routed n > 32,
that is a certificate at rank 9 or more). The certificate path of phase
3b must launch `small_eigh_cluster`, `small_eigh_grid` and
`small_eigh_stream`. The line
before the last is one JSON object with the route, source, launches,
error, times and bound of each kernel the paths launch (`chunk`, `step`,
`ladder`, `small_eigh` from phase 3, `small_eigh_cluster`,
`small_eigh_grid` and `small_eigh_stream` from phase 3b, with the chain
kernels' times and bounds past rank 10 under `by_rank` and the cluster
family's, the grid's and the stream route's by n under `by_n`; `tcg`, whose loop runs inside `chunk`, and small_eigh's
one-CTA and global kernels, the comparators, get a line of their own). A
kernel's bound is the larger of its bytes (inputs read once, outputs
written once) over 3.35 TB/s, its FLOPs over 67 TFLOP/s, and its
dependent group-barrier phases (`tnt_kernels.work_counts`) times the
C-CTA cluster barrier the probe measured in this run (`small_eigh`: its
sweeps × (n − 1) rounds times the barrier it waits on each round, the
probe's `__syncthreads` or, for the cluster family on C > 1 CTAs, its
C-CTA `cluster.sync`, for the grid and the stream route its counter
barrier at the probe's largest measured CTA count not above G, its FLOPs
at the float64 peak,
34 TFLOP/s); the
last line is
`{"ok": true, "device": {...}}`. Without a CUDA device the script exits
non-zero before printing any result.
"""

import copy
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
REFERENCE = os.path.join(REPO, "tests", "data", "torch_port_reference.json")
SOURCE = "cora_tpu_torch/ops/csrc/tnt_kernels.cu"
EIGH_SOURCE = "cora_tpu_torch/ops/csrc/small_eigh.cu"
REPLACES = {
    "step": "cora_tpu/ops/pallas_tcg.py:363",
    "tcg": "cora_tpu/ops/pallas_tcg.py:401",
    "chunk": "cora_tpu/ops/pallas_tcg.py:733",
    "ladder": "cora_tpu/ops/pallas_tcg.py:792",
    # not a pallas_call: the jnp.linalg.eigh in LOBPCG's lax.while_loop,
    # in routes by n (small_eigh.route), and the one-CTA comparator
    "small_eigh": "cora_tpu/ops/lobpcg.py:61",
    "small_eigh_cluster": "cora_tpu/ops/lobpcg.py:61",
    "small_eigh_grid": "cora_tpu/ops/lobpcg.py:61",
    "small_eigh_stream": "cora_tpu/ops/lobpcg.py:61",
    "small_eigh_cta": "cora_tpu/ops/lobpcg.py:61",
    "small_eigh_global": "cora_tpu/ops/lobpcg.py:61",
}
EIGH_KEYS = ("small_eigh", "small_eigh_cluster", "small_eigh_grid",
             "small_eigh_stream", "small_eigh_cta", "small_eigh_global")
# the CPU tests' tolerances (tests/test_torch_kernels_plain.py)
TOL_STATE, TOL_F, TOL_GN, TOL_PGN = 2e-5, 1e-4, 1e-4, 1e-3
TOL_MDEC = TOL_SNORM = 2e-2
# the first TNT level against the JAX run's: f and ‖grad‖ per iteration over
# the first chunk, ten times the CPU test's tolerances (tests/
# test_torch_solve.py) for float32 sums a thousand times longer
FIRST_CHUNK, TOL_LEVEL_F, TOL_LEVEL_GN = 8, 1e-3, 1e-2
REPS = 20
# ladder cluster counts timed in phase 2 (those the card holds)
LADDER_SWEEP = (1, 2, 3, 4, 6, 7, 8)
# the kernels the main path launches (`tcg` is the body of `chunk`;
# `small_eigh` is the Rayleigh–Ritz step of every failed certificate's
# LOBPCG)
PATH_KERNELS = ("chunk", "step", "ladder", "small_eigh")
# the kernels of the certificate path past the main path's ranks (phase
# 3b): the 3k × 3k Rayleigh–Ritz matrices of a certificate at rank 10 (n =
# 36) and at rank 31 (n = 99), both the cluster family's (one CTA), at
# rank 106 (n = 324: 16 CTAs), at rank 150 (n = 456): the grid's, and at
# rank 352 (n = 1062): the stream route's (the k × k ones, n = 108, 152
# and 354, the cluster family's)
CERT_RANKS = (("small_eigh_cluster", 10), ("small_eigh_cluster", 31),
              ("small_eigh_cluster", 106), ("small_eigh_grid", 150),
              ("small_eigh_stream", 352))
# the certificate held to the global route's verdict and θ (its 3k × 3k
# matrices forced to `small_eigh_global`): θ within the float32 eigenvalue
# tolerance of the kernels' check, relative to |θ|
CERT_AGAINST_GLOBAL, CERT_THETA_TOL = 150, 1e-5
# small_eigh's comparators, which no path launches (the one-CTA kernel;
# the global kernel, routed to by no size)
EIGH_COMPARATORS = ("small_eigh_cta", "small_eigh_global")
# small_eigh against its plain twin: eigenvalues relative to the largest
# (the float32 / float64 eigh's accuracy), ‖VᵀV − I‖ and ‖AV − VΛ‖ / ‖Λ‖
# (n·ε with room for the Jacobi rotations' rounding)
EIGH_TOL = {"float32": 1e-5, "float64": 1e-12}
EIGH_ORTH = {"float32": 1e-4, "float64": 1e-12}
EIGH_CASES = ((30, "float32"), (36, "float32"), (30, "float64"),
              (36, "float64"))
# the probe's graded matrices (eigenvalues 1e-3 … 1e5, a near-degenerate
# pair at the bottom) at the main path's k and 3k
EIGH_GRADED = (10, 30)
# the card's float64 peak outside the tensor cores (NVIDIA's H100 SXM
# data sheet): small_eigh computes in float64 for either input type
PEAK_F64 = 34e12
# the single-CTA comparators, which only phase 2 launches
COMPARATORS = ("step_block", "ladder_block", "chunk_block", "tcg_block")
KERNEL_CASES = [("plaza2_shaped", 4), ("plaza2_shaped", 6),
                ("single_drone_shaped", 5)]
# phase 2 past rank 10, up to the JAX package's VMEM guard on the
# plaza2-shaped graph (rank 80): each kernel against its plain version at
# the tolerances above, timed with fewer repeats and no comparators
HIGH_RANK_CASES = [("plaza2_shaped", 11), ("plaza2_shaped", 32),
                   ("plaza2_shaped", 80), ("single_drone_shaped", 12)]
HIGH_REPS = 3
# small_eigh's cluster family bit for bit against the one-CTA kernel at
# n ≤ 96 and the global kernel past it (and the global kernel against the
# one-CTA kernel where both run), in float32 and float64, at an n of each
# cluster size the route picks (99: 1 CTA, 150: 2, 198: 4, 246: 8, 321,
# 384 and 448: 16), and the grid at 449 (113 CTAs, the last of one pair),
# 516 (129), 768 (128) and 1056 (132); against the twin in float64, as the
# JAX package's eigh computes, past 96 (two matrices a call to 320 and at
# 449, the grid's batch; one past); timed in turns with the comparator at
# the certificates' n = 36 (rank 10), 99 (rank 31), 324 (rank 106), 516
# (rank 170) and at 246 and 448 (median of EIGH_FEW_REPS past 320), and at
# 1056 one timed call each; the stream route past n = 1056: at rank 352's
# 1062 bit for bit against the global kernel (float32 and float64, the
# global kernel's call timed as the comparator's), against the twin in
# float64 at EIGH_STREAM, forced at EIGH_STREAM_FORCED bit for bit against
# the grid, one timed call at 1062 and 2112
EIGH_FORCED = (36, 96)
EIGH_GLOBAL = (99, 150, 198, 246, 321, 384, 448, 449, 516, 768, 1056)
EIGH_BATCH2 = 449
EIGH_TIMED = (36, 99, 246, 324, 448, 516)
EIGH_FEW_REPS = 3
EIGH_ONCE = 1056
EIGH_PAST = 1062
EIGH_STREAM = (1062, 1536, 2112)
EIGH_STREAM_FORCED = (516, 1056)
EIGH_STREAM_TIMED = (1062, 2112)
# phase 3b: the plaza2-shaped staircase from rank 11 (init_rank_jump 9)
# with max_rank 12 on the kernels; a staircase from rank 10 that escapes
# to rank 11 on the kernels (a chain whose relaxation's optimum has rank
# 11: `noisy_chain_pyfg`), its levels run to a near-critical end (no ramp
# stall); the visualize CLI's solve half on a one-robot chain written as
# PyFG
RANK_START, RANK_MAX = 11, 12
ESCAPE_GRAPH = dict(n_poses=200, n_landmarks=16, ranges_per_pose=4,
                    noise_scale=100.0, seed=0)
ESCAPE_START, ESCAPE_MAX = 10, 12
ESCAPE_CONFIG = dict(max_staircase_iterations=400, ramp_stall_window=0)
CLI_GRAPH = dict(n_robots=1, poses_per_robot=400, n_inter_ranges=0,
                 n_landmarks=4, n_landmark_ranges=200, n_loop_closures=0,
                 dim=2, seed=1)
# the float64 level against the JAX package's, per iteration in f
# (relative), over the iterations before the JAX package's own level from a
# start one ulp away parts from it by as much; and its end f against the
# range of the JAX runs' ends, widened by the 1 % of the cost gate
TOL_F64, TOL_END_F = 1e-12, 0.01
# phase 7: the sharded products at rank r on three graphs (plaza2-shaped,
# tiers_shaped and the 100 000-pose graph of bench.py:180-186), block-row
# with K shards emulated, held to the unsharded product as the CPU tests
# hold them (tests/test_torch_parallel.py); the 100 000-pose graph in
# bench.py's float32 only, and only there timed (the times are recorded,
# not claimed: one graph keeps the phase short)
PAR_RANK, PAR_KS = 4, (2, 4, 8)
PAR_TOL = {"float32": 1e-5, "float64": 1e-12}
HV100K = dict(n_poses=100000, n_landmarks=10, n_ranges=50000, seed=0)
PAR_DTYPES = {"hv100k": ("float32",)}
PAR_TIMED = ("hv100k", "float32")
LIMIT_S = 1200  # the time limit the whole script must finish within
LEVEL_CALLS = []  # (args, kwargs) of each TNT level of the last solve_once
# the last solve_once's certificate and polish loops: LOBPCG and Newton-CG
# counts, small_eigh launches, the certify / polish split, and its
# certificate and polish calls (scripts/probe_cert_loop.py)
LAST = {}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def absdiff(a, b):
    return float((a - b).abs().max())


def median_ms(fn, torch, prepare=None, reps=REPS):
    """Median over `reps` of one call's device time (CUDA events)."""
    times = []
    for _ in range(reps + 2):
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


def ptxas_summary(log):
    """(kernel, registers, spill store bytes, spill load bytes) per entry
    of nvcc's `-Xptxas -v` output."""
    import re

    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(step|tcg|chunk|ladder)(_block)?_kernelILi(\d)E"
                          r"(\d+\w+?Group(?:ILi(\d+)E)?)?", m.group(1))
            name = (f"{k.group(1)}<d={k.group(3)}"
                    + (f", cluster {k.group(5)}"
                       if k.group(5) else
                       ", one CTA" if k.group(4) or k.group(2) else "")
                    + ">") if k else None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), *spill))
            name = None
    return out


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def exact_matmuls():
    """float32 matmuls in float32 (no TF32), as the JAX package's."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def phase_device():
    """The card, the build of the kernels and of the barrier probe (one
    nvcc each, started together), and the probe's numbers."""
    import concurrent.futures

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    if not os.path.isdir(os.path.join(REPO, "cora_tpu_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository")
    smi = card_line()
    exact_matmuls()
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import probe_cluster_sync as probe

    from cora_tpu_torch.ops import small_eigh, tnt_kernels

    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        kernels = pool.submit(tnt_kernels.load_library)
        eigh = pool.submit(small_eigh.load_library)
        probe_lib = pool.submit(probe.build)
        kernels.result()
        eigh.result()
        probe_lib = probe_lib.result()
    build_s = time.time() - t0
    C, info = tnt_kernels.CLUSTER, tnt_kernels.BUILD_INFO
    print(smi, flush=True)
    print(f"[device] {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} | CUDA {torch.version.cuda} | python "
          f"{sys.version.split()[0]} | kernels, small_eigh and probe built "
          f"in {build_s:.1f} s ({info['path']}, "
          f"{small_eigh.BUILD_INFO['path']})", flush=True)
    for name, regs, st, ld in ptxas_summary(info["log"]):
        print(f"[device] ptxas {name}: {regs} registers, spills {st} B stored"
              f" / {ld} B loaded", flush=True)
    from small_eigh_cases import ptxas_lines

    for name, line in ptxas_lines(small_eigh.BUILD_INFO["log"]):
        print(f"[device] ptxas {name}: {line}", flush=True)
    res = probe.measure(probe_lib, quick=True)
    print("[device] probe: __syncthreads (1024 threads) "
          f"{res['syncthreads_us']:.4f} us; cluster.sync " + ", ".join(
              f"{c} CTAs {v:.4f} us ({res['max_active_clusters'][c]} fit)"
              for c, v in res["cluster_sync_us"].items())
          + f"; grid.sync ({res['grid_blocks']} CTAs) {res['grid_sync_us']:.4f}"
          " us; L2 read " + ", ".join(
              f"{b} SMs {v:.1f} GB/s" for b, v in res["l2_read_GBps"].items()),
          flush=True)
    print("[device] probe: cluster.sync, 16 CTAs of small_eigh's shared "
          f"memory {res['cluster_sync_smem_us']['16']:.4f} us "
          f"({res['cluster_smem_fit']['16']} fit); grid barriers "
          "(cooperative launch, one CTA per SM; captured and replayed): "
          + "; ".join(f"{kind} " + ", ".join(
              f"{g} CTAs {us:.4f} us ({res['grid_barrier_captured'][kind][g]})"
              for g, us in v.items())
              for kind, v in res["grid_barrier_us"].items()), flush=True)
    check(res["cluster_smem_fit"]["16"] >= 1, "no 16-CTA cluster of "
          "small_eigh's shared memory fits on the card")
    check(all(ok == "ok" for v in res["grid_barrier_captured"].values()
              for ok in v.values()),
          f"a cooperative launch did not capture and replay: "
          f"{res['grid_barrier_captured']}")
    print(f"[device] chunk, tcg, step: one cluster of C = {C} CTAs of 1024 "
          "threads; ladder: several such clusters", flush=True)
    check(res["max_active_clusters"][str(C)] >= 1,
          f"no cluster of {C} CTAs fits on the card")
    return res


def bound(wc, barrier_us):
    """(bound ms, bound_by, term): the larger of the bytes over 3.35 TB/s,
    the FLOPs over the float32 peak (67 TFLOP/s) and the dependent
    group-barrier phases times the measured barrier."""
    terms = {"bytes": wc["bytes"] / 3.35e12 * 1e3,
             "flops": wc["flops"] / 67e12 * 1e3,
             "barriers": wc["phases"] * barrier_us * 1e-3}
    term = max(terms, key=terms.get)
    return terms[term], "bytes" if term == "bytes" else "operations", term


def phase_kernels(problems, hp, probe):
    import numpy as np
    import torch

    from cora_tpu_torch.ops import chain, tnt_kernels
    from cora_tpu_torch.ops.riemannian import random_initial_guess
    from cora_tpu_torch.ops.tnt_kernels import CudaTNT, PlainTNT
    from cora_tpu_torch.solve.tnt_kernel import get_chain_plan

    stats = {k: dict(max_abs_err=0.0, max_rel_err=0.0) for k in REPLACES}
    C = tnt_kernels.CLUSTER
    # every kernel's passes end in a barrier over one cluster of C CTAs
    barrier_us = probe["cluster_sync_us"][str(C)]

    def note(name, a, b, tol, what):
        e = rel(a, b)
        check(e < tol, f"{name}: {what} rel err {e:.3e} > {tol}")
        s = stats[name]
        s["max_abs_err"] = max(s["max_abs_err"], absdiff(a, b))
        s["max_rel_err"] = max(s["max_rel_err"], e)

    def in_turns(run):
        """Median times of run(block) in turns block, cluster, cluster,
        block: (block ms, cluster ms, all four)."""
        t = [run(b) for b in (True, False, False, True)]
        return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t

    def near(name, pairs, what):
        """A comparator against the plain version, with the tolerances of
        its kernel (not counted in the kernel's errors)."""
        for x, y, tol, part in pairs:
            e = rel(x, y)
            check(e < tol, f"{name}: {what} {part} rel err {e:.3e} > {tol}")

    for ci, (gname, rank) in enumerate(KERNEL_CASES):
        problem = problems[gname]
        plan = get_chain_plan(problem, np.float32, "cuda")
        cu, pl = CudaTNT(plan, hp), PlainTNT(plan, hp)
        pd = problem.device_data(np.float32, "cuda")
        gen = torch.Generator().manual_seed(100 + ci)
        Y = random_initial_guess(pd, rank, gen).contiguous()
        V = (0.1 * torch.randn(Y.shape, generator=gen, dtype=torch.float64)
             ).to(Y).contiguous()
        times, extra, work = {}, {}, {}

        for flag in (1, 0):
            a, b = cu.step(Y, V, flag), pl.step(Y, V, flag)
            note("step", a[0], b[0], TOL_STATE, f"flag {flag} Y")
            note("step", a[2], b[2], TOL_GN, f"flag {flag} grad")
            for i, tol in enumerate((TOL_F, TOL_GN, TOL_PGN)):
                note("step", a[3][i:i + 1], b[3][i:i + 1], tol,
                     f"flag {flag} scalar {i}")
            a = cu.step(Y, V, flag, block=True)
            near("step (one CTA)", [(a[0], b[0], TOL_STATE, "Y"),
                                    (a[2], b[2], TOL_GN, "grad")] + [
                (a[3][i:i + 1], b[3][i:i + 1], tol, f"scalar {i}")
                for i, tol in enumerate((TOL_F, TOL_GN, TOL_PGN))],
                f"flag {flag}")
        blk, clu, turns = in_turns(lambda b: median_ms(
            lambda: cu.step(Y, V, 1, block=b), torch))
        check(clu < blk, f"step: cluster {clu:.3f} ms, one CTA {blk:.3f} ms")
        times["step"] = (clu, median_ms(lambda: pl.step(Y, V, 1), torch))
        extra["step"] = dict(block_ms=blk, turns_ms=turns)
        work["step"] = tnt_kernels.work_counts(plan, rank, 0, "step",
                                               parts=C)

        _, QY, G, _ = pl.step(Y, V, False)
        # two tCG cases: Δ = 5 at ∇F = QY stops at the boundary (negative
        # curvature) within an iteration or so; ∇F = 0 drops the Hessian's
        # Weingarten term, leaving the projected Q, positive semidefinite,
        # and Δ = 1e8 never binds, so the solve runs tens of iterations to
        # its residual test: the case that is timed and bounded
        cases = {"boundary": (QY, 5.0), "long": (torch.zeros_like(QY), 1e8)}
        iters = {}
        for case, (nF, delta) in cases.items():
            sb, tb = pl.tcg(G, Y, nF, delta, 80)
            tb = tb.tolist()
            for block in (False, True):  # the cluster kernel, its comparator
                sa, ta = cu.tcg(G, Y, nF, delta, 80, block=block)
                ta = ta.tolist()
                what = f"tcg {case}" + (" (one CTA)" if block else "")
                check(abs(ta[2] - tb[2]) <= 2,
                      f"{what} iterations {ta[2]} vs {tb[2]}")
                check(ta[1] == tb[1], f"{what} hit {ta[1]} vs {tb[1]}")
                check(abs(ta[0] - tb[0]) <= TOL_MDEC * abs(tb[0]),
                      f"{what} mdec {ta} {tb}")
                check(abs(ta[3] - tb[3]) <= TOL_SNORM * abs(tb[3]),
                      f"{what} |s| {ta} {tb}")
                if not block:
                    stats["tcg"]["max_abs_err"] = max(
                        stats["tcg"]["max_abs_err"], absdiff(sa, sb))
                    stats["tcg"]["max_rel_err"] = max(
                        stats["tcg"]["max_rel_err"], rel(sa, sb))
                iters[case, block] = ta[2]
        print(f"[kernels] {gname} r={rank}: tcg iterations (cluster, one CTA)"
              f": " + ", ".join(f"{c} {iters[c, False]:.0f}, "
                                f"{iters[c, True]:.0f}" for c in cases),
              flush=True)
        check(iters["long", False] >= 10,
              f"tcg long case ran {iters['long', False]} iterations")
        nF, delta = cases["long"]
        blk, clu, turns = in_turns(lambda b: median_ms(
            lambda: cu.tcg(G, Y, nF, delta, 80, block=b), torch))
        times["tcg"] = (clu, median_ms(lambda: pl.tcg(G, Y, nF, delta, 80),
                                       torch))
        extra["tcg"] = dict(
            block_ms=blk, turns_ms=turns,
            us_per_tcg_iter=1e3 * clu / iters["long", False],
            block_us_per_tcg_iter=1e3 * blk / iters["long", True])
        work["tcg"] = tnt_kernels.work_counts(
            plan, rank, int(iters["long", False]), "tcg", parts=C)

        def chunk_args():
            fs = torch.tensor([0, 0, 0, 5.0, float("inf"), 1e-4, 0, 0],
                              dtype=torch.float32, device="cuda")
            isc = torch.tensor([0, 0, 0, 0, 0, 8, 80, 60, 24, 10, 1, 0],
                               dtype=torch.int32, device="cuda")
            hist = torch.zeros((5, 80), dtype=torch.float32, device="cuda")
            return (Y.clone(), torch.zeros_like(Y), torch.zeros_like(Y), fs,
                    isc, hist)

        rb = chunk_args()
        pl.chunk(*rb)
        its = {}
        for block in (False, True):
            ra = chunk_args()
            cu.chunk(*ra, block=block)
            what = "chunk (one CTA)" if block else "chunk"
            check(ra[4][:5].tolist() == rb[4][:5].tolist(),
                  f"{what} k/status/streaks {ra[4][:5].tolist()} vs "
                  f"{rb[4][:5].tolist()}")
            if block:
                check(rel(ra[0], rb[0]) < TOL_STATE and
                      rel(ra[3][:1], rb[3][:1]) < TOL_F and
                      rel(ra[5][0, :8], rb[5][0, :8]) < TOL_F,
                      f"{what}: state, f or f history off the plain version")
            else:
                note("chunk", ra[0], rb[0], TOL_STATE, "Y")
                note("chunk", ra[3][:1], rb[3][:1], TOL_F, "f")
                note("chunk", ra[5][0, :8], rb[5][0, :8], TOL_F, "f history")
                outer = int(ra[4][0])
            its[block] = float(ra[5][4, :8].sum())
        blk, clu, turns = in_turns(lambda b: median_ms(
            lambda *a: cu.chunk(*a, block=b), torch, chunk_args))
        times["chunk"] = (clu, median_ms(pl.chunk, torch, chunk_args))
        extra["chunk"] = dict(block_ms=blk, turns_ms=turns,
                              us_per_tcg_iter=1e3 * clu / its[False],
                              block_us_per_tcg_iter=1e3 * blk / its[True])
        work["chunk"] = tnt_kernels.work_counts(
            plan, rank, int(its[False]), "chunk", outer_iters=outer,
            init=True, parts=C)

        al = 4.0 * 0.5 ** np.arange(24)
        al = torch.tensor(np.stack([al, -al], 1).reshape(-1),
                          dtype=torch.float32)
        A = len(al)
        K = cu.ladder_split(rank, A)[0]
        cap = cu.ladder_capacity(rank)
        la, lb = cu.ladder(Y, V, al), pl.ladder(Y, V, al)
        for i, tol in enumerate((TOL_F, TOL_GN, TOL_PGN)):
            note("ladder", la[i], lb[i], tol, f"row {i}")
        near("ladder (one CTA per α)", [
            (cu.ladder(Y, V, al, block=True)[i], lb[i], tol, f"row {i}")
            for i, tol in enumerate((TOL_F, TOL_GN, TOL_PGN))], "")
        # a trial point's arithmetic does not depend on its batch
        one = cu.ladder(Y, V, al, clusters=1)
        check(torch.equal(one, la),
              f"ladder: K = 1 and K = {K} differ by {absdiff(one, la):.3e}")
        # ... and is the cluster step's at s = α·Ẏ (s rounded as the
        # saddle escape forms it)
        worst, equal = 0.0, 0
        for i, a in enumerate(al.tolist()):
            s = (torch.tensor(a, dtype=torch.float32, device="cuda") * V
                 ).contiguous()
            sc = cu.step(Y, s, 1)[3]
            worst = max(worst, rel(la[:, i], sc))
            equal += int(torch.equal(la[:, i], sc))
        print(f"[kernels] {gname} r={rank}: ladder (K = {K}) against the "
              f"cluster step at each of {A} α: max rel {worst:.3e}, "
              f"bit-equal at {equal} of {A}; K = 1 and K = {K} bit-equal",
              flush=True)
        check(worst <= 1e-6, f"ladder vs cluster step: rel {worst:.3e}")
        sweep = {}
        Ks = [k for k in LADDER_SWEEP if k <= cap]
        for k in Ks + Ks[::-1]:  # in turns, forward then back
            sweep.setdefault(k, []).append(median_ms(
                lambda: cu.ladder(Y, V, al, clusters=k), torch))
        sweep = {k: sum(v) / 2 for k, v in sweep.items()}
        scratch_mb = {k: 4e-6 * chain.ladder_layout(
            plan, rank, chain.ladder_groups(A, k)).total for k in sweep}
        plan_mb = 1e-6 * tnt_kernels.work_counts(
            plan, rank, 0, "ladder", alphas=A, parts=C)["bytes"]
        print(f"[kernels] {gname} r={rank}: ladder K sweep (ms, in turns; "
              f"working set: {plan_mb:.1f} MB of plan and inputs, each "
              f"cluster reading Linv and the propagators, + scratch): "
              + ", ".join(f"K={k} {v:.3f} ms ({scratch_mb[k]:.1f} MB)"
                          for k, v in sweep.items())
              + f"; the card holds {cap} clusters",
              flush=True)
        blk, clu, turns = in_turns(lambda b: median_ms(
            lambda: cu.ladder(Y, V, al, block=b), torch))
        check(clu < blk, f"ladder: {K} clusters {clu:.3f} ms, one CTA per α "
              f"{blk:.3f} ms")
        times["ladder"] = (clu, median_ms(lambda: pl.ladder(Y, V, al),
                                          torch))
        extra["ladder"] = dict(block_ms=blk, turns_ms=turns, sweep_ms=sweep,
                               scratch_mb=scratch_mb, clusters=K)
        work["ladder"] = tnt_kernels.work_counts(
            plan, rank, 0, "ladder", alphas=A, parts=C, clusters=K)
        torch.cuda.synchronize()
        line = " | ".join(f"{k} {v[0]:.3f} ms (plain {v[1]:.3f} ms)"
                          for k, v in times.items())
        print(f"[kernels] {gname} r={rank}: {line}", flush=True)
        for k, e in extra.items():
            per = (f"; per tCG iteration {e['block_us_per_tcg_iter']:.2f} "
                   f"against {e['us_per_tcg_iter']:.2f} us"
                   if "us_per_tcg_iter" in e else "")
            print(f"[kernels] {gname} r={rank}: {k} one CTA"
                  + (" per α" if k == "ladder" else "")
                  + f" {e['block_ms']:.3f} ms against the {C}-CTA cluster"
                  + (f"s (K = {e['clusters']})" if k == "ladder" else "")
                  + f" {times[k][0]:.3f} ms (in turns block, cluster, "
                  "cluster, block: " + ", ".join(
                      f"{t:.3f}" for t in e["turns_ms"]) + " ms)" + per,
                  flush=True)
        if ci == 0:  # the main path's first level: the reported times
            for k, v in times.items():
                b_ms, b_by, b_term = bound(work[k], barrier_us)
                stats[k].update(ms=v[0], plain_ms=v[1], bound_ms=b_ms,
                                bound_by=b_by, bound_term=b_term,
                                library_ms=None, work=work[k],
                                block_ms=extra[k]["block_ms"],
                                group=f"cluster of {C} CTAs")
                for x in ("us_per_tcg_iter", "block_us_per_tcg_iter",
                          "sweep_ms", "scratch_mb"):
                    if x in extra[k]:
                        stats[k][x] = extra[k][x]
                if k == "ladder":
                    stats[k]["group"] = (f"{extra[k]['clusters']} clusters of "
                                         f"{C} CTAs")
    high_ranks(problems, hp, stats, barrier_us, note)
    phase_small_eigh(stats, probe)
    print("[kernels] max errors vs plain: " + " | ".join(
        f"{k} abs {v['max_abs_err']:.3e} rel {v['max_rel_err']:.3e}"
        for k, v in stats.items()), flush=True)
    print("[kernels] bounds (plaza2-shaped, r=4): " + " | ".join(
        f"{k} {v['bound_ms']:.4f} ms by {v['bound_term']} ({v['work']})"
        for k, v in stats.items()), flush=True)
    return stats


def high_ranks(problems, hp, stats, barrier_us, note):
    """The four chain kernels past rank 10 (HIGH_RANK_CASES): each against
    its plain version on the card at phase 2's tolerances (`note`), the
    ladder's bits at one cluster (its 48 trial points then in as many
    one-cluster launches as shared memory needs) against the chosen K, and
    its scalars at each α against the cluster `step`; each kernel and its
    plain version timed (median of HIGH_REPS) beside its bound. The
    numbers go to `stats[k]["by_rank"]`."""
    import numpy as np
    import torch

    from cora_tpu_torch.ops import tnt_kernels
    from cora_tpu_torch.ops.riemannian import random_initial_guess
    from cora_tpu_torch.ops.tnt_kernels import CudaTNT, PlainTNT
    from cora_tpu_torch.solve.tnt_kernel import get_chain_plan

    C = tnt_kernels.CLUSTER
    al = 4.0 * 0.5 ** np.arange(24)
    al = torch.tensor(np.stack([al, -al], 1).reshape(-1), dtype=torch.float32)
    A = len(al)
    for ci, (gname, rank) in enumerate(HIGH_RANK_CASES):
        problem = problems[gname]
        plan = get_chain_plan(problem, np.float32, "cuda")
        cu, pl = CudaTNT(plan, hp), PlainTNT(plan, hp)
        check(rank <= cu.rank_bound, f"{gname}: rank {rank} over the bound "
              f"{cu.rank_bound}")
        pd = problem.device_data(np.float32, "cuda")
        gen = torch.Generator().manual_seed(200 + ci)
        Y = random_initial_guess(pd, rank, gen).contiguous()
        V = (0.1 * torch.randn(Y.shape, generator=gen, dtype=torch.float64)
             ).to(Y).contiguous()
        what = f"r={rank}"
        for flag in (1, 0):
            a, b = cu.step(Y, V, flag), pl.step(Y, V, flag)
            note("step", a[0], b[0], TOL_STATE, f"{what} flag {flag} Y")
            note("step", a[2], b[2], TOL_GN, f"{what} flag {flag} grad")
            for i, tol in enumerate((TOL_F, TOL_GN, TOL_PGN)):
                note("step", a[3][i:i + 1], b[3][i:i + 1], tol,
                     f"{what} flag {flag} scalar {i}")
        _, QY, G, _ = pl.step(Y, V, False)
        cases = {"boundary": (QY, 5.0), "long": (torch.zeros_like(QY), 1e8)}
        iters = {}
        for case, (nF, delta) in cases.items():
            sa, ta = cu.tcg(G, Y, nF, delta, 80)
            sb, tb = pl.tcg(G, Y, nF, delta, 80)
            ta, tb = ta.tolist(), tb.tolist()
            tag = f"tcg {case} {what}"
            check(abs(ta[2] - tb[2]) <= 2, f"{tag} iterations {ta} {tb}")
            check(ta[1] == tb[1], f"{tag} hit {ta} {tb}")
            check(abs(ta[0] - tb[0]) <= TOL_MDEC * abs(tb[0]),
                  f"{tag} mdec {ta} {tb}")
            check(abs(ta[3] - tb[3]) <= TOL_SNORM * abs(tb[3]),
                  f"{tag} |s| {ta} {tb}")
            st = stats["tcg"]
            st["max_abs_err"] = max(st["max_abs_err"], absdiff(sa, sb))
            st["max_rel_err"] = max(st["max_rel_err"], rel(sa, sb))
            iters[case] = int(ta[2])

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
              f"chunk {what} k/status/streaks {ra[4][:5].tolist()} vs "
              f"{rb[4][:5].tolist()}")
        note("chunk", ra[0], rb[0], TOL_STATE, f"{what} Y")
        note("chunk", ra[3][:1], rb[3][:1], TOL_F, f"{what} f")
        note("chunk", ra[5][0, :8], rb[5][0, :8], TOL_F, f"{what} f history")
        outer, its = int(ra[4][0]), int(ra[5][4, :8].sum())

        K, grp = cu.ladder_split(rank, A)
        _, grp1 = cu.ladder_split(rank, A, 1)
        la, lb = cu.ladder(Y, V, al), pl.ladder(Y, V, al)
        for i, tol in enumerate((TOL_F, TOL_GN, TOL_PGN)):
            note("ladder", la[i], lb[i], tol, f"{what} row {i}")
        one = cu.ladder(Y, V, al, clusters=1)
        check(torch.equal(one, la), f"ladder {what}: K = 1 ({len(grp1) - 1} "
              f"launches) and K = {K} differ by {absdiff(one, la):.3e}")
        worst = 0.0
        for i, a in enumerate(al.tolist()):
            s = (torch.tensor(a, dtype=torch.float32, device="cuda") * V
                 ).contiguous()
            worst = max(worst, rel(la[:, i], cu.step(Y, s, 1)[3]))
        check(worst <= 1e-6, f"ladder {what} vs cluster step: rel "
              f"{worst:.3e}")
        nF = cases["long"][0]
        runs = {
            "step": (lambda: cu.step(Y, V, 1), lambda: pl.step(Y, V, 1),
                     None, tnt_kernels.work_counts(plan, rank, 0, "step",
                                                   parts=C)),
            "tcg": (lambda: cu.tcg(G, Y, nF, 1e8, 80),
                    lambda: pl.tcg(G, Y, nF, 1e8, 80), None,
                    tnt_kernels.work_counts(plan, rank, iters["long"], "tcg",
                                            parts=C)),
            "chunk": (cu.chunk, pl.chunk, chunk_args,
                      tnt_kernels.work_counts(plan, rank, its, "chunk",
                                              outer_iters=outer, init=True,
                                              parts=C)),
            "ladder": (lambda: cu.ladder(Y, V, al),
                       lambda: pl.ladder(Y, V, al), None,
                       tnt_kernels.work_counts(plan, rank, 0, "ladder",
                                               alphas=A, parts=C,
                                               clusters=len(grp) - 1)),
        }
        line = []
        for k, (kern, twin, prep, wc) in runs.items():
            ms = median_ms(kern, torch, prep, reps=HIGH_REPS)
            plain_ms = median_ms(twin, torch, prep, reps=HIGH_REPS)
            b_ms, b_by, b_term = bound(wc, barrier_us)
            stats[k].setdefault("by_rank", {})[f"{gname} r={rank}"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                bound_term=b_term)
            line.append(f"{k} {ms:.3f} ms (plain {plain_ms:.3f} ms, bound "
                        f"{b_ms:.4f} ms by {b_term})")
        print(f"[kernels] {gname} r={rank} (bound {cu.rank_bound}): "
              + " | ".join(line) + f"; tcg iterations {iters}; ladder K = "
              f"{K} over {len(grp) - 1} groups of <= {cu.ladder_batch(rank)}"
              f" trial points, K = 1 in {len(grp1) - 1} launches, bit-equal;"
              f" ladder vs cluster step max rel {worst:.3e}", flush=True)


def check_small_eigh(A, stats, what, comparator=True):
    """`small_eigh` (the kernel) against its plain twin on the card for the
    symmetric matrices A (B, n, n): eigenvalues relative to the largest,
    ‖VᵀV − I‖ and ‖AV − VΛ‖ relative to the largest eigenvalue, within
    EIGH_TOL / EIGH_ORTH; the errors go to `stats["small_eigh"]` (the
    eigenvalues' largest absolute and relative error); with `comparator`,
    the routed kernel's bits against its comparator's. Returns the sweeps
    per matrix."""
    import torch

    from small_eigh_cases import bits_equal

    from cora_tpu_torch.ops.small_eigh import KEYS, MAX_N, route, \
        small_eigh, small_eigh_plain

    dt = "float32" if A.dtype == torch.float32 else "float64"
    n = A.shape[-1]
    which = route(n, A.dtype)
    w, V, info = small_eigh(A)
    wp, Vp, _ = small_eigh_plain(A)
    if comparator:
        # the routed kernel against its comparator (the one-CTA kernel to
        # n = 96, the global one past it), bit for bit; the comparator
        # against the twin as the routed one is below
        old = "cta" if n <= MAX_N else "global"
        ref = small_eigh(A, kernel=old)
        same = bits_equal((w, V, info), ref)
        print(f"[kernels] small_eigh {what}: {KEYS[which]} and "
              f"{KEYS[old]} bit for bit: {same}", flush=True)
        check(same, f"small_eigh {what}: {KEYS[which]} left {KEYS[old]}'s "
              "bits")
        ew = float(((ref[0] - wp).abs().amax(-1)
                    / wp.abs().amax(-1).clamp_min(1e-30)).max())
        check(ew <= EIGH_TOL[dt] and min(ref[2].tolist()) >= 0,
              f"{KEYS[old]} {what}: eigenvalues {ew:.3e}, info "
              f"{ref[2].tolist()}")
        st = stats[KEYS[old]]
        st["max_abs_err"] = max(st["max_abs_err"], absdiff(ref[0], wp))
        st["max_rel_err"] = max(st["max_rel_err"], ew)
    scale = wp.abs().amax(-1).clamp_min(1e-30)
    ev = float(((w - wp).abs().amax(-1) / scale).max())
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    orth = float((V.transpose(-1, -2) @ V - eye).abs().max())
    res = float(((A @ V - V * w[..., None, :]).abs().amax((-2, -1))
                 / scale).max())
    sweeps = info.tolist()
    print(f"[kernels] small_eigh {what}: {A.shape[0]} matrices of n = "
          f"{A.shape[-1]} {dt}: sweeps {min(sweeps)}-{max(sweeps)}, "
          f"eigenvalues rel err {ev:.3e}, |VtV - I| {orth:.3e}, "
          f"|AV - VL| / |L| {res:.3e}", flush=True)
    check(min(sweeps) >= 0, f"small_eigh {what}: not converged {sweeps}")
    check(ev <= EIGH_TOL[dt] and orth <= EIGH_ORTH[dt]
          and res <= EIGH_ORTH[dt], f"small_eigh {what}: eigenvalues "
          f"{ev:.3e}, orthonormality {orth:.3e}, residual {res:.3e}")
    st = stats[KEYS[which]]
    st["max_abs_err"] = max(st["max_abs_err"], absdiff(w, wp))
    st["max_rel_err"] = max(st["max_rel_err"], ev)
    if dt == "float32":
        # the three smallest pairs, the ones LOBPCG keeps, against float64
        # eigh of the same matrices: the kernel (float64 arithmetic) and
        # the twin (float32 eigh)
        wr, Vr = torch.linalg.eigh(A.double())
        errs = {}
        for label, (ww, VV) in (("kernel", (w, V)), ("twin", (wp, Vp))):
            dw = float(((ww[..., :3].double() - wr[..., :3]).abs()
                        .amax(-1) / scale).max())
            dv = float((1 - (VV[..., :3].double() * Vr[..., :3]).sum(-2)
                        .abs()).max())
            errs[label] = f"eigenvalues {dw:.3e}, 1 - |<v, v64>| {dv:.3e}"
        print(f"[kernels] small_eigh {what}: the three smallest pairs "
              "against float64 eigh: " + "; ".join(
                  f"{k} {v}" for k, v in errs.items()), flush=True)
    return sweeps


def phase_small_eigh(stats, probe):
    """`small_eigh` on random symmetric matrices of the Rayleigh–Ritz
    sizes (n = 3k = 30, 36) in float32 and float64 and on the probe's
    graded matrices at n = 10 and 30, held to its plain twin and to its
    comparator's bits (the one-CTA kernel to n = 96, the global kernel
    past it); timed (median of 20, CUDA events) at the main path's n = 30
    in float32, the one-CTA kernel and the routed one in turns, beside the
    twin and `torch.linalg.eigh`, with its bound: the larger of its bytes
    at 3.35 TB/s, its FLOPs at the float64 peak and its dependent rounds
    (sweeps × (n − 1)) times the barrier it waits on each round (the
    `__syncthreads` the probe measured in this run, or its `cluster.sync`
    at the kernel's cluster size, or the grid's counter barrier). The
    cluster family: bit for bit against the one-CTA kernel at n = 36 and
    96 (the grid, the stream route and the global kernel too) and, with
    the grid, against
    the global kernel at EIGH_GLOBAL (1-16 CTAs; the grid at 449-1056), in
    float32 and float64, against the twin in float64 past 96, the float32
    eigenvalues against float64 eigh; timed in turns with the comparator
    (new, old, old, new) at EIGH_TIMED, one call each at EIGH_ONCE; the
    stream route past n = 1056: at EIGH_PAST (rank 352's Rayleigh–Ritz
    size) bit for bit against the global kernel, against the twin at
    EIGH_STREAM, forced against the grid at EIGH_STREAM_FORCED, timed once
    at EIGH_STREAM_TIMED."""
    import numpy as np
    import torch
    from small_eigh_cases import bits_equal, corpus

    from cora_tpu_torch.ops.small_eigh import KEYS, MAX_N, route, \
        small_eigh, small_eigh_plain

    rng = np.random.default_rng(11)
    for n, dt in EIGH_CASES:
        M = rng.standard_normal((4, n, n))
        A = torch.as_tensor(M + M.transpose(0, 2, 1)).to(
            "cuda", getattr(torch, dt))
        sweeps = check_small_eigh(A, stats, "random")
        if (n, dt) == (30, "float32"):  # the main path's matrices
            A1 = A[0].contiguous()
            t = [median_ms(lambda: small_eigh(A1, kernel=k), torch)
                 for k in ("cta", None, None, "cta")]
            ms, cta_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            plain_ms = median_ms(lambda: small_eigh_plain(A1), torch)
            lib_ms = median_ms(lambda: torch.linalg.eigh(A1), torch)
            npad = n + n % 2
            work, terms, term = eigh_bound(n, sweeps[0], 4, probe)
            stats["small_eigh"].update(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=terms[term],
                bound_by="bytes" if term == "bytes" else "operations",
                bound_term=term, work=work,
                group="one CTA of 3 update warps and a rotation warp per "
                "matrix, a lane per row", block_ms=cta_ms,
                turns_ms=t)
            print(f"[kernels] small_eigh n = {n} {dt}: {ms:.4f} ms against "
                  f"the one-CTA kernel's {cta_ms:.4f} ms (in turns one-CTA, "
                  "warp, warp, one-CTA: " + ", ".join(f"{x:.4f}" for x in t)
                  + f" ms; plain twin {plain_ms:.4f} ms, torch.linalg.eigh "
                  f"{lib_ms:.4f} ms); bound {terms[term]:.4f} ms by {term} "
                  f"({sweeps[0]} sweeps × {npad - 1} rounds × "
                  f"{probe['syncthreads_us']:.4f} us)", flush=True)
    for n in EIGH_GRADED:
        for dt in (torch.float32, torch.float64):
            A = torch.as_tensor(np.stack([corpus(n, s)["graded"]
                                          for s in range(4)])).to("cuda", dt)
            check_small_eigh(A, stats, "graded")
    # the cluster family, the grid (on two CTAs), the stream route and the
    # global kernel, forced, against the one-CTA kernel where all five run
    for n in EIGH_FORCED:
        for dt in (torch.float32, torch.float64):
            M = rng.standard_normal((4, n, n))
            A = torch.as_tensor(M + M.transpose(0, 2, 1)).to("cuda", dt)
            cta = small_eigh(A, kernel="cta")
            for k in ("cluster", "grid", "stream", "global"):
                same = bits_equal(small_eigh(A, kernel=k), cta)
                print(f"[kernels] small_eigh n = {n} {dt}: {KEYS[k]} and "
                      f"small_eigh_cta bit for bit: {same}", flush=True)
                check(same, f"small_eigh n = {n}: {KEYS[k]} left the "
                      "one-CTA kernel's bits")
    # past it, the routed cluster family and grid against the global kernel
    # (in check_small_eigh, float64, and here, float32) and against the
    # twin in float64; float32 inputs against float64 eigh of the same
    # matrices
    for n in EIGH_GLOBAL:
        batch = 2 if n <= 320 or n == EIGH_BATCH2 else 1
        M = rng.standard_normal((batch, n, n))
        A = torch.as_tensor(M + M.transpose(0, 2, 1)).to("cuda")
        check_small_eigh(A, stats, "random")
        A32 = A.float()
        r32 = small_eigh(A32)
        which = KEYS[route(n, torch.float32)]
        same = bits_equal(r32, small_eigh(A32, kernel="global"))
        print(f"[kernels] small_eigh n = {n} float32: {which} ({ctas(n)} "
              f"CTAs) and small_eigh_global bit for bit: {same}, sweeps "
              f"{r32[2].tolist()}", flush=True)
        check(same, f"small_eigh n = {n} float32: {which} left the global "
              "kernel's bits")
        w64 = torch.linalg.eigh(A32.double())[0]
        e32 = float(((r32[0].double() - w64).abs().amax(-1)
                     / w64.abs().amax(-1)).max())
        check(e32 <= EIGH_TOL["float32"], f"{which} n = {n} float32: "
              f"eigenvalues {e32:.3e} off float64 eigh")
    stats["small_eigh_cluster"]["group"] = (
        "a cluster of C = 1-16 CTAs per matrix (C by n), rows of A by "
        "circle-method position, a look-ahead warp; then V from the rotation "
        "log, a warp per row")
    stats["small_eigh_grid"]["group"] = (
        "G co-resident CTAs per matrix (a cooperative launch, G by n), the "
        "cluster family's rounds with the boundary rows and the round table "
        "through L2 and a counter barrier; then V from the log")
    stats["small_eigh_cta"]["group"] = ("one CTA per matrix, a thread per "
                                        "2 × 2 block")
    stats["small_eigh_global"]["group"] = (
        "one CTA of up to 1024 threads per matrix, A and V in a global "
        "workspace")
    # the routes against their comparator in turns (new, old, old, new),
    # float32, and at EIGH_ONCE one timed call of each
    for n in EIGH_TIMED + (EIGH_ONCE,):
        M = rng.standard_normal((n, n))
        A1 = torch.as_tensor(M + M.T).to("cuda", torch.float32)
        new = route(n, torch.float32)
        old = "cta" if n <= MAX_N else "global"
        if n == EIGH_ONCE:
            t = [once_ms(lambda: small_eigh(A1, kernel=k), torch)
                 for k in (new, old)]
            t = [t[0], t[1], t[1], t[0]]
            reps = 1
        else:
            reps = REPS if n <= MAX_N else 5 if n <= 320 else EIGH_FEW_REPS
            t = [median_ms(lambda: small_eigh(A1, kernel=k), torch,
                           reps=reps) for k in (new, old, old, new)]
        ms, old_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        sweeps = small_eigh(A1)[2].item()
        timer = once_ms if n == EIGH_ONCE else (
            lambda fn, torch: median_ms(fn, torch, reps=reps))
        plain_ms = timer(lambda: small_eigh_plain(A1), torch)
        lib_ms = timer(lambda: torch.linalg.eigh(A1), torch)
        common = dict(plain_ms=plain_ms, library_ms=lib_ms, n=n)
        for key, k_ms, k_route in ((KEYS[new], ms, new),
                                   (KEYS[old], old_ms, old)):
            work, terms, term = eigh_bound(n, sweeps, 4, probe, k_route)
            entry = dict(common, ms=k_ms, bound_ms=terms[term],
                         bound_by="bytes" if term == "bytes" else
                         "operations", bound_term=term, work=work,
                         turns_ms=t, sweeps=sweeps)
            if k_route == new:
                entry.update(ctas=ctas(n), block_ms=old_ms,
                             comparator=KEYS[old])
            st = stats[key]
            st.setdefault("by_n", {})[n] = entry
            # the certificate path's n heads each line: 99 (rank 31) the
            # cluster family's, 516 (rank 170) the grid's, 36 the one-CTA
            # kernel's, 324 (rank 106) the global kernel's, the comparator
            # there
            if (key, n) in (("small_eigh_cluster", 99), ("small_eigh_grid", 516),
                            ("small_eigh_cta", 36), ("small_eigh_global", 324)):
                st.update(entry)
        b = stats[KEYS[new]]["by_n"][n]
        print(f"[kernels] {KEYS[new]} n = {n} float32 ({ctas(n)} CTAs, "
              f"{sweeps} sweeps): {ms:.4f} ms against {KEYS[old]}'s "
              f"{old_ms:.4f} ms ("
              + ("one call each" if n == EIGH_ONCE else
                 f"median of {reps}, in turns new, old, old, new: "
                 + ", ".join(f"{x:.4f}" for x in t) + " ms")
              + f"; plain twin {plain_ms:.4f} ms, torch.linalg.eigh "
              f"{lib_ms:.4f} ms); bound {b['bound_ms']:.4f} ms by "
              f"{b['bound_term']} ({sweeps} sweeps × {n + n % 2 - 1} rounds × "
              f"the {barrier_name(n, new, probe)} of this run)", flush=True)

    # the stream route past the grid's largest n: at the certificate path's
    # n there (rank 352) bit for bit against the global kernel in float64
    # (check_small_eigh) and float32 (the global kernel's call timed: the
    # comparator's time); against the twin in float64 at EIGH_STREAM;
    # forced at EIGH_STREAM_FORCED bit for bit against the grid
    n = EIGH_PAST
    check(route(n, torch.float64) == "stream",
          f"small_eigh n = {n}: routed {route(n, torch.float64)}")
    for n in EIGH_STREAM:
        M = rng.standard_normal((1, n, n))
        A = torch.as_tensor(M + M.transpose(0, 2, 1)).to("cuda")
        check_small_eigh(A, stats, "random (the stream route)",
                         comparator=n == EIGH_PAST)
        if n != EIGH_PAST:
            continue
        A32 = A[0].float()
        r32 = small_eigh(A32)
        out = []
        global_ms = once_ms(lambda: out.append(small_eigh(A32, kernel="global")),
                            torch)
        same = bits_equal(r32, out[0])
        print(f"[kernels] small_eigh n = {n} float32: small_eigh_stream "
              f"({ctas(n)} CTAs) and small_eigh_global bit for bit: {same}, "
              f"sweeps {r32[2].item()}; the global kernel {global_ms:.4f} ms, "
              "one call", flush=True)
        check(same, f"small_eigh n = {n} float32: small_eigh_stream left the "
              "global kernel's bits")
    for n in EIGH_STREAM_FORCED:
        M = rng.standard_normal((n, n))
        for dt in (torch.float32, torch.float64):
            A = torch.as_tensor(M + M.T).to("cuda", dt)
            same = bits_equal(small_eigh(A, kernel="stream"), small_eigh(A))
            print(f"[kernels] small_eigh n = {n} {str(dt)[6:]}: "
                  f"small_eigh_stream forced ({ctas(n, 'stream')} CTAs) and "
                  f"small_eigh_grid bit for bit: {same}", flush=True)
            check(same, f"small_eigh n = {n}: the stream route left the "
                  "grid's bits")
    stats["small_eigh_stream"]["group"] = (
        "G co-resident CTAs per matrix (a cooperative launch, G by n), A by "
        "index in L2, each CTA rewriting its pairs' rows in place, one "
        "counter barrier a round; then V from the log, the sort")
    # one timed call each (float32) beside the twin and torch.linalg.eigh
    for n in EIGH_STREAM_TIMED:
        M = rng.standard_normal((n, n))
        A1 = torch.as_tensor(M + M.T).to("cuda", torch.float32)
        out = []
        ms = once_ms(lambda: out.append(small_eigh(A1)), torch)
        sweeps = out[0][2].item()
        plain_ms = once_ms(lambda: small_eigh_plain(A1), torch)
        lib_ms = once_ms(lambda: torch.linalg.eigh(A1), torch)
        work, terms, term = eigh_bound(n, sweeps, 4, probe, "stream")
        entry = dict(n=n, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=terms[term], bound_by="bytes" if term == "bytes"
                     else "operations", bound_term=term, work=work,
                     sweeps=sweeps, ctas=ctas(n))
        if n == EIGH_PAST:
            entry.update(block_ms=global_ms, comparator="small_eigh_global")
            stats["small_eigh_global"].setdefault("by_n", {})[n] = dict(
                n=n, ms=global_ms, comparator_of="small_eigh_stream")
        st = stats["small_eigh_stream"]
        st.setdefault("by_n", {})[n] = entry
        if n == EIGH_PAST:  # the certificate path's n heads the line
            st.update(entry)
        print(f"[kernels] small_eigh_stream n = {n} float32 ({ctas(n)} CTAs, "
              f"{sweeps} sweeps): {ms:.4f} ms, one call (plain twin "
              f"{plain_ms:.4f} ms, torch.linalg.eigh {lib_ms:.4f} ms"
              + (f"; small_eigh_global {global_ms:.4f} ms"
                 if n == EIGH_PAST else "")
              + f"); bound {terms[term]:.4f} ms by {term} ({sweeps} sweeps × "
              f"{n + n % 2 - 1} rounds × the {barrier_name(n, 'stream', probe)}"
              " of this run)", flush=True)


def ctas(n, which=None):
    """The CTAs of small_eigh's cluster family, grid or stream route at n
    (the route's, or `which`'s)."""
    from cora_tpu_torch.ops.small_eigh import cluster_size, grid_size, \
        stream_size

    if which == "stream":
        return stream_size(n)
    return cluster_size(n) or grid_size(n) or stream_size(n)


def once_ms(fn, torch):
    """One call's device time (CUDA events), after the inputs are ready."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def grid_barrier_us(probe, G):
    """The counter barrier the probe measured at the largest CTA count not
    above G (the barrier's cost grows with the CTAs: a lower bound)."""
    meas = probe["grid_barrier_us"]["counter"]
    return meas[str(max(int(g) for g in meas if int(g) <= G))]


def barrier_name(n, which, probe):
    """The barrier a round of route `which` waits on at n, as named in the
    bound."""
    if which in ("grid", "stream"):
        G = ctas(n, which)
        at = max(int(g) for g in probe["grid_barrier_us"]["counter"]
                 if int(g) <= G)
        return f"counter barrier at {at} CTAs ({G} run)"
    C = ctas(n) if which == "cluster" else 1
    return "__syncthreads" if C == 1 else f"{C}-CTA cluster.sync"


def eigh_bound(n, sweeps, itemsize, probe, which="warp"):
    """small_eigh's work at n × n over `sweeps` sweeps on route `which` and
    its bound terms (ms): the input read and w, V written once at 3.35
    TB/s, the FLOPs at the float64 peak, and the dependent rounds (sweeps ×
    (n − 1)) times the barrier a round waits on, measured by the probe in
    this run: `__syncthreads` in one CTA (the one-warp, one-CTA and global
    kernels, the cluster family at C = 1), `cluster.sync` over the cluster
    family's C CTAs, the grid's counter barrier (`grid_barrier_us`).
    (work, terms, the largest term)."""
    npad, h = n + n % 2, (n + n % 2) // 2
    rounds = sweeps * (npad - 1)
    if which in ("grid", "stream"):
        barrier_us = grid_barrier_us(probe, ctas(n, which))
    else:
        C = ctas(n) if which == "cluster" else 1
        barrier_us = (probe["syncthreads_us"] if C == 1 else
                      probe["cluster_sync_us"][str(C)])
    work = dict(bytes=itemsize * (2 * n * n + n),
                flops=rounds * (12 * h * (h + 1) + 6 * n * h + 15 * h)
                + (sweeps + 1) * 2 * npad * npad,
                phases=rounds)
    terms = {"bytes": work["bytes"] / 3.35e12 * 1e3,
             "flops": work["flops"] / PEAK_F64 * 1e3,
             "barriers": rounds * barrier_us * 1e-3}
    return work, terms, max(terms, key=terms.get)


def solve_once(problem, cfg, x0, device="cuda", **kw):
    """`solve_cora` from x0 (`kw` passed on): (result, wall s, ATE, every
    TNT level's result in order). The staircase's `tnt_solve_tiles` (chain
    kernels) and `tnt_solve` (canonical path) are wrapped for the call to
    keep each level's result as the level returned it, and its arguments in
    `LEVEL_CALLS`;
    the device loop's counts (`tnt.LOOP_STATS`) are zeroed first, so after
    the call they are this solve's. The certificate's and the polish's
    loop counts, small_eigh's launches (both kernels), the certify / polish
    split and the certificate and polish calls go to `LAST`."""
    import probe_cert_loop as cert_probe
    import torch

    from cora_tpu_torch.ops import lobpcg, small_eigh
    from cora_tpu_torch.solve import polish, staircase, tnt
    from cora_tpu_torch.utils.evaluation import evaluate_ate

    levels = []
    LEVEL_CALLS.clear()
    tnt.reset_loop_stats()
    lobpcg.reset_loop_stats()
    polish.reset_loop_stats()
    eigh0 = sum(small_eigh.LAUNCHES.values())
    solvers = {name: getattr(staircase, name)
               for name in ("tnt_solve_tiles", "tnt_solve")}

    def recording(solve):
        def run(*args, **kwargs):
            LEVEL_CALLS.append((args, kwargs))
            res = solve(*args, **kwargs)
            # a copy: the staircase rebinds the result's `x` and `f` to the
            # trimmed and polished state
            levels.append(copy.copy(res))
            return res
        return run

    for name, solve in solvers.items():
        setattr(staircase, name, recording(solve))
    try:
        with cert_probe.split_timers() as parts, \
                cert_probe.recording() as calls:
            torch.cuda.synchronize()
            t0 = time.time()
            res = staircase.solve_cora(problem, x0=x0, config=cfg,
                                       device=device, **kw)
            torch.cuda.synchronize()
            wall = time.time() - t0
    finally:
        for name, solve in solvers.items():
            setattr(staircase, name, solve)
    LAST.update(lobpcg=dict(lobpcg.LOOP_STATS), cg=dict(polish.LOOP_STATS),
                parts=dict(parts), calls=calls,
                small_eigh=sum(small_eigh.LAUNCHES.values()) - eigh0)
    ate = float(evaluate_ate(problem,
                             staircase.extract_solution(problem, cfg, res)))
    return res, wall, ate, levels


def cert_line(tag, name):
    """The last `solve_once`'s certificate and polish loops: LOBPCG
    iterations, captures, replays, host reads per LOBPCG iteration;
    Newton-CG iterations and host reads per CG iteration; small_eigh
    launches; the certify and polish phases split into their parts
    (`probe_cert_loop.split_timers`)."""
    lp, cg = LAST["lobpcg"], LAST["cg"]
    certs = [c[4] for c in LAST["calls"] if c[0] == "certify"]
    failed = sum(not c.is_certified and c.num_iters > 0 for c in certs)
    print(f"[{tag}] {name}: certificates {len(certs)} ({failed} failed "
          f"with LOBPCG); LOBPCG {lp['iterations']} "
          f"iterations in {lp['solves']} stage runs, {lp['captures']} "
          f"captures in {lp['capture_s']:.3f} s, {lp['replays']} replays, "
          f"{lp['eager_calls']} eager calls, {lp['host_reads']} host reads "
          f"({lp['host_reads'] / max(lp['iterations'], 1):.4f} per LOBPCG "
          f"iteration), small_eigh launches {LAST['small_eigh']}; polish "
          f"Newton-CG {cg['cg_iters']} CG iterations in "
          f"{cg['newton_steps']} Newton steps, {cg['captures']} captures in "
          f"{cg['capture_s']:.3f} s, {cg['replays']} replays, "
          f"{cg['eager_calls']} eager calls, {cg['host_reads']} host reads "
          f"({cg['host_reads'] / max(cg['cg_iters'], 1):.4f} per CG "
          "iteration)", flush=True)
    print(f"[{tag}] {name}: split " + json.dumps(
        {k: round(v, 4) for k, v in LAST["parts"].items()}), flush=True)


def captured_loops(name):
    """In the last `solve_once`, every failed certificate's LOBPCG and
    every polish's CG ran as replayed graphs (no eager step call), the
    LOBPCG through small_eigh (either kernel: the one-CTA one from rank
    9)."""
    lp, cg = LAST["lobpcg"], LAST["cg"]
    failed = any(c[0] == "certify" and not c[4].is_certified
                 and c[4].num_iters > 0 for c in LAST["calls"])
    check(not failed or (lp["replays"] > 0 and not lp["eager_calls"]
                         and LAST["small_eigh"] > 0),
          f"{name}: failed certificates' LOBPCG not captured: {lp}, "
          f"small_eigh launches {LAST['small_eigh']}")
    check(not cg["newton_steps"] or (cg["replays"] > 0
                                     and not cg["eager_calls"]),
          f"{name}: the polish CG not captured: {cg}")


def loop_line(tag, name, res, levels):
    """The device loop's counts over the last `solve_once`: captures and
    their seconds, replays, eager step calls, host reads per tCG iteration,
    and the TNT phases' wall per tCG iteration. Returns the counts."""
    from cora_tpu_torch.solve import tnt

    st = dict(tnt.LOOP_STATS)
    tcg = int(sum(lv.inner_iterations.sum() for lv in levels))
    tnt_s = res.phases.get("tnt_level", 0.0) + res.phases.get("tnt_refine",
                                                              0.0)
    print(f"[{tag}] {name}: device loop {st['captures']} captures in "
          f"{st['capture_s']:.3f} s, {st['replays']} replays, "
          f"{st['eager_calls']} eager step calls, {st['host_reads']} host "
          f"reads over {tcg} tCG iterations ({st['host_reads'] / max(tcg, 1):.4f}"
          f" per tCG iteration, {st['blocks']} blocks, {st['outer_iters']} "
          f"outer iterations); tnt_level + tnt_refine {tnt_s:.3f} s, "
          f"{1e6 * tnt_s / max(tcg, 1):.2f} us per tCG iteration",
          flush=True)
    cert_line(tag, name)
    return st


def same_level(a, b):
    """Two TNT level results on the same bits: state, f, norms, status and
    every history."""
    import numpy as np
    import torch

    return bool(torch.equal(a.x, b.x) and a.f == b.f
                and a.gradfx_norm == b.gradfx_norm
                and a.status == b.status
                and a.num_iterations == b.num_iterations
                and all(np.array_equal(getattr(a, h), getattr(b, h))
                        for h in ("objective_values", "gradient_norms",
                                  "preconditioned_gradient_norms",
                                  "update_step_norms", "inner_iterations")))


def rerun_level(call, **opts):
    """A recorded level call again under `tnt.device_loop(**opts)`:
    (result, wall s, loop counts)."""
    import torch

    from cora_tpu_torch.solve import tnt

    args, kwargs = call
    tnt.reset_loop_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    with tnt.device_loop(**opts):
        res = tnt.tnt_solve(*args, **kwargs)
    torch.cuda.synchronize()
    return res, time.time() - t0, dict(tnt.LOOP_STATS)


def sync_checked_level(tag, name, call):
    """The recorded level captured afresh with every warm-up, capture and
    first replay under `set_sync_debug_mode("error")`: a host
    synchronisation in a step function raises."""
    from cora_tpu_torch.solve import tnt

    tnt.clear_graphs()
    res, wall, st = rerun_level(call, sync_debug=True)
    print(f"[{tag}] {name}: first level captured and replayed under "
          f"set_sync_debug_mode('error'): {st['captures']} captures, "
          f"{st['replays']} replays, {res.num_iterations} iterations, "
          f"{wall:.3f} s, no host synchronisation", flush=True)
    check(st["captures"] == 3 and st["replays"] >= 3,
          f"{name}: sync-checked level made {st}")
    tnt.clear_graphs()
    return res


def device_busy(tag, name, call):
    """A level call's device-busy share under `torch.profiler` (CUDA
    activity), as `scripts/profile_torch_general.py` measures it: its
    graphs captured by a first run outside the window, the second run
    profiled; device kernels, their summed device time over the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rerun_level(call)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res, wall, st = rerun_level(call)
    avg = prof.key_averages()
    dev = ([e for e in avg if e.device_type == DeviceType.CUDA]
           or [e for e in avg if device_us(e) > 0
               and not e.self_cpu_time_total])
    device_s = sum(device_us(e) for e in dev) * 1e-6
    n = sum(e.count for e in dev)
    print(f"[{tag}] {name}: level under torch.profiler: {wall:.3f} s "
          f"wall, {res.num_iterations} iterations, {st['captures']} captures,"
          f" {n} device kernels, {device_s:.3f} s device time, busy share "
          f"{device_s / wall:.4f}", flush=True)
    check(n > 0, f"{name}: the profiler saw no device kernel")
    return device_s / wall


def device_us(e) -> float:
    """An averaged event's own device time in µs (the attribute's name
    changed across torch versions)."""
    v = getattr(e, "self_device_time_total", None)
    return float(v if v is not None else e.self_cuda_time_total)


def check_first_level(name, level, ref, tol_f=TOL_LEVEL_F,
                      tol_gn=TOL_LEVEL_GN):
    """The first TNT level against the JAX run's from the same projected
    start (fixture `level0`): f and ‖grad‖ per iteration over the first
    chunk, within `tol_f` / `tol_gn` relative. Prints how long f stays
    within `tol_f` of the reference over the recorded iterations."""
    import numpy as np

    f_ref = np.asarray(ref["level0"]["f"])
    g_ref = np.asarray(ref["level0"]["grad_norm"])
    n = min(len(f_ref), level.num_iterations)
    check(n >= FIRST_CHUNK, f"{name}: first level ran {n} iterations")
    ef = np.abs(level.objective_values[:n] - f_ref[:n]) / np.abs(f_ref[:n])
    eg = np.abs(level.gradient_norms[:n] - g_ref[:n]) / np.abs(g_ref[:n])
    apart = np.flatnonzero(ef > tol_f)
    print(f"[slice] {name} first level vs JAX: iterations 1-{FIRST_CHUNK} f "
          f"rel err <= {ef[:FIRST_CHUNK].max():.3e}, |grad| rel err <= "
          f"{eg[:FIRST_CHUNK].max():.3e}; f first parts by > {tol_f:g} "
          f"at iteration {int(apart[0]) + 1 if apart.size else 'none'} of "
          f"{n} recorded", flush=True)
    check(ef[:FIRST_CHUNK].max() <= tol_f
          and eg[:FIRST_CHUNK].max() <= tol_gn,
          f"{name}: first level leaves the JAX trajectory: f rel "
          f"{ef[:FIRST_CHUNK]}, |grad| rel {eg[:FIRST_CHUNK]}")


def gate(name, problem, res, ate, ref, max_levels=5, Y=None):
    """bench.py's gates (bench.py:311-317) against the JAX run on the same
    graph and start: `certified` equal, final cost within 1 %, ATE at most
    0.05 m above, at most `max_levels` levels. The final cost is recomputed here in
    float64 from Q and the returned state (`Y`, the translation-explicit
    state, when given), which must lie on the manifold.

    Where the fixture holds a `spread` (the JAX package's run from five
    starts) and a quantity moves across it by more than its gate's width
    (1 % of the cost, 0.05 m of ATE), the port is held to the worst the JAX
    package reaches from those starts instead: final cost at most 1 % above
    the highest, ATE at most 0.05 m above the highest. A lower cost is a
    better feasible estimate, so it passes. A quantity that moves less keeps
    its gate against the run from the fixture's own start."""
    import numpy as np

    from cora_tpu_torch.solve.rounding import check_variables_are_valid

    if Y is None:
        Y = res.result.x.detach().cpu().double().numpy()
    f64 = 0.5 * float(np.sum(Y * (problem.data_matrix() @ Y)))
    check_variables_are_valid(problem.device_data(np.float64, "cpu"), Y,
                              atol=1e-4)
    spread = ref.get("spread") or {}
    fs, ates = spread.get("f", [ref["f"]]), spread.get("ate", [ref["ate"]])
    if max(fs) - min(fs) > 0.01 * min(fs):
        cost_ok = res.result.f <= 1.01 * max(fs)
    else:
        cost_ok = abs(res.result.f - ref["f"]) <= 0.01 * ref["f"]
    if max(ates) - min(ates) > 0.05:
        ate_ok = ate <= max(ates) + 0.05
    else:
        ate_ok = ate <= ref["ate"] + 0.05
    gates = {
        "certified_equal": bool(res.certified) == ref["certified"],
        "cost_within_1pct": bool(cost_ok),
        "cost_recomputed_f64": bool(abs(f64 - res.result.f)
                                    <= 1e-4 * abs(res.result.f)),
        "ate_le_ref_plus_0.05": bool(ate_ok),
        f"levels_le_{max_levels}": len(res.ranks_visited) <= max_levels,
        "finite": bool(np.isfinite(res.result.f) and np.isfinite(ate)),
    }
    check(all(gates.values()), f"{name}: gates {gates}")


def bench_config(reference, init_rank_jump, use_kernels, **kw):
    """bench.py's main-path config (bench.py:43-62) with the wall-clock caps
    of the reference runs; `kw` sets or overrides fields."""
    import numpy as np

    from cora_tpu_torch.types import (
        Formulation,
        Preconditioner,
        SolverConfig,
        TNTParams,
    )

    C = reference["config"]
    fields = dict(
        preconditioner=Preconditioner.REGULARIZED_CHOLESKY,
        formulation=Formulation.EXPLICIT,
        dtype=np.float32,
        max_staircase_iterations=C["max_staircase_iterations"],
        ramp_tcg_iterations=C["ramp_tcg_iterations"],
        seed=C["seed"],
        init_rank_jump=init_rank_jump,
        polish_time_budget=C["polish_time_budget"],
        tnt=TNTParams(max_computation_time=C["max_computation_time"]),
        use_kernels=use_kernels,
    )
    fields.update(kw)  # e.g. the implicit runs' dtype and formulation
    return SolverConfig(**fields)


def numpy_start(reference, problem, rank):
    """The fixture's start: uniform in [-1, 1] from its `x0_seed`."""
    import numpy as np

    return np.random.default_rng(reference["x0_seed"]).uniform(
        -1.0, 1.0, (problem.data_matrix_size, rank))


def phase_slice(problems, reference):
    import numpy as np
    import torch

    from cora_tpu_torch.ops import small_eigh, tnt_kernels

    runs = reference["graphs"]

    def config(name, use_kernels):
        return bench_config(reference, runs[name]["init_rank_jump"],
                            use_kernels)

    starts = {name: numpy_start(reference, problems[name],
                                rec["graph"]["dim"] + rec["init_rank_jump"])
              for name, rec in runs.items()}
    # bench.py's start rank d + 2 for both graphs; the plaza2-shaped run
    # from rank d is the one that fails a certificate and escapes a saddle
    bench = [n for n, rec in runs.items() if rec["init_rank_jump"] == 2]
    warm = {name: solve_once(problems[name], config(name, "auto"),
                             starts[name])[0] for name in bench}
    tnt_kernels.reset_launch_counts()
    small_eigh.reset_launch_counts()
    results, per_solve, before, loops = {}, {}, {}, {}
    for name in runs:
        results[name] = solve_once(problems[name], config(name, "auto"),
                                   starts[name])
        loops[name] = dict(LAST)
        counts = dict(tnt_kernels.LAUNCHES, **small_eigh.LAUNCHES)
        per_solve[name] = {k: v - before.get(k, 0)
                           for k, v in counts.items() if v}
        before = counts
    launches = dict(tnt_kernels.LAUNCHES, **small_eigh.LAUNCHES)
    # the kernels and the float64 polish reduce in a fixed order: a second
    # solve from the same start ends on the same bits
    for name, res in warm.items():
        same = bool(torch.equal(res.result.x, results[name][0].result.x))
        print(f"[slice] {name}: warm-up and timed solve end on the same "
              f"state: {same}", flush=True)
        check(same, f"{name}: two solves from one start differ")
    for name, (res, wall, ate, levels) in results.items():
        ref = runs[name]
        check_first_level(name, levels[0], ref)
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
        tcg_iters = int(sum(lv.inner_iterations.sum() for lv in levels))
        tnt_s = res.phases.get("tnt_level", 0.0) + res.phases.get(
            "tnt_refine", 0.0)
        print(f"[slice] {name}: {tcg_iters} tCG iterations over "
              f"{len(levels)} TNT levels; tnt_level + tnt_refine "
              f"{tnt_s:.3f} s, {1e6 * tnt_s / max(tcg_iters, 1):.2f} us per "
              f"tCG iteration", flush=True)
        LAST.update(loops[name])
        cert_line("slice", name)
        captured_loops(name)
        print(f"[slice] {name} reference (JAX, CPU): " + json.dumps(
            {k: ref[k] for k in ("certified", "sdp_cost", "f", "ate",
                                 "ranks", "spread") if k in ref}), flush=True)
    print(f"[slice] launches in the timed kernel-path solves: "
          f"{json.dumps(launches)}; per solve {json.dumps(per_solve)}",
          flush=True)
    # a certificate at rank r runs LOBPCG on k = max(10, r + 2) columns: its
    # 3k × 3k Rayleigh–Ritz matrices route to the cluster family from r = 9
    top = max(max(res.ranks_visited) for res, *_ in results.values())
    print(f"[slice] small_eigh: one-warp kernel {launches['small_eigh']} "
          f"launches, cluster family {launches['small_eigh_cluster']} "
          f"(highest rank {top}: n = 3k ≤ {3 * max(10, top + 2)}), grid "
          f"{launches['small_eigh_grid']}, stream "
          f"{launches['small_eigh_stream']}, comparators "
          f"{[launches[k] for k in EIGH_COMPARATORS]}", flush=True)
    check(top >= 9 or not launches["small_eigh_cluster"],
          f"the cluster small_eigh ran on the main path at n ≤ 32: {launches}")
    check(not any(launches[k] for k in EIGH_COMPARATORS
                  + ("small_eigh_grid", "small_eigh_stream")),
          f"a small_eigh comparator, the grid or the stream route (n > 448) "
          f"ran on the main path: {launches}")
    for name in bench:
        res, wall, ate, levels = solve_once(
            problems[name], config(name, "never"), starts[name])
        check_first_level(name + " (plain)", levels[0], runs[name])
        gate(name + " (plain)", problems[name], res, ate, runs[name])
        cert_line("slice", name + " plain")
        print(f"[slice] {name} plain: ranks {res.ranks_visited} certified "
              f"{res.certified} sdp_cost {res.sdp_cost:.6f} f "
              f"{res.result.f:.6f} ATE {ate:.4f} m wall {wall:.3f} s phases "
              + json.dumps({k: round(v, 4) for k, v in res.phases.items()}),
              flush=True)
    return launches


def cert_config(reference):
    """Phase 3b's plaza2-shaped configuration (its certificates'
    parameters)."""
    dim = reference["graphs"]["plaza2_shaped"]["graph"]["dim"]
    return bench_config(reference, RANK_START - dim, "auto",
                        max_rank=RANK_MAX)


def cert_point(pd, r):
    """Phase 3b's random point at rank r on the plaza2-shaped graph."""
    import torch

    from cora_tpu_torch.ops.riemannian import random_initial_guess

    return random_initial_guess(pd, r, torch.Generator().manual_seed(300 + r))


def certificate_run(problem, pd, cfg, Y, force_3k=None):
    """The certificate (`method="auto"`) at the point Y as the staircase
    takes it, its LOBPCG as replayed graphs; `force_3k` puts its 3k × 3k
    Rayleigh–Ritz matrices on that small_eigh kernel (`lobpcg.small_eigh`
    patched, the kept certificate loop cleared before and after, so that
    the capture is fresh). The launch counts and LOBPCG's loop counts are
    zeroed first. (certificate, s, LOBPCG's loop counts)."""
    import torch

    from cora_tpu_torch.ops import lobpcg, small_eigh
    from cora_tpu_torch.solve import staircase
    from cora_tpu_torch.utils.graphs import clear_graphs, device_loop

    real = lobpcg.small_eigh
    if force_3k:
        k = max(cfg.cert.lobpcg_block_size, Y.shape[1] + 2)
        lobpcg.small_eigh = lambda A: real(
            A, kernel=force_3k if A.shape[-1] == 3 * k else None)
        clear_graphs("certificate")
    try:
        small_eigh.reset_launch_counts()
        lobpcg.reset_loop_stats()
        t0 = time.time()
        with device_loop(graphs=True):
            cert = staircase._certify_with_retry(
                problem, pd, Y.cpu().numpy(), 1e-5, cfg.cert, None)
        torch.cuda.synchronize()
        return cert, time.time() - t0, dict(lobpcg.LOOP_STATS)
    finally:
        if force_3k:
            lobpcg.small_eigh = real
            clear_graphs("certificate")


def phase_ranks(problems, reference):
    """Past the main path's ranks, each path driven with the launch counts
    zeroed just before it and read just after: the plaza2-shaped staircase
    from rank RANK_START (the fixture's numpy start at that rank) with
    max_rank RANK_MAX on the chain kernels, gated as phase 3 against the
    fixture's plaza2-shaped run (the certified optimum does not depend on
    the start rank); a staircase from rank ESCAPE_START on ESCAPE_GRAPH
    whose certificate fails at rank 10, so that the escape (`step`,
    `ladder`) runs past rank 10 on the kernels, gated against the chain
    plain path's solve (`use_kernels="never"`) of the same graph from the
    same start; a failed
    certificate at rank 10, 31, 106, 150 and 352 (`method="auto"` at a
    random point), whose LOBPCG must run as replayed graphs through the
    routes of its 3k × 3k and k × k Rayleigh–Ritz matrices alone: the
    cluster small_eigh (16 CTAs at rank 106's n = 324), at rank 150 (n =
    456) the grid, whose certificate is run again with those matrices on
    the global kernel and must reach its verdict and θ, and at rank 352 (n
    = 1062) the stream route (its run against the global kernel, ~2.7
    minutes, is `scripts/probe_small_eigh.py --cert`'s); the visualize
    CLI's solve half, still and `--animate`, as the CLI runs it (float64,
    so the canonical path), on a one-robot chain written as PyFG, the
    drawing where matplotlib imports.
    Returns the certificate path's launches per small_eigh route."""
    import tempfile

    import numpy as np
    import torch
    from torch_port_reference import multi_robot_pyfg, noisy_chain_pyfg

    from cora_tpu_torch import visualize
    from cora_tpu_torch.io.pyfg import parse_pyfg
    from cora_tpu_torch.ops import lobpcg, small_eigh, tnt_kernels
    from cora_tpu_torch.ops.riemannian import random_initial_guess
    from cora_tpu_torch.solve import staircase
    from cora_tpu_torch.utils.graphs import clear_graphs, device_loop

    def kernel_run(tag, problem, cfg, x0):
        tnt_kernels.reset_launch_counts()
        small_eigh.reset_launch_counts()
        res, wall, ate, _ = solve_once(problem, cfg, x0)
        launches = {k: v for k, v in dict(tnt_kernels.LAUNCHES,
                                          **small_eigh.LAUNCHES).items() if v}
        check(staircase.kernel_path_reason(
            cfg, problem.device_data(np.float32, "cuda")) is None
            and launches.get("chunk", 0) > 0,
            f"{tag}: not on the chain kernels: {res.ranks_visited}, "
            f"{launches}")
        check(not any(launches.get(k) for k in COMPARATORS),
              f"{tag}: a single-CTA comparator ran: {launches}")
        return res, wall, ate, launches

    name = "plaza2_shaped"
    problem, ref = problems[name], reference["graphs"][name]
    dim = ref["graph"]["dim"]
    cfg = bench_config(reference, RANK_START - dim, "auto",
                       max_rank=RANK_MAX)
    tag = f"{name} from rank {RANK_START}"
    res, wall, ate, launches = kernel_run(
        tag, problem, cfg, numpy_start(reference, problem, RANK_START))
    print(f"[ranks] {tag} (max_rank {RANK_MAX}): ranks {res.ranks_visited} "
          f"certified {res.certified} sdp_cost {res.sdp_cost:.6f} f "
          f"{res.result.f:.6f} (reference {ref['f']:.6f}, rel "
          f"{(res.result.f - ref['f']) / ref['f']:+.2e}) ATE {ate:.4f} m "
          f"(reference {ref['ate']:.4f}) wall {wall:.3f} s; launches "
          f"{json.dumps(launches)}", flush=True)
    check(res.ranks_visited[0] == RANK_START,
          f"{tag}: ranks {res.ranks_visited}")
    gate(tag, problem, res, ate, ref)
    cert_line("ranks", tag)
    captured_loops(tag)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "noisy_chain.pyfg")
        with open(path, "w") as fh:
            fh.write(noisy_chain_pyfg(**ESCAPE_GRAPH))
        problem = parse_pyfg(path)
    x0 = np.random.default_rng(reference["x0_seed"]).uniform(
        -1.0, 1.0, (problem.data_matrix_size, ESCAPE_START))
    runs = {}
    for use_kernels in ("never", "auto"):
        ecfg = bench_config(reference, ESCAPE_START - problem.dim,
                            use_kernels, max_rank=ESCAPE_MAX, **ESCAPE_CONFIG)
        tag = f"noisy chain from rank {ESCAPE_START} ({use_kernels})"
        if use_kernels == "auto":
            res, wall, ate, launches = kernel_run(tag, problem, ecfg, x0)
        else:
            tnt_kernels.reset_launch_counts()
            res, wall, ate, _ = solve_once(problem, ecfg, x0)
            launches = {k: v for k, v in tnt_kernels.LAUNCHES.items() if v}
            check(not launches, f"{tag}: kernels launched {launches}")
        failed = sum(1 for c in LAST["calls"] if c[0] == "certify"
                     and not c[4].is_certified)
        print(f"[ranks] {tag} (max_rank {ESCAPE_MAX}): ranks "
              f"{res.ranks_visited} certified {res.certified} sdp_cost "
              f"{res.sdp_cost:.6f} f {res.result.f:.6f} ATE {ate:.4f} m wall "
              f"{wall:.3f} s; failed certificates {failed}; launches "
              f"{json.dumps(launches)}", flush=True)
        cert_line("ranks", tag)
        if use_kernels == "auto":  # the plain path's loops run eagerly
            captured_loops(tag)
        runs[use_kernels] = res, ate
    res, ate = runs["auto"]
    # each escape starts a level one rank up: every level after the first
    # at rank 11 or more puts every escape's `ladder` and `step` past 10
    check(res.ranks_visited[0] == ESCAPE_START
          and min(res.ranks_visited[1:] or [0]) > 10
          and launches.get("ladder", 0) > 0 and launches.get("step", 0) > 0,
          f"{tag}: no escape past rank 10 on the kernels: ranks "
          f"{res.ranks_visited}, launches {launches}")
    plain, plain_ate = runs["never"]
    gate(tag, problem, res, ate, dict(certified=plain.certified,
                                      f=plain.result.f, ate=plain_ate))

    pd = problems[name].device_data(np.float32, "cuda")
    cert_launches = {}

    def certify_at(r, Y):
        return certificate_run(problems[name], pd, cfg, Y)

    for key, r in CERT_RANKS:
        Y = cert_point(pd, r)
        # LOBPCG's Rayleigh–Ritz matrices: 3k × 3k (the route `key` names)
        # and k × k, k = max(10, r + 2)
        k = max(cfg.cert.lobpcg_block_size, r + 2)
        routes = {m: small_eigh.KEYS[small_eigh.route(m, torch.float32)]
                  for m in (3 * k, k)}
        check(routes[3 * k] == key, f"rank {r}: n = {3 * k} routes to "
              f"{routes[3 * k]}, not {key}")
        cert, took, lp = certify_at(r, Y)
        # the routes past n = 32 (the one-warp kernel's count is the main
        # path's)
        for used in set(routes.values()) - {"small_eigh"}:
            cert_launches[used] = cert_launches.get(used, 0) \
                + small_eigh.LAUNCHES[used]
        print(f"[ranks] certificate at rank {r} (a random point): certified "
              f"{cert.is_certified} theta {cert.theta:.4e}, {cert.num_iters}"
              f" LOBPCG iterations, {took:.3f} s; Rayleigh–Ritz "
              + ", ".join(f"n = {m} → {v}" for m, v in routes.items())
              + f"; LOBPCG {lp['captures']} captures, {lp['replays']} "
              f"replays, {lp['eager_calls']} eager calls; small_eigh "
              f"launches {json.dumps(small_eigh.LAUNCHES)}", flush=True)
        check(not cert.is_certified and cert.num_iters > 0
              and np.isfinite(cert.theta), f"rank {r} certificate: {cert}")
        # no route but those two, and no comparator
        check(lp["replays"] > 0 and not lp["eager_calls"]
              and small_eigh.LAUNCHES[key] > 0
              and not any(v for k2, v in small_eigh.LAUNCHES.items()
                          if k2 not in routes.values()),
              f"rank {r} certificate's LOBPCG not replayed through "
              f"{sorted(set(routes.values()))} alone: {lp}, "
              f"{small_eigh.LAUNCHES}")
        if r != CERT_AGAINST_GLOBAL:
            continue
        # the same certificate with its 3k × 3k matrices on the global
        # kernel (a fresh capture: the kept loop replays the grid)
        ref, ref_took, ref_lp = certificate_run(problems[name], pd, cfg, Y,
                                                force_3k="global")
        gap = abs(cert.theta - ref.theta) / max(abs(ref.theta), 1e-30)
        print(f"[ranks] certificate at rank {r}, {3 * k} × {3 * k} on "
              f"small_eigh_global: certified {ref.is_certified} theta "
              f"{ref.theta:.4e} ({ref.num_iters} LOBPCG iterations, "
              f"{ref_took:.3f} s; launches {json.dumps(small_eigh.LAUNCHES)}"
              f"); against {key}: same verdict "
              f"{ref.is_certified == cert.is_certified}, theta rel {gap:.3e}"
              f" (bit-equal {ref.theta == cert.theta}), {took:.3f} s "
              f"against {ref_took:.3f} s", flush=True)
        check(ref.is_certified == cert.is_certified and gap <= CERT_THETA_TOL
              and small_eigh.LAUNCHES["small_eigh_global"] > 0
              and ref_lp["replays"] > 0 and not ref_lp["eager_calls"],
              f"rank {r}: {key}'s certificate ({cert.is_certified}, "
              f"{cert.theta}) against the global route's "
              f"({ref.is_certified}, {ref.theta}), {ref_lp}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "chain.pyfg")
        with open(path, "w") as fh:
            fh.write(multi_robot_pyfg(**CLI_GRAPH))
        out = {}
        for animate in (False, True):
            tnt_kernels.reset_launch_counts()
            t0 = time.time()
            out[animate] = visualize.solve(path, animate, "cuda",
                                           verbose=False)
            torch.cuda.synchronize()
            cfg, r = out[animate][1:]
            chain_launches = sum(tnt_kernels.LAUNCHES.values())
            iterates = len(r.result.iterates or [])
            print(f"[ranks] visualize {'--animate ' if animate else ''}"
                  f"({np.dtype(cfg.dtype).name}): ranks {r.ranks_visited} "
                  f"certified {r.certified} f {r.result.f:.6f}, "
                  f"{time.time() - t0:.3f} s; chain kernel launches "
                  f"{chain_launches}; logged iterates {iterates}", flush=True)
            check(r.certified and np.isfinite(r.result.f),
                  f"visualize: not certified, f {r.result.f}")
            # the CLI's float64 config: the canonical path either way
            check(not chain_launches and (iterates > 0) == animate,
                  f"visualize {'--animate' if animate else 'still'}: "
                  f"{chain_launches} kernel launches, {iterates} iterates")
        gap = abs(out[False][2].result.f - out[True][2].result.f) / abs(
            out[True][2].result.f)
        check(gap <= 1e-6, f"visualize: the still's and --animate's costs "
              f"{gap:.3e} apart")
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            print("[ranks] visualize: matplotlib does not import here: the "
                  "solve half ran, the drawing did not", flush=True)
        else:
            for animate, fname in ((False, "still.png"), (True, "anim.gif")):
                dst = os.path.join(tmp, fname)
                visualize.draw(*out[animate], path, dst, animate,
                               max_frames=10)
                check(os.path.getsize(dst) > 0, f"visualize: empty {dst}")
            print("[ranks] visualize: drew the still and the animation "
                  "(matplotlib imports here)", flush=True)
    return cert_launches


def phase_level_f64(problems, reference, device="cuda"):
    """The single_drone-shaped first level in float64: the canonical
    `tnt_solve` and the chain plain path (`PlainTNT` on a float64 plan)
    from the fixture's start, with the staircase's first-level arguments,
    against the JAX package's canonical float64 level (`level0_f64`).

    The level's end is chaotic in the rounding: the JAX package's own level
    from starts one ulp away (`perturbed`) parts from its trajectory and
    ends elsewhere, near-critical or at a ramp exit. So each port path is
    held to the JAX trajectory to TOL_F64 over the iterations that all of
    those runs keep within TOL_F64 of it, and its level end to the ends of
    those runs and of the JAX level itself: a status one of them reached,
    and, among the runs with that status, an iteration count within theirs
    and a final f within theirs widened by 1 %."""
    import numpy as np
    import torch

    from cora_tpu_torch.ops import chain
    from cora_tpu_torch.ops.riemannian import project_to_manifold
    from cora_tpu_torch.solve.tnt import tnt_solve
    from cora_tpu_torch.solve.tnt_kernel import (
        get_kernel_backend,
        tnt_solve_tiles,
    )

    ref = reference["level0_f64"]
    name = ref["graph"]
    problem = problems[name]
    cfg = bench_config(reference, reference["graphs"][name]["init_rank_jump"],
                       "never")
    X0 = torch.as_tensor(numpy_start(reference, problem, ref["rank"]))
    kw = dict(ramp_iterations=cfg.max_staircase_iterations,
              ramp_tcg=cfg.ramp_tcg_iterations,
              lift_grad_norm=cfg.lift_grad_norm,
              stall_window=cfg.ramp_stall_window,
              stall_tol=cfg.ramp_stall_tol)
    pd = problem.device_data(np.float64, device)
    precon = problem.preconditioner_fn(cfg.preconditioner, np.float64,
                                       cfg.reg_chol_max_cond, device)
    kern = get_kernel_backend(problem, cfg.tnt, cfg.reg_chol_max_cond,
                              np.float64, device, "never")
    runs = {
        "canonical": lambda: tnt_solve(
            pd, project_to_manifold(pd, X0.to(device)), precon, cfg.tnt,
            **kw),
        "chain plain": lambda: tnt_solve_tiles(
            kern, chain.project_manifold(kern.plan, X0.to(device)), cfg.tnt,
            **kw),
    }
    f_ref = np.asarray(ref["f"])
    ends = [ref] + ref["perturbed"]
    tols = list(ref["perturbed"][0]["parts"])
    hold = min(p["parts"][f"{TOL_F64:g}"] or ref["iterations"] + 1
               for p in ref["perturbed"]) - 1
    print(f"[level f64] {name} rank {ref['rank']} JAX (CPU): final f "
          f"{ref['final_f']:.10f} |grad| {ref['final_grad_norm']:.6e} "
          f"iterations {ref['iterations']} {ref['status']}; from starts one "
          f"ulp away: " + json.dumps(ref["perturbed"]), flush=True)
    for label, run in runs.items():
        torch.cuda.synchronize()
        t0 = time.time()
        res = run()
        torch.cuda.synchronize()
        wall = time.time() - t0
        n = min(len(f_ref), res.num_iterations)
        gap = np.abs(res.objective_values[:n] - f_ref[:n]) / np.abs(f_ref[:n])
        parts = {}
        for tol in tols:
            at = np.flatnonzero(gap > float(tol))
            parts[tol] = int(at[0]) + 1 if at.size else None
        print(f"[level f64] {label}: f rel gap <= {gap[:hold].max():.3e} over "
              f"iterations 1-{hold}; parts at {json.dumps(parts)}; final f "
              f"{res.f:.10f} |grad| {res.gradfx_norm:.6e} iterations "
              f"{res.num_iterations} {res.status}; wall {wall:.3f} s",
              flush=True)
        check(n >= hold and gap[:hold].max() <= TOL_F64,
              f"{label}: float64 level leaves the JAX trajectory within the "
              f"first {hold} iterations: {gap[:hold]}")
        like = [e for e in ends if e["status"] == res.status]
        check(like, f"{label}: level ends with status {res.status}, which "
              f"no JAX run reached")
        f_lo = min(e["final_f"] for e in like) / (1.0 + TOL_END_F)
        f_hi = max(e["final_f"] for e in like) * (1.0 + TOL_END_F)
        it_lo = min(e["iterations"] for e in like)
        it_hi = max(e["iterations"] for e in like)
        print(f"[level f64] {label}: level end {res.status} held to the "
              f"{len(like)} JAX run(s) that end so: f in [{f_lo:.4f}, "
              f"{f_hi:.4f}], iterations in [{it_lo}, {it_hi}]", flush=True)
        check(f_lo <= res.f <= f_hi and
              it_lo <= res.num_iterations <= it_hi,
              f"{label}: level end f {res.f} after {res.num_iterations} "
              f"iterations lies outside the JAX runs' ends")


def cert_loops_checked(name, calls, stats):
    """The solve's first failed certificate (one whose LOBPCG ran) and its
    first polish again: captured afresh with every warm-up, capture and
    first replay under `set_sync_debug_mode("error")`, then eagerly
    (`device_loop(graphs=False)`); both must end on the solve's bits. The
    eager certificate's Rayleigh–Ritz matrices are held to small_eigh's
    plain twin (`check_small_eigh`)."""
    import probe_cert_loop as cert_probe
    import torch

    from cora_tpu_torch.ops import lobpcg
    from cora_tpu_torch.utils.graphs import clear_graphs

    for kind in ("certify", "polish"):
        call = cert_probe.first_call(calls, kind)
        check(call is not None, f"{name}: no {kind} call with a device loop")
        clear_graphs()
        out, wall, st = cert_probe.rerun(call, sync_debug=True)
        same = cert_probe.same_result(out, call[4])
        print(f"[general] {name}: first {kind} loop captured afresh under "
              f"set_sync_debug_mode('error'): {st['captures']} captures in "
              f"{st['capture_s']:.3f} s, {st['replays']} replays, "
              f"{wall:.3f} s, no host synchronisation; on the solve's bits: "
              f"{same}", flush=True)
        check(st["captures"] > 0 and st["replays"] > 0 and same,
              f"{name}: the sync-checked {kind} made {st}, same {same}")
        clear_graphs()
        rr, real = [], lobpcg.small_eigh

        def recording(A):
            rr.append(A.clone())
            return real(A)

        lobpcg.small_eigh = recording
        try:
            out, wall_e, st = cert_probe.rerun(call, graphs=False)
        finally:
            lobpcg.small_eigh = real
        same = cert_probe.same_result(out, call[4])
        print(f"[general] {name}: first {kind} eager "
              f"(device_loop(graphs=False)) {wall_e:.3f} s against "
              f"{wall:.3f} s captured, {st['eager_calls']} eager step calls; "
              f"on the solve's bits: {same}", flush=True)
        check(not st["captures"] and st["eager_calls"] and same,
              f"{name}: the eager {kind} made {st}, same {same}")
        for n in sorted({A.shape[-1] for A in rr}):  # k × k and 3k × 3k
            check_small_eigh(torch.stack([A for A in rr
                                          if A.shape[-1] == n]), stats,
                             f"{name} certificate's Rayleigh–Ritz")


def phase_general(reference, device="cuda", stats=None):
    """`parse_pyfg` → `solve_cora` on the multi-robot graphs from the
    odometry start, with the launch counts zeroed before the first solve
    and read after the last. Returns {name: (problem, result)}."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from torch_port_reference import multi_robot_pyfg

    from cora_tpu_torch.io.pyfg import parse_pyfg
    from cora_tpu_torch.ops import tnt_kernels
    from cora_tpu_torch.types import Initialization

    solved = {}
    for name, ref in reference["general"].items():
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, name + ".pyfg")
            with open(path, "w") as fh:
                fh.write(multi_robot_pyfg(**ref["pyfg"]))
            problem = parse_pyfg(path)
        cfg = bench_config(reference, ref["init_rank_jump"], "auto",
                           initialization=Initialization.ODOMETRY)
        tnt_kernels.reset_launch_counts()
        res, wall, ate, levels = solve_once(problem, cfg, None, device)
        launches = dict(tnt_kernels.LAUNCHES)
        first_call = LEVEL_CALLS[0]
        st = loop_line("general", name, res, levels)
        check(st["captures"] >= 3 and not st["eager_calls"],
              f"{name}: the device loop did not run captured: {st}")
        captured_loops(name)
        calls, lp, cg = LAST["calls"], LAST["lobpcg"], LAST["cg"]
        fac = problem.preconditioner_fn(cfg.preconditioner, cfg.dtype,
                                        cfg.reg_chol_max_cond, device).fac
        print(f"[general] {name}: N {problem.data_matrix_size}, permuted "
              f"bandwidth {fac['bandwidth']} (JAX package's RCM band "
              f"{ref['bandwidth']}; exact up to 96); CUDA kernel launches "
              f"{json.dumps(launches)}", flush=True)
        check(not any(launches.values()),
              f"{name}: the canonical path launched kernels {launches}")
        check_first_level(name, levels[0], ref)
        gate(name, problem, res, ate, ref, max_levels=general_levels(ref))
        solved[name] = (problem, res)
        t_cert = (res.elapsed_to_certificate
                  if np.isfinite(res.elapsed_to_certificate) else wall)
        print(f"[general] {name}: ranks {res.ranks_visited} certified "
              f"{res.certified} sdp_cost {res.sdp_cost:.6f} f "
              f"{res.result.f:.6f} (reference {ref['f']:.6f}, rel "
              f"{(res.result.f - ref['f']) / ref['f']:+.2e}) grad_norm_f64 "
              f"{res.grad_norm_f64:.3e} final_certified "
              f"{res.final_certified} ATE {ate:.4f} m t_cert {t_cert:.3f} s "
              f"wall {wall:.3f} s phases "
              + json.dumps({k: round(v, 4) for k, v in res.phases.items()}),
              flush=True)
        print(f"[general] {name} reference (JAX, CPU): " + json.dumps(
            {k: ref[k] for k in ("certified", "sdp_cost", "f", "ate", "ranks",
                                 "cpu_wall_s", "spread") if k in ref}),
              flush=True)
        if name == "tiers_shaped":
            # the first level cut to its ramp (iterations below
            # `ramp_iterations`): the whole level's 3.4 million kernels
            # took the profiler 275 s to parse on the H100 host
            (pd, X, precon, params), kwargs = first_call
            device_busy("general", name + " first level's ramp", (
                (pd, X, precon, dataclasses.replace(params,
                                                    max_iterations=0)),
                kwargs))
            check(lp["host_reads"] <= 0.5 * lp["iterations"]
                  and cg["host_reads"] <= 0.5 * cg["cg_iters"],
                  f"{name}: more than 0.5 host reads per LOBPCG or CG "
                  f"iteration: {lp}, {cg}")
            cert_loops_checked(name, calls, stats)
        if name == "mrclam5a_shaped":
            sync_checked_level("general", name, first_call)
            # the same solve with every step function run eagerly
            cfg.use_kernels = "never"
            eager, wall_e, _, levels_e = solve_once(problem, cfg, None,
                                                    device)
            st = loop_line("general", name + " eager", eager, levels_e)
            same = bool(torch.equal(eager.result.x, res.result.x)
                        and eager.result.f == res.result.f
                        and eager.ranks_visited == res.ranks_visited)
            print(f"[general] {name}: eager solve (use_kernels='never') "
                  f"{wall_e:.3f} s wall against captured {wall:.3f} s; on "
                  f"the captured solve's bits: {same}", flush=True)
            check(not st["captures"] and st["eager_calls"],
                  f"{name}: the eager solve captured: {st}")
            check(same, f"{name}: the captured and eager solves differ")
    return solved


def general_levels(ref):
    """The level gate of a general run: the most levels the JAX package
    visits over its `spread` (or its one run), plus 2."""
    spread = ref.get("spread")
    return 2 + (max(len(r) for r in spread["ranks"]) if spread
                else len(ref["ranks"]))


def read_tum(path):
    """(n, 8) rows `ts x y z qx qy qz qw` of a TUM trajectory file."""
    import numpy as np

    with open(path) as fh:
        return np.array([[float(v) for v in line.split()] for line in fh])


def check_tum_export(name, problem, soln, tmp):
    """`save_solution` in TUM format, read back: each pose's position and
    rotation (from its quaternion) against `extract_solution`'s, to 1e-9."""
    import numpy as np

    from cora_tpu_torch.io.exporters import save_solution
    from cora_tpu_torch.io.pyfg import rot_from_quat

    d = problem.dim
    path = os.path.join(tmp, name + ".tum")
    save_solution(problem, soln, path, fmt="tum")
    chars = problem.robot_chars()
    worst = 0.0
    for c in chars:
        rows = read_tum(path if len(chars) == 1 else f"{path}.{c}")
        syms = problem.pose_symbols(c)
        check(len(rows) == len(syms), f"{name}: TUM file has {len(rows)} "
              f"poses, expected {len(syms)}")
        for row, sym in zip(rows, syms):
            i = problem.rotation_idx(sym)
            t = soln[problem.translation_idx(sym), :d]
            R = soln[i * d:(i + 1) * d, :d].T
            R3 = rot_from_quat(*row[4:8])
            worst = max(worst, float(np.abs(row[1:1 + d] - t).max()),
                        float(np.abs(R3[:d, :d] - R).max()))
    print(f"[implicit] {name}: TUM export of {problem.num_poses} poses read "
          f"back, max abs diff {worst:.3e} against extract_solution",
          flush=True)
    check(worst <= 1e-9, f"{name}: TUM export differs by {worst:.3e}")


def phase_implicit(reference, device="cuda"):
    """The implicit formulation in float64 and its host surroundings: the
    native tokenizer, the operator against the host Schur complement, the
    plaza2-shaped and `mrclam5a_shaped` implicit solves against the JAX
    package's (fixture `implicit`), checkpoint and resume, the iterate
    log. Launch counts are zeroed at the start and must stay 0."""
    import tempfile

    import numpy as np
    import scipy.sparse.linalg as spla
    import torch

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from torch_port_reference import multi_robot_pyfg

    from cora_tpu_torch.io.pyfg import parse_pyfg_python
    from cora_tpu_torch.models.synthetic import synthetic_problem
    from cora_tpu_torch.native import build_extension
    from cora_tpu_torch.native.pyfg_fast import parse_pyfg_native
    from cora_tpu_torch.ops import tnt_kernels
    from cora_tpu_torch.solve.checkpoint import StaircaseCheckpoint
    from cora_tpu_torch.solve.staircase import extract_solution
    from cora_tpu_torch.types import Formulation, Initialization

    tnt_kernels.reset_launch_counts()
    refs = reference["implicit"]
    with tempfile.TemporaryDirectory(prefix="cora_smoke_") as tmp:
        # 1. the native tokenizer against the Python parser
        t0 = time.time()
        build_extension("_pyfg")
        print(f"[implicit] native tokenizer built in {time.time() - t0:.2f} s",
              flush=True)
        files = {}
        for name, ref in reference["general"].items():
            files[name] = os.path.join(tmp, name + ".pyfg")
            with open(files[name], "w") as fh:
                fh.write(multi_robot_pyfg(**ref["pyfg"]))
            t0 = time.time()
            native = parse_pyfg_native(files[name])
            t1 = time.time()
            python = parse_pyfg_python(files[name])
            t2 = time.time()
            A, B = native.data_matrix(), python.data_matrix()
            same = A.shape == B.shape and (A != B).nnz == 0
            print(f"[implicit] {name}: parse native {t1 - t0:.3f} s, Python "
                  f"{t2 - t1:.3f} s; data matrices identical: {same}",
                  flush=True)
            check(same, f"{name}: native and Python parses differ")

        # 2. the operator against the host sparse Schur complement
        name = "plaza2_shaped_implicit"
        ref = refs[name]
        problem = synthetic_problem(**ref["graph"])
        h, n_tr = problem.rot_and_range_matrix_size, \
            problem.num_translational_states
        op = problem.operator(Formulation.IMPLICIT, np.float64, device)
        ls = op.implicit.lred_solve
        Y = np.random.default_rng(0).standard_normal((h, 4))
        Yd = torch.as_tensor(Y).to(device)
        got = op(Yd).cpu().numpy()
        Q = problem.data_matrix().tocsc()
        Qm, Bm = Q[:h, :h], Q[:h, h:h + n_tr - 1]
        lu = spla.splu(Q[h:h + n_tr - 1, h:h + n_tr - 1].tocsc())
        want = Qm @ Y - Bm @ lu.solve(np.asarray(Bm.T @ Y))
        err = float(np.abs(got - want).max() / np.abs(want).max())
        X = op.implicit.translation_explicit_solution(Yd).cpu().numpy()
        QX = Q @ X
        resid = float(np.abs(QX[h:]).max() / np.abs(QX).max())
        op_ms = median_ms(lambda: op(Yd), torch)
        print(f"[implicit] {name}: state height {h}; L band {ls.bandwidth}, "
              f"q = {ls.q}, {ls.n_blocks} blocks, {ls.spikes} spikes, "
              f"{ls.fac['levels']} scan levels, propagators "
              f"{ls.propagator_bytes} B; op(Y) rel err {err:.3e} against "
              f"splu; translation rows of Q·[Y; t] {resid:.3e} of its max; "
              f"pinned row {np.abs(X[-1]).max()}; op(Y) {op_ms:.3f} ms "
              f"(r = 4)", flush=True)
        check(err <= 1e-10, f"{name}: implicit op rel err {err:.3e}")
        check(resid <= 1e-9, f"{name}: recovered translations leave "
              f"{resid:.3e}")
        check(not X[-1].any(), f"{name}: pinned translation {X[-1]}")

        # 3. the plaza2-shaped implicit solve from the fixture's start
        jump = ref["init_rank_jump"]
        cfg = bench_config(reference, jump, "auto", dtype=np.float64,
                           formulation=Formulation.IMPLICIT)
        x0 = numpy_start(reference, problem, problem.dim + jump)[:h]
        res, wall, ate, levels = solve_once(problem, cfg, x0, device)
        loop_line("implicit", name, res, levels)
        captured_loops(name)
        soln = extract_solution(problem, cfg, res)
        check_first_level(name, levels[0], ref, 1e-6, 1e-6)
        gate(name, problem, res, ate, ref, Y=soln)
        report(name, res, wall, ate, ref, levels)
        check_tum_export(name, problem, soln, tmp)

        # 4. mrclam5a_shaped implicit from the odometry start, twice: the
        # first writes a checkpoint (its first level fails its certificate),
        # the second logs its iterates; then a third call resumes
        name = "mrclam5a_shaped_implicit"
        ref = refs[name]
        problem = parse_pyfg_native(files["mrclam5a_shaped"])
        cfg = bench_config(reference, ref["init_rank_jump"], "auto",
                           dtype=np.float64, formulation=Formulation.IMPLICIT,
                           initialization=Initialization.ODOMETRY)
        path = os.path.join(tmp, "ckpt", name + ".npz")
        os.makedirs(os.path.dirname(path))
        first, _, _, first_levels = solve_once(problem, cfg, None, device,
                                               checkpoint_path=path)
        loop_line("implicit", name + " (checkpointed)", first, first_levels)
        captured_loops(name)
        first_call = LEVEL_CALLS[0]
        # its first level again, eagerly, then captured afresh under the
        # sync check: both on the captured level's bits
        eager, wall_e, st = rerun_level(first_call, graphs=False)
        same = same_level(eager, first_levels[0])
        print(f"[implicit] {name}: first level eager {wall_e:.3f} s "
              f"({st['eager_calls']} eager step calls); on the captured "
              f"level's bits: {same}", flush=True)
        check(not st["captures"] and same,
              f"{name}: the eager first level differs from the captured one")
        check(same_level(sync_checked_level("implicit", name, first_call),
                         first_levels[0]),
              f"{name}: the sync-checked first level differs")
        left = os.listdir(os.path.dirname(path))
        check(left == [os.path.basename(path)],
              f"{name}: checkpoint directory holds {left}")
        ckpt = StaircaseCheckpoint.load(path)
        cfg.log_iterates = True
        res, wall, ate, levels = solve_once(problem, cfg, None, device)
        loop_line("implicit", name + " (log_iterates)", res, levels)
        same = bool(torch.equal(first.result.x, res.result.x))
        its = res.result.iterates
        n_its = sum(lv.num_iterations for lv in levels)
        print(f"[implicit] {name}: two solves end on the same state: {same}; "
              f"iterate log {len(its)} states over {n_its} TNT iterations, "
              f"the last {its[-1].shape}", flush=True)
        check(same, f"{name}: two solves from one start differ")
        check(len(its) >= res.result.num_iterations and len(its) == n_its
              and its[-1].shape == tuple(res.result.x.shape),
              f"{name}: iterate log {len(its)} against {n_its} iterations")
        soln = extract_solution(problem, cfg, res)
        check_first_level(name, levels[0], ref, 1e-6, 1e-6)
        gate(name, problem, res, ate, ref, Y=soln)
        report(name, res, wall, ate, ref, levels)

        # 5. resume from the first solve's checkpoint
        cfg.log_iterates = False
        resumed, wall_r, _, resumed_levels = solve_once(
            problem, cfg, None, device, checkpoint_path=path)
        loop_line("implicit", name + " (resumed)", resumed, resumed_levels)
        k = len(ckpt.ranks_visited)
        print(f"[implicit] {name}: checkpoint at rank {ckpt.rank} after "
              f"{ckpt.ranks_visited} (Y {ckpt.Y.shape}); resumed: ranks "
              f"{resumed.ranks_visited} certified {resumed.certified} f "
              f"{resumed.result.f:.6f} (uninterrupted {first.result.f:.6f}) "
              f"wall {wall_r:.3f} s", flush=True)
        check(ckpt.Y.shape[0] == problem.rot_and_range_matrix_size,
              f"{name}: checkpoint state {ckpt.Y.shape}")
        check(resumed.ranks_visited[:k + 1] == ckpt.ranks_visited
              + [ckpt.rank], f"{name}: resumed ranks {resumed.ranks_visited}")
        check(resumed.certified, f"{name}: the resumed solve did not certify")
        check(abs(resumed.result.f - first.result.f)
              <= 0.01 * abs(first.result.f),
              f"{name}: resumed f {resumed.result.f} against "
              f"{first.result.f}")
    launches = dict(tnt_kernels.LAUNCHES)
    print(f"[implicit] CUDA kernel launches in this phase: "
          f"{json.dumps(launches)}", flush=True)
    check(not any(launches.values()),
          f"the implicit phase launched kernels {launches}")
    return first.result.f


def report(name, res, wall, ate, ref, levels):
    """One solve's lines: ranks, certificate, f against the fixture, ATE,
    t_cert, wall, phases; tCG iterations and the TNT phases' wall per tCG
    iteration."""
    import numpy as np

    t_cert = (res.elapsed_to_certificate
              if np.isfinite(res.elapsed_to_certificate) else wall)
    print(f"[implicit] {name}: ranks {res.ranks_visited} certified "
          f"{res.certified} sdp_cost {res.sdp_cost:.6f} f "
          f"{res.result.f:.6f} (reference {ref['f']:.6f}, rel "
          f"{(res.result.f - ref['f']) / ref['f']:+.2e}) grad_norm_f64 "
          f"{res.grad_norm_f64:.3e} ATE {ate:.4f} m (reference "
          f"{ref['ate']:.4f}) t_cert {t_cert:.3f} s wall {wall:.3f} s "
          f"(JAX CPU {ref['cpu_wall_s']} s) phases "
          + json.dumps({k: round(v, 4) for k, v in res.phases.items()}),
          flush=True)
    tcg_iters = int(sum(lv.inner_iterations.sum() for lv in levels))
    tnt_s = res.phases.get("tnt_level", 0.0) + res.phases.get("tnt_refine",
                                                              0.0)
    print(f"[implicit] {name}: {tcg_iters} tCG iterations over "
          f"{len(levels)} TNT levels; tnt_level + tnt_refine {tnt_s:.3f} s, "
          f"{1e6 * tnt_s / max(tcg_iters, 1):.2f} us per tCG iteration",
          flush=True)


def mesh_loop(name, res, levels):
    """A sharded solve runs the device loop eagerly (its collectives stay
    outside any graph): no capture."""
    st = loop_line("parallel", name + " (mesh)", res, levels)
    check(not st["captures"] and st["eager_calls"],
          f"{name}: the mesh solve's device loop captured: {st}")


def phase_parallel(problems, solved, implicit_f, reference, device="cuda"):
    """`cora_tpu_torch.parallel` on one card: a one-process NCCL group
    (`init_distributed` starts nothing, `make_global_mesh` makes the group
    of this process) and the block-row plan with K shards emulated in this
    process. The sharded products against the unsharded one; then
    `mrclam5a_shaped` through `solve_cora(..., mesh=)`, explicit float32 and
    implicit float64. Launch counts are zeroed at the start and must stay
    0: the sharded path runs the canonical ops."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from cora_tpu_torch.models.synthetic import synthetic_problem
    from cora_tpu_torch.ops import tnt_kernels
    from cora_tpu_torch.ops.quadratic import data_matrix_product
    from cora_tpu_torch.parallel import sharding as shd
    from cora_tpu_torch.parallel.distributed import (
        init_distributed,
        make_global_mesh,
        process_info,
    )
    from cora_tpu_torch.solve.staircase import extract_solution
    from cora_tpu_torch.types import Formulation, Initialization

    tnt_kernels.reset_launch_counts()
    check(init_distributed() is False, "one process: init_distributed "
          "started a group")
    mesh = make_global_mesh(device)
    check(mesh.size() == 1 and process_info() == (0, 1),
          f"mesh {mesh}, process_info {process_info()}")
    print(f"[parallel] {mesh}, backend {dist.get_backend()}, sharded "
          f"products at r = {PAR_RANK}; times on {' '.join(PAR_TIMED)}, "
          f"median of {REPS} (CUDA events)",
          flush=True)
    graphs = {"plaza2_shaped": problems["plaza2_shaped"],
              "tiers_shaped": solved["tiers_shaped"][0],
              "hv100k": synthetic_problem(**HV100K)}
    for name, problem in graphs.items():
        pd64 = problem.device_data(np.float64, device)
        plans = {K: shd.build_rowblock_plan(pd64, K) for K in PAR_KS}
        for dtype_name in PAR_DTYPES.get(name, ("float32", "float64")):
            dtype, tol = np.dtype(dtype_name).type, PAR_TOL[dtype_name]
            timed_case = (name, dtype_name) == PAR_TIMED
            pd = problem.device_data(dtype, device)
            Y = torch.as_tensor(np.random.default_rng(0).standard_normal(
                (pd.size, PAR_RANK))).to(device, pd.dtype())
            want = data_matrix_product(pd, Y)
            times = {"unsharded": median_ms(
                lambda: data_matrix_product(pd, Y), torch)} \
                if timed_case else {}
            errs, local = {}, {}
            for blockrow, kind in ((True, "block-row"), (False, "edge")):
                op = problem.sharded_operator(mesh, dtype, blockrow=blockrow,
                                              device=device)
                errs[f"{kind} world 1"] = rel(op(Y), want)
                if timed_case:
                    times[f"{kind} world 1"] = median_ms(lambda: op(Y), torch)
            for K, plan in plans.items():
                br = shd.BlockRowOperator(pd, plan)
                errs[f"K={K}"] = rel(br.emulated(Y), want)
                if timed_case:
                    G = torch.stack([br.local(k, Y) for k in range(K)])
                    local[K] = [median_ms(lambda: br.local(k, Y), torch)
                                for k in range(K)]
                    times[f"assemble K={K}"] = median_ms(
                        lambda: br.assemble(G), torch)
            seps = {K: (p.n_sep_rot, p.n_sep_tr) for K, p in plans.items()}
            print(f"[parallel] {name} {np.dtype(dtype).name}: N {pd.size}; "
                  "max rel err against the unsharded product: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                  + (" | ms: " + ", ".join(f"{k} {v:.3f}"
                                           for k, v in times.items())
                     + " | local ms per shard (max, min): " + ", ".join(
                         f"K={K} {max(v):.3f}, {min(v):.3f}"
                         for K, v in local.items()) if timed_case else "")
                  + " | separators (rotation, translation): "
                  + json.dumps(seps), flush=True)
            for k, e in errs.items():
                check(e <= tol, f"{name} {np.dtype(dtype).name} {k}: rel "
                      f"err {e:.3e} > {tol}")

    name = "mrclam5a_shaped"
    problem, unsharded = solved[name]
    ref = reference["general"][name]
    cfg = bench_config(reference, ref["init_rank_jump"], "auto",
                       initialization=Initialization.ODOMETRY)
    res, wall, ate, levels = solve_once(problem, cfg, None, device,
                                        mesh=mesh)
    mesh_loop(name + " explicit", res, levels)
    same = bool(torch.equal(res.result.x, unsharded.result.x))
    check_first_level(name + " (mesh)", levels[0], ref)
    gate(name + " (mesh)", problem, res, ate, ref,
         max_levels=general_levels(ref))
    print(f"[parallel] {name} explicit float32 on the mesh: ranks "
          f"{res.ranks_visited} certified {res.certified} f "
          f"{res.result.f:.6f} (unsharded, phase 5: "
          f"{unsharded.result.f:.6f}; reference {ref['f']:.6f}) ATE "
          f"{ate:.4f} m wall {wall:.3f} s; on phase 5's bits: {same}",
          flush=True)
    # one process: the sharded solve is the unsharded arithmetic, and this
    # is the check that two solves from one start end on the same bits
    check(same, f"{name}: the mesh solve left phase 5's bits")

    ref = reference["implicit"][name + "_implicit"]
    cfg = bench_config(reference, ref["init_rank_jump"], "auto",
                       dtype=np.float64, formulation=Formulation.IMPLICIT,
                       initialization=Initialization.ODOMETRY)
    res, wall, ate, levels = solve_once(problem, cfg, None, device,
                                        mesh=mesh)
    mesh_loop(name + " implicit", res, levels)
    soln = extract_solution(problem, cfg, res)
    check_first_level(name + " implicit (mesh)", levels[0], ref, 1e-6, 1e-6)
    gate(name + " implicit (mesh)", problem, res, ate, ref, Y=soln)
    gap = abs(res.result.f - implicit_f) / abs(implicit_f)
    print(f"[parallel] {name} implicit float64 on the mesh: ranks "
          f"{res.ranks_visited} certified {res.certified} f "
          f"{res.result.f:.9f} (unsharded, phase 6: {implicit_f:.9f}, rel "
          f"{gap:.3e}; reference {ref['f']:.6f}) ATE {ate:.4f} m wall "
          f"{wall:.3f} s", flush=True)
    check(gap <= 1e-6, f"{name} implicit on the mesh: f {res.result.f} "
          f"against the unsharded {implicit_f}")
    dist.destroy_process_group()
    launches = dict(tnt_kernels.LAUNCHES)
    print(f"[parallel] CUDA kernel launches in this phase: "
          f"{json.dumps(launches)}", flush=True)
    check(not any(launches.values()),
          f"the parallel phase launched kernels {launches}")


def main():
    t_start = time.time()
    probe = phase_device()
    import torch

    from cora_tpu_torch.models.synthetic import synthetic_problem
    from cora_tpu_torch.solve.tnt import HashableParams
    from cora_tpu_torch.types import TNTParams

    with open(REFERENCE) as fh:
        reference = json.load(fh)
    problems = {name: synthetic_problem(**rec["graph"])
                for name, rec in reference["graphs"].items()}
    took = {"device": time.time() - t_start}

    def timed(name, phase, *args):
        t0 = time.time()
        out = phase(*args)
        took[name] = time.time() - t0
        return out

    stats = timed("kernels", phase_kernels, problems,
                  HashableParams(TNTParams()), probe)
    launches = timed("slice", phase_slice, problems, reference)
    for name in PATH_KERNELS:
        check(launches[name] > 0,
              f"{name} kernel not launched on the main path: {launches}")
    check(not any(launches[k] for k in COMPARATORS),
          f"the main path launched a single-CTA comparator: {launches}")
    # the certificate path past the main path's ranks: its own launches
    launches.update(timed("ranks", phase_ranks, problems, reference))
    timed("level_f64", phase_level_f64, problems, reference)
    solved = timed("general", phase_general, reference, "cuda", stats)
    implicit_f = timed("implicit", phase_implicit, reference)
    timed("parallel", phase_parallel, problems, solved, implicit_f, reference)
    total = time.time() - t_start
    print("[smoke] seconds per phase: " + json.dumps(
        {k: round(v, 1) for k, v in took.items()})
        + f"; {total:.1f} s in all, {LIMIT_S - total:.1f} s inside the "
        f"{LIMIT_S} s limit", flush=True)

    kernels = []
    for k, v in stats.items():
        entry = dict(name=k, route="cuda",
                     source=EIGH_SOURCE if k in EIGH_KEYS else SOURCE,
                     replaces=REPLACES[k],
                     launches=launches[k], max_abs_err=v["max_abs_err"],
                     max_rel_err=v["max_rel_err"], ms=v["ms"],
                     plain_ms=v["plain_ms"], bound_ms=v["bound_ms"],
                     bound_by=v["bound_by"], bound_term=v["bound_term"],
                     library_ms=v["library_ms"], group=v["group"],
                     block_ms=v.get("block_ms"))
        for x in ("us_per_tcg_iter", "block_us_per_tcg_iter", "sweep_ms",
                  "scratch_mb", "turns_ms", "n", "by_rank", "by_n",
                  "ctas", "sweeps", "comparator"):
            if x in v:
                entry[x] = v[x]
        kernels.append(entry)
    # `tcg` is checked and timed in phase 2, but the main path runs its loop
    # inside `chunk`, not as a launch of its own; small_eigh's one-CTA
    # kernel is the comparator that no size routes to, and its global
    # kernel the comparator past n = 96 and the route past 1056, which no
    # path here reaches: the JSON line lists the kernels the paths launch
    listed = PATH_KERNELS + tuple(dict(CERT_RANKS))
    print("[kernels] tcg, small_eigh_cta, small_eigh_global (not launched on "
          "the paths; the global kernel the comparator of every route past "
          "n = 96): "
          + json.dumps(
              [k for k in kernels if k["name"] not in listed]), flush=True)
    print(json.dumps({"kernels": [k for k in kernels
                                  if k["name"] in listed]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
