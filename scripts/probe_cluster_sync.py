#!/usr/bin/env python3
"""Measure the barriers and the L2 read rate that decide the cluster size
of the `chunk` and `tcg` kernels, on one NVIDIA GPU.

    python3 scripts/probe_cluster_sync.py [--quick] [--out FILE]

Builds `scripts/probe_cluster_sync.cu` with nvcc into `.torch_ext_build/`
and measures, with CUDA events around launches of a barrier loop (the time
of `iters` barriers less that of none, over `iters`; median of 5):
  (a) `__syncthreads()` in one CTA of 1024 threads;
  (b) `cluster.sync()` in one cluster of C = 2, 4, 8 and 16 CTAs of 1024
      threads, with the number of such clusters the card holds at once;
  (c) `grid.sync()` in a cooperative launch of one 1024-thread CTA per SM;
      and, at G = 9, 17, 22, 64, 113, 129 and 132 CTAs (those the card
      has), a grid barrier in a cooperative `cudaLaunchKernelEx` of G CTAs
      one per SM: `grid.sync()` and a monotonic counter (a release add, an
      acquire spin), the two `small_eigh_grid` could take (it takes the
      counter, the faster on the H100: PERF.md); each launched also
      inside a CUDA graph capture (torch.cuda.graph, as the LOBPCG loop
      captures) and replayed, each CTA checking its neighbour's store
      across every barrier: whether a cooperative launch captures, and
      whether the barrier orders memory;
  (b') `cluster.sync()` at 16 CTAs each holding `small_eigh`'s cluster
      shared memory (231 424 bytes: one CTA per SM), and how many fit;
  (d) the L2 read rate of 1, 8, 16 and all SMs (one CTA each) streaming
      the plaza2-shaped graph's propagators' size (3 240 864 B) from L2;
  (e) a model of `small_eigh`'s stream route's round at n = 1062 and 2112
      (107 and 132 CTAs of 5 and 8 slots, 512 threads): each CTA reads the
      rows of its slots of the round (by index, L2) and writes them back,
      then the counter barrier; per round, with A alone and with V by
      index beside it (twice the rows): what updating V in the rounds
      instead of from the rotation log would add (median of 3 launches of
      2000 rounds).
Prints one line per measurement and, last, one JSON object of them all
with the card's name and power limit. `--quick` runs 10× fewer barriers
and reads (what `chip_smoke.py` uses); `--out` also writes the JSON there.
"""

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "scripts", "probe_cluster_sync.cu")
CLUSTERS = (2, 4, 8, 16)
# grid barriers at CTA counts small_eigh_grid takes (n = 449-1056: 113 at
# 449, 129 at 516, 132 at 1056, the card's SM count) and fewer
GRID_BLOCKS = (9, 17, 22, 64, 113, 129, 132)
GRID_KINDS = ("grid_sync", "counter")
# small_eigh.cu CLUSTER_SMEM: the cluster family's dynamic shared memory
EIGH_SMEM = 232448 - 1024
# the plaza2-shaped graph's propagators: 11 levels × 2046 blocks × 6 × 6
L2_BYTES = 11 * 2046 * 36 * 4
# the stream route's round modelled: n, its CTAs, slots a CTA
STREAM_ROUNDS = ((1062, 107, 5), (2112, 132, 8))


def build():
    """nvcc the probe into a shared library (cached by source hash); the
    library, loaded, with its argument types set."""
    sys.path.insert(0, REPO)
    from cora_tpu_torch.ops.tnt_kernels import BUILD_DIR, NVCC_FLAGS, _nvcc

    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"probe_cluster_sync_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.probe_block_sync.argtypes = [ci, vp, vp]
    lib.probe_cluster_sync.argtypes = [ci, ci, vp, vp, vp]
    lib.probe_grid_sync.argtypes = [ci, ci, vp, vp]
    lib.probe_l2_read.argtypes = [ci, vp, ci, ci, vp, vp]
    lib.probe_grid_barrier.argtypes = [ci, ci, ci, ci, vp, vp, vp, vp]
    lib.probe_cluster_sync_smem.argtypes = [ci, ci, ci, vp, vp, vp]
    lib.probe_rows_round.argtypes = [ci, ci, ci, ci, ci, vp, vp, vp, vp]
    for fn in (lib.probe_block_sync, lib.probe_cluster_sync,
               lib.probe_grid_sync, lib.probe_l2_read,
               lib.probe_grid_barrier, lib.probe_cluster_sync_smem,
               lib.probe_rows_round):
        fn.restype = ci
    return lib


def _ms(torch, launch, reps=5):
    """Median device time of one launch (CUDA events), after a warm-up."""
    times = []
    for _ in range(reps + 1):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        err = launch()
        t1.record()
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"probe launch failed: CUDA error {err}")
        times.append(t0.elapsed_time(t1))
    return statistics.median(times[1:])


def captured(torch, launch, bad):
    """A launch captured into a CUDA graph as the LOBPCG loop captures
    (warm-up on a side stream, then torch.cuda.graph) and replayed three
    times: "ok" when every launch returned 0 and `bad` (the misses the
    kernel counted) stays 0, else what failed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        err = launch(side.cuda_stream)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    if err:
        return f"eager launch: CUDA error {err}"
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            err = launch(torch.cuda.current_stream().cuda_stream)
    except RuntimeError as e:
        return f"capture refused: {e}"
    if err:
        return f"captured launch: CUDA error {err}"
    for _ in range(3):
        bad.zero_()
        graph.replay()
        torch.cuda.synchronize()
        if int(bad.sum()):
            return f"replay: {int(bad.sum())} stores missed across a barrier"
    return "ok"


def measure(lib, quick=False):
    """The four measurements, as a dict of plain numbers."""
    import torch

    iters = 2000 if quick else 20000
    reps = 20 if quick else 200
    stream = torch.cuda.current_stream().cuda_stream
    sink = torch.zeros(1, device="cuda")
    sp = sink.data_ptr()

    def per_barrier_us(launch):
        return 1e3 * (_ms(torch, lambda: launch(iters)) -
                      _ms(torch, lambda: launch(0))) / iters

    out = {"syncthreads_us": per_barrier_us(
        lambda it: lib.probe_block_sync(it, sp, stream))}
    out["cluster_sync_us"], out["max_active_clusters"] = {}, {}
    for C in CLUSTERS:
        mc = ctypes.c_int(0)
        out["cluster_sync_us"][str(C)] = per_barrier_us(
            lambda it, C=C: lib.probe_cluster_sync(C, it, sp, ctypes.byref(mc),
                                                   stream))
        out["max_active_clusters"][str(C)] = mc.value
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out["grid_blocks"] = sms
    out["grid_sync_us"] = per_barrier_us(
        lambda it: lib.probe_grid_sync(sms, it, sp, stream))
    mc = ctypes.c_int(0)
    out["cluster_sync_smem_us"] = {"16": per_barrier_us(
        lambda it: lib.probe_cluster_sync_smem(16, EIGH_SMEM, it, sp,
                                               ctypes.byref(mc), stream))}
    out["cluster_smem_fit"] = {"16": mc.value}
    count = torch.zeros(1, dtype=torch.int32, device="cuda")
    blocks = [g for g in GRID_BLOCKS if g <= sms]
    slot = torch.zeros(2 * max(blocks), dtype=torch.int32, device="cuda")
    bad = torch.zeros(max(blocks), dtype=torch.int32, device="cuda")

    def barrier(kind, G, it, check=0, st=None):
        return lib.probe_grid_barrier(
            kind, G, it, check, count.data_ptr(), slot.data_ptr(),
            bad.data_ptr(), st or torch.cuda.current_stream().cuda_stream)

    out["grid_barrier_us"] = {k: {} for k in GRID_KINDS}
    out["grid_barrier_captured"] = {k: {} for k in GRID_KINDS}
    for kind, name in enumerate(GRID_KINDS):
        for G in blocks:
            out["grid_barrier_us"][name][str(G)] = per_barrier_us(
                lambda it, G=G, kind=kind: barrier(kind, G, it))
            out["grid_barrier_captured"][name][str(G)] = captured(
                torch, lambda st, G=G, kind=kind: barrier(kind, G, 100, 1, st),
                bad[:G])
    buf = torch.ones(L2_BYTES // 4, device="cuda")
    n4 = buf.numel() // 4
    out["l2_bytes"] = L2_BYTES
    out["l2_read_GBps"] = {}
    for blocks in (1, 8, 16, sms):
        ms = _ms(torch, lambda b=blocks: lib.probe_l2_read(
            b, buf.data_ptr(), n4, reps, sp, stream))
        out["l2_read_GBps"][str(blocks)] = reps * L2_BYTES / (ms * 1e6)
    rounds = 200 if quick else 2000
    out["stream_round_us"] = {}
    for n, G, S in STREAM_ROUNDS:
        if G > sms:
            continue
        np_ = n + n % 2
        A = torch.randn(np_ * np_, dtype=torch.float64, device="cuda")
        V = torch.randn_like(A)
        row = out["stream_round_us"][str(n)] = {}
        for both, name in ((0, "A"), (1, "A+V")):
            ms = _ms(torch, lambda both=both: lib.probe_rows_round(
                G, np_, S, rounds, both, A.data_ptr(), V.data_ptr(),
                count.data_ptr(), stream), reps=3)
            row[name] = 1e3 * ms / rounds
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_cluster_sync: no CUDA device available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    res = measure(build(), args.quick)
    print(f"[probe] __syncthreads (1024 threads): {res['syncthreads_us']:.4f} us",
          flush=True)
    for C in CLUSTERS:
        print(f"[probe] cluster.sync, {C} CTAs: "
              f"{res['cluster_sync_us'][str(C)]:.4f} us "
              f"({res['max_active_clusters'][str(C)]} clusters fit)",
              flush=True)
    print(f"[probe] grid.sync, {res['grid_blocks']} CTAs: "
          f"{res['grid_sync_us']:.4f} us", flush=True)
    print(f"[probe] cluster.sync, 16 CTAs of {EIGH_SMEM} B shared memory: "
          f"{res['cluster_sync_smem_us']['16']:.4f} us "
          f"({res['cluster_smem_fit']['16']} clusters fit)", flush=True)
    for kind in GRID_KINDS:
        for G, us in res["grid_barrier_us"][kind].items():
            print(f"[probe] grid barrier {kind}, {G} CTAs (cooperative "
                  f"cudaLaunchKernelEx): {us:.4f} us; captured and replayed: "
                  f"{res['grid_barrier_captured'][kind][G]}", flush=True)
    for b, r in res["l2_read_GBps"].items():
        print(f"[probe] L2 read, {b} SMs: {r:.1f} GB/s", flush=True)
    for n, row in res["stream_round_us"].items():
        print(f"[probe] stream round model, n = {n}: A alone "
              f"{row['A']:.4f} us, A and V by index {row['A+V']:.4f} us",
              flush=True)
    res.update(device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
