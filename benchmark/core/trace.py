"""The traced solve: `torch.profiler` over one whole solve, read in memory.

Device operations are the kernels, copies and sets that the profiler's
CUDA activity shows (user annotations left out). Busy time is the union of
their intervals inside the benchmark's span around the solve; the idle gaps
are what the union leaves, each named by the benchmark's span (parse,
solve, extract) and the innermost host operation the profiler shows over
it. Nothing is written to disk.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np

OUTER = "bench.solve"  # the span around one user's solve
SPANS = ("bench.parse", "bench.solve_cora", "bench.extract")
TOP = 10
NAME_CHARS = 160


def span(name: str):
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profiled(summary: dict):
    """Profile the block (CPU and CUDA activity); fill `summary` with
    `busy_s`, `window_s`, `device_ops` and `idle_gaps`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        yield
        torch.cuda.synchronize()
        t0 = time.perf_counter()
    t1 = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    t2 = time.perf_counter()
    summary.update(read_events(events))
    print(f"[bench] trace: {len(events)} events, profiler stop "
          f"{t1 - t0:.3f} s, events {t2 - t1:.3f} s, reading "
          f"{time.perf_counter() - t2:.3f} s", file=sys.stderr)


def read_events(events) -> dict:
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    dev, cpu = [], []
    for e in events:
        (dev if e.device_type() == cuda else cpu).append(e)
    # the record_function ranges (the benchmark's and the port's) appear on
    # the device too, under the same names: no device operations
    ranges = {OUTER, *SPANS}
    ranges.update(e.name() for e in cpu if e.is_user_annotation())
    cpu = [(e.start_ns(), e.end_ns(), e.name()) for e in cpu]
    outer = [c for c in cpu if c[2] == OUTER]
    if not outer:
        raise RuntimeError(f"the trace holds no {OUTER} span")
    w0, w1 = outer[0][0], outer[0][1]
    names = [e.name() for e in dev]
    s = np.fromiter((e.start_ns() for e in dev), np.int64, len(dev))
    e = np.fromiter((e.end_ns() for e in dev), np.int64, len(dev))
    keep = (e > w0) & (s < w1) & np.fromiter(
        (n not in ranges for n in names), bool, len(names))
    s, e = np.clip(s[keep], w0, w1), np.clip(e[keep], w0, w1)
    ids, table = [], {}
    for n, k in zip(names, keep.tolist()):
        if k:
            ids.append(table.setdefault(n, len(table)))
    per_name = np.bincount(np.array(ids, np.int64), weights=(e - s),
                           minlength=len(table))
    top = np.argsort(-per_name, kind="stable")[:TOP]
    by_id = list(table)
    busy_ns, gaps = union(s, e, w0, w1)
    return {
        "busy_s": busy_ns * 1e-9,
        "window_s": (w1 - w0) * 1e-9,
        "device_ops": [[by_id[i][:NAME_CHARS], float(per_name[i]) * 1e-9]
                       for i in top.tolist()],
        "idle_gaps": [[gap_name(cpu, a, b), (b - a) * 1e-9]
                      for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]],
    }


def union(s: np.ndarray, e: np.ndarray, w0: int, w1: int):
    """(covered ns, gaps [(start, end)]) of the intervals inside [w0, w1]."""
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    reach = np.maximum.accumulate(e) if len(e) else e
    # a new run starts where an interval begins after all before it ended
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    starts = s[new]
    ends = np.append(reach[np.flatnonzero(new)[1:] - 1], reach[-1:]) \
        if len(s) else e
    covered = int(np.sum(ends - starts))
    edges = np.concatenate([[w0], ends]), np.concatenate([starts, [w1]])
    gaps = [(int(a), int(b)) for a, b in zip(*edges) if b > a]
    return covered, gaps


def gap_name(cpu, a: int, b: int) -> str:
    """'<span>/<innermost host op over the gap's middle>'."""
    mid = (a + b) // 2
    over = [c for c in cpu if c[0] <= mid <= c[1]]
    where = next((c[2].split(".", 1)[1] for c in over if c[2] in SPANS),
                 "between spans")
    ops = [c for c in over if c[2] != OUTER and c[2] not in SPANS]
    op = min(ops, key=lambda c: c[1] - c[0])[2] if ops else "no host op"
    return f"{where}/{op}"[:NAME_CHARS]
