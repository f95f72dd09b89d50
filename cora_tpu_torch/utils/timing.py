"""Wall-clock phase timing.

Parity with the reference's observability (wall-clock phase timers around
solves, `paper_experiments.cpp:631-641`) and with the JAX package's
`PhaseTimer` keys. On a CUDA device each phase is also an NVTX range, so
phases line up with kernels in a profiler timeline; the timer
synchronises the device at each phase's end, so a phase's time includes
the device work it queued. `profiler_trace` and `named_scope` are the JAX
package's names (`cora_tpu/utils/timing.py:52-69`) on `torch.profiler`.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class PhaseTimer:
    """Accumulating named phase timer.

    >>> timer = PhaseTimer()
    >>> with timer("solve"):
    ...     ...
    >>> timer.report()
    """

    def __init__(self, device="cpu"):
        self.cuda = torch.device(device).type == "cuda"
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time()
        if self.cuda:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if self.cuda:
                torch.cuda.synchronize()
                torch.cuda.nvtx.range_pop()
            self.totals[name] += time.time() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = [
            f"{name:30} {self.totals[name]:9.3f}s  ({self.counts[name]}x)"
            for name in sorted(self.totals, key=self.totals.get, reverse=True)
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """Profile the block with `torch.profiler` (host ops, and the card's
    kernels where there is one) and write a Chrome trace to
    `logdir/trace.json` (view it in chrome://tracing or Perfetto). Yields
    the profiler, whose `key_averages()` sum the events."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def named_scope(name: str):
    """A named range in traces: a `torch.profiler` record and, on a CUDA
    build with a card, an NVTX range."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
