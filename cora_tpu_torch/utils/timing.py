"""Wall-clock phase timing.

Parity with the reference's observability (wall-clock phase timers around
solves, `paper_experiments.cpp:631-641`) and with the JAX package's
`PhaseTimer` keys. On a CUDA device each phase is also an NVTX range, so
phases line up with kernels in a profiler timeline; the timer
synchronises the device at each phase's end, so a phase's time includes
the device work it queued.
"""

from __future__ import annotations

import contextlib
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
