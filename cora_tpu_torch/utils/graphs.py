"""Device loops replayed as CUDA graphs: the machinery that the TNT level
(`solve/tnt.py`), the certificate's LOBPCG (`ops/lobpcg.py`) and the f64
polish's CG (`solve/polish.py`) share.

The JAX package runs each of these loops as one compiled device program (a
`lax.while_loop`). The port keeps each loop's whole state in buffers
allocated once and advances it with step functions that read and write
only those buffers and never read the device from the host. `StepGraphs`
runs the step functions: eagerly, or, on a CUDA device, each captured once
as a CUDA graph (after a warm-up on a side stream, into one graph pool per
loop) and replayed; the host reads only what the driving loop asks for
(`read`, counted). `device_loop` sets the options of the loops inside it;
`keep` holds one captured loop per kind between calls while its key holds.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import gc
import time
from typing import Callable

import torch

from cora_tpu_torch.utils.timing import named_scope


@dataclasses.dataclass(frozen=True)
class LoopOptions:
    graphs: bool = True  # capture on a CUDA device
    block: int | None = None  # tCG iterations per block (None: default)
    lobpcg_block: int | None = None  # LOBPCG iterations per block
    cg_block: int | None = None  # polish CG iterations per block
    sync_debug: bool = False  # captures under set_sync_debug_mode("error")

    def block_of(self, field: str, default: int, graphs: bool) -> int:
        """The block of a loop: the option when set, else `default`
        captured and 1 eager (an eager loop reads its stop flag after every
        iteration, since a masked iteration costs it a full dispatch)."""
        return getattr(self, field) or (default if graphs else 1)


_OPTIONS = contextvars.ContextVar("cora_device_loop", default=LoopOptions())


def options() -> LoopOptions:
    return _OPTIONS.get()


@contextlib.contextmanager
def device_loop(graphs: bool | None = None, block: int | None = None,
                sync_debug: bool | None = None,
                lobpcg_block: int | None = None,
                cg_block: int | None = None):
    """Options of the device loops run inside: `graphs=False` runs the step
    functions eagerly on the card too (the staircase's
    `use_kernels="never"` and sharded solves); `block`, `lobpcg_block` and
    `cg_block` set the iterations per block of the tCG, LOBPCG and polish
    CG loops; `sync_debug=True` runs each warm-up, capture and first replay
    under `torch.cuda.set_sync_debug_mode("error")`, so any host
    synchronisation in a step function raises."""
    cur = _OPTIONS.get()
    new = {k: v for k, v in dict(
        graphs=graphs, block=block, sync_debug=sync_debug,
        lobpcg_block=lobpcg_block, cg_block=cg_block).items()
        if v is not None}
    token = _OPTIONS.set(dataclasses.replace(cur, **new))
    try:
        yield
    finally:
        _OPTIONS.reset(token)


@contextlib.contextmanager
def sync_errors(on: bool):
    """Every host synchronisation raises inside, when `on`."""
    if not on:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def collector_held():
    """Python's cycle collector held off inside (a CUDA graph's capture).
    A loop dropped from `keep` is cyclic garbage (its step functions are
    its own bound methods), so the collector frees its graphs whenever it
    next runs; a graph destroyed while another is being captured
    invalidates that capture, and `capture_end` then raises
    cudaErrorStreamCaptureInvalidated."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def copy_into(dst: dict, src: dict):
    for key, v in src.items():
        dst[key].copy_(v)


# the launch counts of kernels that run inside captured graphs (a kernel
# module registers its `LAUNCHES` dict): a capture only records its
# launches, and each replay adds them, so the counts are executions
COUNTERS: list[dict] = []


def _counts() -> list[dict]:
    return [dict(c) for c in COUNTERS]


class StepGraphs:
    """A loop's step functions (`fns`: name → fn(commit=True)), run eagerly
    or captured, with the counts in `stats` (captures, capture_s, replays,
    eager_calls, host_reads). A step function called with commit=False
    computes without writing the buffers (the warm-up)."""

    def __init__(self, fns: dict[str, Callable], stats: dict, graphs: bool,
                 device, sync_debug: bool = False, scope: str = "loop"):
        self.fns, self.stats, self.graphs = fns, stats, graphs
        self.sync_debug, self.scope = sync_debug, scope
        self.cuda_graphs: dict = {}
        self.launched: dict = {}  # name → the kernel launches in its graph
        if graphs:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(device=device)

    def run(self, name: str):
        with named_scope(f"{self.scope}/{name}"):
            if not self.graphs:
                self.stats["eager_calls"] += 1
                self.fns[name]()
                return
            g = self.cuda_graphs.get(name)
            if g is None:
                with sync_errors(self.sync_debug):
                    g = self._capture(name)
                    g.replay()
            else:
                g.replay()
            self.stats["replays"] += 1
            for counter, launched in zip(COUNTERS, self.launched[name]):
                for key, n in launched.items():
                    counter[key] += n

    def _capture(self, name: str):
        """Warm the step function up on the side stream (its results
        dropped, the buffers untouched), then capture it there into the
        loop's graph pool. A failure raises."""
        t0 = time.time()
        fn = self.fns[name]
        cur = torch.cuda.current_stream()
        self.stream.wait_stream(cur)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self.stream):
            fn(commit=False)
            before = _counts()
            with collector_held():
                g.capture_begin(pool=self.pool)
                try:
                    fn()
                finally:
                    g.capture_end()
        cur.wait_stream(self.stream)
        launched = [{k: c[k] - b[k] for k in c if c[k] != b[k]}
                    for c, b in zip(COUNTERS, before)]
        for counter, d in zip(COUNTERS, launched):
            for key, n in d.items():
                counter[key] -= n  # recorded, not run: the replays run them
        self.launched[name] = launched
        self.cuda_graphs[name] = g
        self.stats["captures"] += 1
        self.stats["capture_s"] += time.time() - t0
        return g

    def read(self, x: torch.Tensor, tensor: bool = False):
        """The one way the driving loop reads the device (counted): a list,
        or a host tensor."""
        self.stats["host_reads"] += 1
        return x.cpu() if tensor else x.tolist()


def reset_stats(stats: dict):
    for k in stats:
        stats[k] = 0.0 if k == "capture_s" else 0


# one kept captured loop per kind: kind → (key, loop)
_KEPT: dict = {}


def keep(kind: str, key, make: Callable, fresh: bool = False):
    """The kept loop of `kind` if its key is `key` (and not `fresh`), else
    a new one from `make()`, kept in its place (the old one freed)."""
    held = _KEPT.get(kind)
    if held is not None and held[0] == key and not fresh:
        return held[1]
    _KEPT.pop(kind, None)
    loop = make()
    _KEPT[kind] = (key, loop)
    return loop


def clear_graphs(kind: str | None = None):
    """Free the kept captured loops (their graphs, pools and buffers): all
    of them, or those of one kind."""
    if kind is None:
        _KEPT.clear()
    else:
        _KEPT.pop(kind, None)
