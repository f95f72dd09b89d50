"""`cora_tpu_torch/utils/graphs.py`'s capture on the CPU, through a stand-in
for `torch.cuda`'s graph API: a step function's capture runs with Python's
cycle collector held off.

A loop dropped from `keep` is cyclic garbage (its step functions are its
own bound methods), and a CUDA graph destroyed while another is being
captured invalidates that capture (`scripts/probe_graph_gc.py` shows both
on the card). So no collection may run between `capture_begin` and
`capture_end`: the warm-up and the replays run with the collector as the
caller left it.
"""

import contextlib
import gc

import pytest
import torch

from cora_tpu_torch.utils import graphs as loops


@pytest.fixture
def fake_cuda(monkeypatch):
    """`torch.cuda`'s graph and stream calls replaced by stand-ins that
    record (event, collector enabled)."""
    seen = []

    class Graph:
        def capture_begin(self, pool=None):
            seen.append(("begin", gc.isenabled()))

        def capture_end(self):
            seen.append(("end", gc.isenabled()))

        def replay(self):
            seen.append(("replay", gc.isenabled()))

    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 0))
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    return seen


def _stats():
    return dict(captures=0, capture_s=0.0, replays=0, eager_calls=0,
                host_reads=0)


@pytest.mark.parametrize("enabled", [True, False])
def test_capture_holds_off_the_cycle_collector(fake_cuda, enabled):
    seen = fake_cuda

    def step(commit=True):
        seen.append(("step", commit, gc.isenabled()))

    stats = _stats()
    loop = loops.StepGraphs({"step": step}, stats, True, "cpu")
    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        loop.run("step")
        loop.run("step")
        after = gc.isenabled()
    finally:
        (gc.enable if was else gc.disable)()
    assert seen == [("step", False, enabled), ("begin", False),
                    ("step", True, False), ("end", False),
                    ("replay", enabled), ("replay", enabled)]
    assert after == enabled
    assert stats["captures"] == 1 and stats["replays"] == 2


def test_failed_capture_gives_the_collector_back(fake_cuda):
    """A step function that raises inside the capture: the error comes
    out, and the collector is on again."""

    def step(commit=True):
        if commit:
            raise RuntimeError("not capturable")

    loop = loops.StepGraphs({"step": step}, _stats(), True, "cpu")
    assert gc.isenabled()
    with pytest.raises(RuntimeError, match="not capturable"):
        loop.run("step")
    assert gc.isenabled()
    assert fake_cuda == [("begin", False), ("end", False)]
