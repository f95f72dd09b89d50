"""The harness: no card, no result; a broken timed path, `correct` false;
on a card, a short run is correct."""

import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import faults
from benchmark.core import cell as cells
from benchmark.core import session
from benchmark.tests.conftest import SMALL, small_cell

CELLS = sorted(SMALL)


def run_cli(name, seconds="1"):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 11), "--seconds", seconds, "--trace", "0"],
        cwd=cells.ROOT, capture_output=True, text=True, timeout=1200)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = run_cli(CELLS[0])
    assert out.returncode == 2, out.stderr
    assert not out.stdout.strip()


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    faults.FAULTS[fault](monkeypatch.setattr)
    result = session.run(small_cell(name), 5, 0.01, False, "cpu",
                         time.time())
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card(card, name):
    out = run_cli(name, seconds="5")
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


class Event:
    """A profiler event as `torch.profiler` hands it over."""

    def __init__(self, name, start, end, cuda=False, annotation=False):
        from torch.autograd import DeviceType

        self._v = (name, start, end, annotation)
        self._dev = DeviceType.CUDA if cuda else DeviceType.CPU

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def is_user_annotation(self):
        return self._v[3]

    def device_type(self):
        return self._dev


def test_trace_reading():
    """Busy time is the union of the device operations inside the solve's
    span; ranges copied to the device are no operations; each idle gap is
    named by the benchmark's span and the innermost host op over it."""
    from benchmark.core import trace

    events = [
        Event("bench.solve", 0, 100, annotation=True),
        Event("bench.parse", 0, 30, annotation=True),
        Event("bench.solve_cora", 30, 100, annotation=True),
        Event("certify/lobpcg1", 60, 90, annotation=True),
        Event("aten::mm", 70, 80),
        Event("certify/lobpcg1", 60, 90, cuda=True),  # the range's copy
        Event("k1", 30, 50, cuda=True),
        Event("k2", 40, 60, cuda=True),
        Event("k1", 90, 120, cuda=True),  # clipped at the span's end
    ]
    out = trace.read_events(events)
    assert out["window_s"] == pytest.approx(100e-9)
    assert out["busy_s"] == pytest.approx(40e-9)
    assert out["device_ops"] == [["k1", pytest.approx(30e-9)],
                                 ["k2", pytest.approx(20e-9)]]
    assert out["idle_gaps"] == [["parse/no host op", pytest.approx(30e-9)],
                                ["solve_cora/aten::mm", pytest.approx(30e-9)]]


def test_import_guard_compares_whole_top_level_names():
    from benchmark import run

    assert run.loaded_forbidden(["cora_tpu_torch.ops", "jaxtyping"]) == []
    assert run.loaded_forbidden(["jax.numpy", "cora_tpu", "flax.linen",
                                 "torch"]) == ["cora_tpu", "flax", "jax"]
