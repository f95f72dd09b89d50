"""The port's own spans and counts (`cora_tpu_torch/utils/timing.py`,
`CoraResult.phases` and `.counters`), on the CPU and, marked `cuda`, on a
card.

  * every phase and part of a solve is a `torch.profiler` range of its
    seconds, and the top-level phases cover the solve;
  * a part's seconds are at most its phase's;
  * `CoraResult.counters` are the solve's own changes of the device loops'
    `LOOP_STATS`, on the canonical and the chain path;
  * a certificate or polish called outside a solve names its ranges and
    times into no timer;
  * the eager loops capture nothing; on a card, every capture is a range;
  * each saddle escape counts once (`CoraResult.counters["escape.escapes"]`),
    on the canonical and the chain path.

Imports nothing of JAX, so the `cuda` tests run on a machine without it
(`python -m pytest --noconftest -m cuda tests/test_torch_tracing.py`).
"""

import os
import sys
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cora_tpu_torch.io.pyfg import parse_pyfg
from cora_tpu_torch.models.synthetic import synthetic_problem
from cora_tpu_torch.ops.riemannian import project_to_manifold
from cora_tpu_torch.ops.tnt_kernels import PlainTNT
from cora_tpu_torch.solve import staircase
from cora_tpu_torch.solve.certify import certify_solution
from cora_tpu_torch.solve.polish import polish_solution
from cora_tpu_torch.types import Initialization, SolverConfig, TNTParams
from cora_tpu_torch.utils import graphs as loops
from cora_tpu_torch.utils.timing import PhaseTimer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
from torch_port_reference import multi_robot_pyfg  # noqa: E402

# a multi-robot graph (the canonical path), N = 152
GRAPH = dict(n_robots=3, poses_per_robot=12, n_inter_ranges=30,
             n_landmarks=2, n_landmark_ranges=12, n_loop_closures=2, dim=2,
             seed=0)
# the chain graph of tests/test_torch_solve.py
SMALL_CHAIN = dict(n_poses=14, n_landmarks=2, n_ranges=10, dim=2, seed=3)
# the families of `staircase.LOOP_STATS` that capture CUDA graphs
LOOPS = ("tnt", "lobpcg", "polish")


def config(iterations=20, tcg=10):
    """A short staircase: few TNT iterations, ranks 2-4, so that a solve
    lifts, certifies (failing, with the device LOBPCG and the host Lanczos),
    polishes, rounds and refines in about a second."""
    return SolverConfig(dtype=np.float32, seed=0, max_rank=4,
                        initialization=Initialization.ODOMETRY,
                        tnt=TNTParams(max_iterations=iterations,
                                      max_tcg_iterations=tcg))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pyfg") / "multi.pyfg")
    with open(path, "w") as fh:
        fh.write(multi_robot_pyfg(**GRAPH))
    return path


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


def ranges_of(prof) -> dict:
    """name → (summed seconds, count) of the host's `record_function`
    ranges in a finished profile."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.device_type() == DeviceType.CPU:
            secs, n = out.get(e.name(), (0.0, 0))
            out[e.name()] = (secs + (e.end_ns() - e.start_ns()) * 1e-9, n + 1)
    return out


def traced_solve(path, device):
    """Parse, solve and extract under `torch.profiler`."""
    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    cfg = config()
    with profile(activities=activities) as prof:
        problem = parse_pyfg(path)
        t0 = time.time()
        res = staircase.solve_cora(problem, config=cfg, device=device)
        wall = time.time() - t0
        staircase.extract_solution(problem, cfg, res)
    return types.SimpleNamespace(res=res, wall=wall, ranges=ranges_of(prof))


@pytest.fixture(scope="module")
def traced(graph_file):
    return traced_solve(graph_file, "cpu")


def check_ranges(traced):
    phases = traced.res.phases
    for key, secs in phases.items():
        assert key in traced.ranges, key
        assert abs(traced.ranges[key][0] - secs) <= 2e-3 + 0.05 * secs, key


def test_every_phase_and_part_is_a_range_of_its_seconds(traced):
    check_ranges(traced)


@pytest.mark.parametrize("keys", [
    ("prepare", "prepare/device_data", "prepare/backend", "prepare/start"),
    ("certify/host_matrix", "certify/host_decision", "certify/sigma_factor",
     "certify/device_factor", "certify/lobpcg1", "certify/lobpcg2",
     "certify/host_lanczos"),
    ("polish_f64/setup", "polish_f64/newton_cg", "polish_f64/armijo",
     "polish_final/newton_cg"),
    ("parse/tokenize", "parse/build", "extract", "tnt/setup", "tnt/block"),
], ids=["prepare", "certify", "polish", "ranges"])
def test_the_solve_names_its_parts(traced, keys):
    """The short solve runs every part of set-up, the certificate and the
    polish, and the ranges outside any phase."""
    named = set(traced.res.phases) | set(traced.ranges)
    assert set(keys) <= named


def test_parts_within_their_phase(traced):
    phases = traced.res.phases
    parts = [k for k in phases if "/" in k]
    assert parts
    for key in parts:
        assert phases[key] <= phases[key.split("/")[0]], key


def test_top_level_phases_cover_the_solve(traced):
    top = sum(v for k, v in traced.res.phases.items() if "/" not in k)
    assert top >= 0.9 * traced.wall, (top, traced.wall)
    assert top <= traced.wall


def test_eager_loops_capture_nothing(traced):
    assert not [n for n in traced.ranges if n.endswith("/capture")]
    counters = traced.res.counters
    for kind in LOOPS:
        assert counters[f"{kind}.captures"] == 0
        assert counters[f"{kind}.capture_s"] == 0.0
    assert counters["tnt.eager_calls"] > 0


def chain_solve():
    problem = synthetic_problem(**SMALL_CHAIN)
    assert staircase.kernel_path_reason(config(), problem.device_data(
        np.float32, "cpu")) is None
    return staircase.solve_cora(problem, config=config(10, 5), device="cpu")


def canonical_solve(path):
    return staircase.solve_cora(parse_pyfg(path), config=config(10, 5),
                                device="cpu")


@pytest.mark.parametrize("path", ["canonical", "chain"])
def test_each_solve_counts_its_own_loops(graph_file, path):
    """Two solves in one process: each one's counters are the change of
    the `LOOP_STATS` over it, and the level solver of either path counts
    its host reads and tCG iterations."""
    def solve():
        return canonical_solve(graph_file) if path == "canonical" \
            else chain_solve()

    for _ in range(2):
        before = loops.flat_stats(staircase.LOOP_STATS)
        res = solve()
        after = loops.flat_stats(staircase.LOOP_STATS)
        assert res.counters == {k: after[k] - before[k] for k in after}
        assert res.counters["tnt.tcg_iters"] > 0
        assert res.counters["tnt.host_reads"] > 0
        assert res.counters["tnt.outer_iters"] > 0


def staircase_config(jump, init):
    """The full TNT levels from rank d + `jump`, to rank 6."""
    return SolverConfig(dtype=np.float32, seed=0, max_rank=6,
                        initialization=init, init_rank_jump=jump)


@pytest.fixture
def ladder_calls(monkeypatch):
    """Counts the plain chain kernels' `ladder` calls: one per escape."""
    calls = []
    ladder = PlainTNT.ladder

    def counted(self, *a, **kw):
        calls.append(1)
        return ladder(self, *a, **kw)
    monkeypatch.setattr(PlainTNT, "ladder", counted)
    return calls


@pytest.mark.parametrize("path, jump, init", [
    ("chain", 0, Initialization.RANDOM),
    ("canonical", 0, Initialization.ODOMETRY),
    ("chain", 2, Initialization.ODOMETRY),
], ids=["chain-from-rank-d", "canonical-from-rank-d", "first-level"])
def test_each_escape_counts_once(graph_file, ladder_calls, path, jump, init):
    """From rank d the first certificate fails and the solve escapes: each
    escape counts once on either path (on the chain path, one `ladder`
    call each). A solve that certifies at its first level counts none."""
    problem = synthetic_problem(**SMALL_CHAIN) if path == "chain" \
        else parse_pyfg(graph_file)
    res = staircase.solve_cora(problem, config=staircase_config(jump, init),
                               device="cpu")
    escapes = res.counters["escape.escapes"]
    assert res.certified
    assert [k for k in res.counters if k.startswith("escape.")] == \
        ["escape.escapes"]
    if jump:
        assert len(res.ranks_visited) == 1 and escapes == 0
    else:
        assert escapes >= 1
    assert len(ladder_calls) == (escapes if path == "chain" else 0)


@pytest.mark.parametrize("call", ["certify", "polish"])
def test_outside_a_solve_ranges_and_no_phases(graph_file, call):
    """A certificate or polish called on its own runs as before, names its
    ranges "certify/<part>" or "polish/<part>", and times into no timer,
    not even one with a phase open."""
    problem = parse_pyfg(graph_file)
    pd = problem.device_data(np.float64, "cpu")
    rng = np.random.default_rng(5)
    Y = project_to_manifold(pd, torch.as_tensor(
        rng.uniform(-1.0, 1.0, (pd.size, 3))))
    outer = PhaseTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof, outer("outer"):
        if call == "certify":
            cert = certify_solution(problem, pd, Y, 1e-3, method="auto",
                                    max_lobpcg_iters=40)
            assert not cert.is_certified and np.isfinite(cert.theta)
            want = {"certify/host_matrix", "certify/host_decision",
                    "certify/lobpcg1", "certify/lobpcg2"}
        else:
            pres = polish_solution(problem, Y, max_iterations=2,
                                   device="cpu")
            assert pres.iterations > 0 and np.isfinite(pres.f)
            want = {"polish/setup", "polish/newton_cg", "polish/armijo"}
    assert want <= set(ranges_of(prof))
    assert set(outer.totals) == {"outer"}


@pytest.mark.cuda
def test_every_capture_is_a_range_on_the_card(card, graph_file):
    """A captured solve on the card: every phase and part is a range of its
    seconds, and the "<scope>/<name>/capture" ranges of each loop are as
    many as its counted captures."""
    traced = traced_solve(graph_file, "cuda")
    check_ranges(traced)
    counters = traced.res.counters
    assert sum(counters[f"{k}.captures"] for k in LOOPS) > 0
    for kind in LOOPS:
        n = sum(c for name, (_, c) in traced.ranges.items()
                if name.startswith(f"{kind}/") and name.endswith("/capture"))
        assert n == counters[f"{kind}.captures"], kind
        assert counters[f"{kind}.capture_s"] >= 0.0
