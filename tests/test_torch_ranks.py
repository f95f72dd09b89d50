"""The kernel path at every rank the JAX package's kernels take, on the CPU.

The JAX package's Pallas kernels take every rank their VMEM guard admits
(`cora_tpu/ops/pallas_tcg.py` `kernel_supported`, checked per rank by
`cora_tpu/solve/tnt_tiles.py` `get_kernel_backend`); on the plaza2-shaped
graph that is rank 80, on the single_drone-shaped graph rank 150. The
port's kernels keep their rank-sized buffers in dynamic shared memory
sized at launch, so their bound is `chain.rank_bound` (one block's shared
memory), and the certificate's Rayleigh–Ritz matrices (n = 3k, k = r + 2)
past the one-warp `small_eigh` kernel's n ≤ 32 go to its cluster family
(n ≤ 448), then to its grid (n ≤ 1056) and past that to its stream route
(A by index in L2). Here:
  * `PlainTNT` (the kernels' plain versions) at rank 12 (d = 2) and 11
    (d = 3) against the JAX package's interpret-mode `PallasTNT`, with the
    tests and tolerances of `test_torch_kernels_plain.py`;
  * a chain staircase started at rank 11 on the kernel route against the
    JAX package's from the same numpy start, at `test_torch_solve.py`'s
    tolerances, and one from rank 10 that escapes to rank 11 (the kernel
    route's escape past rank 10);
  * the bounds: `chain.rank_bound` at least the JAX guard's rank on both
    shaped graphs, and `small_eigh.route` taking n = 3·(that rank + 2);
  * the ladder's split of its 48 trial points at each rank: K = 7 groups
    at rank 4, more, smaller groups where shared memory is short;
  * the global route's order of operations (the one-CTA kernel's, at
    1024 threads), emulated in numpy, against `numpy.linalg.eigh` past
    n = 96; that the CUDA global kernel gives the one-CTA kernel's bits,
    and the cluster family the global kernel's, shows only on the card
    (`chip_smoke.py` phase 2); the cluster family's emulation is in
    `test_torch_small_eigh.py`;
  * the routing rule: a `max_rank` beyond the bound runs the canonical
    path, and raises up front under `use_kernels="always"`.
The CUDA kernels themselves run at these ranks only on the card
(`chip_smoke.py` phase 2).
"""

import dataclasses
import os
import sys
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from cora_tpu.models.synthetic import synthetic_problem as jax_problem  # noqa: E402
from cora_tpu.ops import tiles as T  # noqa: E402
from cora_tpu.ops.pallas_tcg import VMEM_BUDGET_BYTES, plan_vmem_bytes  # noqa: E402
from cora_tpu.solve.staircase import extract_solution as jax_extract  # noqa: E402
from cora_tpu.solve.staircase import solve_cora as jax_solve  # noqa: E402
from cora_tpu.types import SolverConfig as JaxConfig  # noqa: E402
from cora_tpu.types import TNTParams as JaxTNTParams  # noqa: E402
from cora_tpu.utils.evaluation import evaluate_ate as jax_ate  # noqa: E402
from cora_tpu_torch.models.synthetic import synthetic_problem  # noqa: E402
from cora_tpu_torch.ops import chain  # noqa: E402
from cora_tpu_torch.ops import small_eigh as se  # noqa: E402
from cora_tpu_torch.ops.tnt_kernels import (  # noqa: E402
    LADDER_CLUSTERS,
    CudaTNT,
)
from cora_tpu_torch.solve import staircase  # noqa: E402
from cora_tpu_torch.solve.staircase import (  # noqa: E402
    extract_solution,
    kernel_path_reason,
    solve_cora,
)
from cora_tpu_torch.types import SolverConfig, TNTParams  # noqa: E402
from cora_tpu_torch.utils.evaluation import evaluate_ate  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import test_torch_kernels_plain as plain  # noqa: E402
import test_torch_small_eigh as eigh  # noqa: E402
from torch_port_reference import noisy_chain_pyfg  # noqa: E402

# (d, r): past the seed's rank 10 in both dimensions
HIGH = [(2, 12), (3, 11)]
# the dataset-shaped graphs of scripts/torch_port_reference.py
PLAZA2 = dict(n_poses=4091, n_landmarks=4, n_ranges=1807, dim=2, seed=0)
SINGLE_DRONE = dict(n_poses=1754, n_landmarks=1, n_ranges=1754, dim=3,
                    seed=0)
# test_torch_solve.py's small 2D chain and end-to-end config
SMALL_2D = dict(n_poses=14, n_landmarks=2, n_ranges=10, dim=2, seed=3)
BASE = dict(dtype=np.float32, max_staircase_iterations=40, seed=0,
            polish_time_budget=120.0)
# a chain whose relaxation's optimum has rank 11, and levels run to a
# near-critical end (no ramp stall), so the staircase from rank 10 escapes
ESCAPE_GRAPH = dict(n_poses=200, n_landmarks=16, ranges_per_pose=4,
                    noise_scale=100.0, seed=0)
ESCAPE_BASE = dict(BASE, max_staircase_iterations=400, ramp_stall_window=0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels past rank 10


@pytest.mark.parametrize("dim,rank", HIGH)
@pytest.mark.parametrize("flag", [1, 0])
def test_step_plain_vs_pallas_high_rank(dim, rank, flag):
    plain.test_step_plain_vs_pallas(dim, rank, flag)


@pytest.mark.parametrize("dim,rank", HIGH)
def test_tcg_plain_vs_pallas_high_rank(dim, rank):
    plain.test_tcg_plain_vs_pallas(dim, rank)
    plain.test_tcg_many_iterations_plain_vs_pallas(dim, rank)


@pytest.mark.parametrize("dim,rank", HIGH)
def test_chunk_plain_vs_pallas_high_rank(dim, rank):
    plain.test_chunk_plain_vs_pallas(dim, rank)


@pytest.mark.parametrize("dim,rank", HIGH)
def test_ladder_plain_vs_pallas_high_rank(dim, rank):
    plain.test_ladder_plain_vs_pallas(dim, rank)


# ---------------------------------------------------------------------------
# a staircase started at rank 11 on the kernel route


def _x0(n_rows, rank, seed=4):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (n_rows, rank))


def test_staircase_from_rank_11_matches_jax(monkeypatch):
    levels = []
    solve = staircase.tnt_solve_tiles

    def recording(kern, X, *args, **kwargs):
        levels.append((type(kern).__name__, X.shape[1]))
        return solve(kern, X, *args, **kwargs)

    monkeypatch.setattr(staircase, "tnt_solve_tiles", recording)
    g = SMALL_2D
    problem = synthetic_problem(**g)
    x0 = _x0(problem.data_matrix_size, 11)
    cfg = SolverConfig(tnt=TNTParams(max_computation_time=600.0),
                       init_rank_jump=9, **BASE)
    res = solve_cora(problem, x0=x0, max_rank=12, config=cfg, device="cpu")
    ate = float(evaluate_ate(problem, extract_solution(problem, cfg, res)))
    assert levels[0] == ("PlainTNT", 11)  # the kernel route, at rank 11
    assert res.ranks_visited[0] == 11

    jp = jax_problem(**g)
    jcfg = JaxConfig(use_pallas="never", init_rank_jump=9,
                     tnt=JaxTNTParams(max_computation_time=600.0), **BASE)
    ref = jax_solve(jp, x0=x0, max_rank=12, config=jcfg)
    ref_ate = float(jax_ate(jp, jax_extract(jp, jcfg, ref)))
    assert ref.ranks_visited[0] == 11
    assert res.certified == ref.certified
    np.testing.assert_allclose(res.sdp_cost, ref.sdp_cost, rtol=1e-4)
    np.testing.assert_allclose(res.result.f, ref.result.f, rtol=1e-4)
    assert abs(ate - ref_ate) <= 1e-3
    assert torch.isfinite(res.result.x).all()


def test_staircase_escapes_across_rank_10_matches_jax(monkeypatch, tmp_path):
    """A graph whose relaxation's optimum has rank 11 (ranges that disagree
    with their stated noise): from rank 10 the level ends at a point whose
    certificate fails, and the escape on the kernel route (`step` and
    `ladder` at rank 11) lifts it to rank 11, where it certifies."""
    from cora_tpu import parse_pyfg as jax_parse
    from cora_tpu_torch.io.pyfg import parse_pyfg

    levels, escapes = [], []
    solve, escape = staircase.tnt_solve_tiles, staircase.saddle_escape_tiles

    def recording(kern, X, *args, **kwargs):
        levels.append((type(kern).__name__, X.shape[1]))
        return solve(kern, X, *args, **kwargs)

    def escaping(kern, Y, *args, **kwargs):
        out = escape(kern, Y, *args, **kwargs)
        escapes.append((Y.shape[1], out.shape[1]))
        return out

    monkeypatch.setattr(staircase, "tnt_solve_tiles", recording)
    monkeypatch.setattr(staircase, "saddle_escape_tiles", escaping)
    path = tmp_path / "noisy_chain.pyfg"
    path.write_text(noisy_chain_pyfg(**ESCAPE_GRAPH))
    problem = parse_pyfg(str(path))
    x0 = _x0(problem.data_matrix_size, 10)
    cfg = SolverConfig(tnt=TNTParams(max_computation_time=600.0),
                       init_rank_jump=8, **ESCAPE_BASE)
    res = solve_cora(problem, x0=x0, max_rank=12, config=cfg, device="cpu")
    ate = float(evaluate_ate(problem, extract_solution(problem, cfg, res)))
    assert levels[0] == ("PlainTNT", 10)  # the kernel route, at rank 10
    assert escapes and escapes[0] == (10, 11)
    assert res.ranks_visited[:2] == [10, 11]

    jp = jax_parse(str(path))
    jcfg = JaxConfig(use_pallas="never", init_rank_jump=8,
                     tnt=JaxTNTParams(max_computation_time=600.0),
                     **ESCAPE_BASE)
    ref = jax_solve(jp, x0=x0, max_rank=12, config=jcfg)
    ref_ate = float(jax_ate(jp, jax_extract(jp, jcfg, ref)))
    assert ref.ranks_visited == res.ranks_visited
    assert res.certified and ref.certified
    np.testing.assert_allclose(res.sdp_cost, ref.sdp_cost, rtol=1e-4)
    np.testing.assert_allclose(res.result.f, ref.result.f, rtol=1e-4)
    assert abs(ate - ref_ate) <= 1e-3
    assert torch.isfinite(res.result.x).all()


# ---------------------------------------------------------------------------
# the bounds


def _jax_guard_rank(g, most=400):
    """The highest rank the JAX package's VMEM guard admits on graph g."""
    jp = jax_problem(**g)
    jpd = jp.device_data(dtype=np.float32)
    plan = T.build_tile_plan(jp, jpd, 1, dtype=np.float32)
    fits = [r for r in range(1, most + 1) if plan_vmem_bytes(
        dataclasses.replace(plan, r=r)) <= VMEM_BUDGET_BYTES]
    assert fits and fits[-1] < most
    return fits[-1], jpd


@pytest.mark.parametrize("g", [PLAZA2, SINGLE_DRONE],
                         ids=["plaza2_shaped", "single_drone_shaped"])
def test_rank_bound_covers_the_jax_guard(g):
    guard, jpd = _jax_guard_rank(g)
    assert guard >= 80  # rank 80 plaza2-shaped, 150 single_drone-shaped
    assert chain.rank_bound(g["n_landmarks"], jpd.size) >= guard
    # the certificate at that rank: k = r + 2, Rayleigh–Ritz n = 3k, the
    # cluster family's to n = 448, the grid's to 1056 (rank 150's 456)
    n = 3 * (guard + 2)
    for dt in (torch.float32, torch.float64):
        assert se.route(n, dt) == ("cluster" if n <= se.CLUSTER_MAX_N
                                   else "grid")


def test_rank_bound_is_shared_memory():
    for l in (1, 4, 16):
        r = chain.rank_bound(l, 1000)
        room = chain.SMEM_OPTIN - chain.SMEM_STATIC
        assert chain.ladder_smem_bytes(l, r, 1) <= room
        assert chain.chain_smem_bytes(l, r) <= room
        assert chain.ladder_smem_bytes(l, r + 1, 1) > room
    assert chain.rank_bound(16, 1000) >= 150
    assert chain.rank_bound(0, 1000) == chain.INT32_MAX // 1000


def _stub_kernels(l, ranks):
    """A `CudaTNT` with only what its ladder split reads: the plan's
    landmarks and 7 clusters at every batch (the H100's count)."""
    cu = CudaTNT.__new__(CudaTNT)
    cu.plan = types.SimpleNamespace(l=l)
    cu._capacity = {("ladder", r, cu.ladder_batch(r)): 7 for r in ranks}
    return cu


@pytest.mark.parametrize("l,r", [(4, 4), (1, 5), (4, 11), (4, 32), (4, 80),
                                 (1, 150), (16, 150), (16, 600)])
def test_ladder_split_fits_shared_memory(l, r):
    cu = _stub_kernels(l, [r])
    batch = cu.ladder_batch(r)
    for clusters in (None, 1, 3, 7):
        K, grp = cu.ladder_split(r, 48, clusters)
        sizes = np.diff(grp)
        assert grp[0] == 0 and grp[-1] == 48 and sizes.min() >= 1
        assert sizes.max() <= batch
        assert K == (clusters or LADDER_CLUSTERS)
        # K groups where they fit, else as few more as fit
        assert len(sizes) == max(K, -(-48 // batch))
    if batch >= 7:  # e.g. rank 4: K = 7 groups, one launch, as before
        K, grp = cu.ladder_split(r, 48)
        assert K == 7 and np.array_equal(grp, chain.ladder_groups(48, 7))
    with pytest.raises(ValueError):
        cu.ladder_split(r, 48, 8)  # more than the card holds


# ---------------------------------------------------------------------------
# the global route of small_eigh, emulated


@pytest.mark.parametrize("n", [99, 150])
def test_global_route_emulation_matches_numpy(n):
    # more than two terms per thread in the stop test's sums past n = 45
    assert eigh.cta_threads(n) == 1024 and (n + n % 2) ** 2 > 2 * 1024
    M = eigh.corpus(n)["random"]
    ref_w, _ = np.linalg.eigh(M)
    scale = max(np.abs(ref_w).max(), 1.0)
    # the global kernel runs the one-CTA kernel's rounds and stop-test
    # sums for its thread count, A and V in global memory
    A, V, info = eigh.jacobi(M, rows=False)
    assert 0 < info <= se.MAX_SWEEPS
    w, V = eigh.finish(A, V, n)
    assert np.abs(w - ref_w).max() <= eigh.EIG_TOL * scale
    assert np.abs(M @ V - V * w).max() <= 10 * eigh.EIG_TOL * scale
    assert np.abs(V.T @ V - np.eye(n)).max() <= 10 * eigh.EIG_TOL


@pytest.mark.parametrize("n", [1, 97, 246, 456, 1057])
def test_route_global_by_size(n):
    """The global kernel where forced, at any n; routed to by no size:
    past the grid the stream route."""
    assert se.route(n, torch.float64, kernel="global") == "global"
    assert se.route(n, torch.float32) == (
        "warp" if n == 1 else "cluster" if n <= se.CLUSTER_MAX_N else
        "grid" if n <= se.GRID_MAX_N else "stream")


# ---------------------------------------------------------------------------
# routing: a max_rank beyond the bound


def test_max_rank_beyond_bound_runs_canonical_path(monkeypatch, capsys):
    problem = synthetic_problem(**SMALL_2D)
    pd = problem.device_data(np.float32, "cpu")
    top = chain.rank_bound(pd.l, pd.size)
    cfg = SolverConfig(tnt=TNTParams(max_computation_time=600.0), **BASE)
    assert kernel_path_reason(cfg, pd, max_rank=top) is None
    reason = kernel_path_reason(cfg, pd, max_rank=top + 1)
    assert reason is not None and "rank bound" in reason
    assert "rank bound" in kernel_path_reason(
        dataclasses.replace(cfg, max_rank=top + 1), pd)

    called = []
    for name in ("tnt_solve", "tnt_solve_tiles"):
        solve = getattr(staircase, name)
        monkeypatch.setattr(staircase, name, lambda *a, _s=solve, _n=name,
                            **k: called.append(_n) or _s(*a, **k))
    res = solve_cora(problem, x0=_x0(problem.data_matrix_size, 2),
                     max_rank=top + 1, config=cfg, device="cpu",
                     verbose=True)
    assert res.certified
    assert called and set(called) == {"tnt_solve"}
    assert "[kernels] canonical path: max_rank" in capsys.readouterr().out

    with pytest.raises(RuntimeError, match="rank bound"):
        solve_cora(problem, max_rank=top + 1, device="cpu",
                   config=dataclasses.replace(cfg, use_kernels="always"))
