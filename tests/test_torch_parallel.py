"""The port's `parallel/` against the JAX package's, on the CPU.

Graphs: three synthetic chains (`synthetic_problem(13, 2, 7, seed=1)`,
whose edge counts do not divide 8 shards, `(300, 5, 150, seed=3)`, with
loop closures, landmarks and ranges across block boundaries, and
`(16, 1, 8, seed=0)`), and the 2-D and 3-D multi-robot graphs of
`tests/test_torch_general.py` (inter-robot ranges and loop closures, so
many separators).

  * `build_rowblock_plan` and `pad_problem_data`: the JAX package's arrays,
    exactly, for K = 1, 2, 4, 8;
  * the block-row and edge-sharded products with K shards emulated in one
    process: to 1e-12 relative to the output's largest entry in float64
    and 1e-5 in float32, against the port's unsharded `data_matrix_product`
    (K = 1, 2, 4, 8) and against the JAX package's operators on a K-device
    mesh (K = 8, the most padding and separators);
  * four `gloo` processes (`torch.multiprocessing`, a `file://` store):
    the block-row product equals the emulated K = 4 product bit for bit
    and the edge-sharded one agrees with it to 1e-12, on every rank the
    same bits; `solve_cora(..., mesh=)` in float64 on the 2-D multi-robot
    graph, explicit and implicit, from a numpy start: every rank ends on
    the same bits, `certified` as the port's unsharded solve with f within
    1e-8 relative, and `certified` as the JAX package's (unsharded) solve
    with f and `sdp_cost` within rtol 1e-4, as `test_torch_general.py`
    holds the port's solves;
  * the single-process bootstrap: no group started, `(0, 1)`, a mesh of
    one process on which both sharded operators are exact; a new group
    after the old one was destroyed gets a new operator;
  * `kernel_path_reason` is "mesh" under a mesh.

The spawned workers import this module, so it imports no JAX at module
level: the JAX package is imported inside the tests.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

from cora_tpu_torch.models.synthetic import synthetic_problem
from cora_tpu_torch.ops.quadratic import data_matrix_product
from cora_tpu_torch.parallel import sharding as shd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
from torch_port_reference import multi_robot_pyfg  # noqa: E402

SYNTH = {
    "pad13": dict(n_poses=13, n_landmarks=2, n_ranges=7, seed=1),
    "cross300": dict(n_poses=300, n_landmarks=5, n_ranges=150, seed=3),
    "n16": dict(n_poses=16, n_landmarks=1, n_ranges=8, seed=0),
}
# the multi-robot graphs of tests/test_torch_general.py
MULTI = {
    "2d": dict(n_robots=3, poses_per_robot=12, n_inter_ranges=30,
               n_landmarks=2, n_landmark_ranges=12, n_loop_closures=2, dim=2,
               seed=0),
    "3d": dict(n_robots=3, poses_per_robot=14, n_inter_ranges=40,
               n_landmarks=2, n_landmark_ranges=14, n_loop_closures=2, dim=3,
               seed=1),
}
GRAPHS = list(SYNTH) + list(MULTI)
KS = (1, 2, 4, 8)
JAX_KS = (8,)
TOL = {np.float64: 1e-12, np.float32: 1e-5}
WORLD = 4
GROUP_TIMEOUT_S = 120.0
# the sharded solves: float64, RegularizedCholesky, from a numpy start at
# rank d + 2, with the wall-clock caps of tests/test_torch_general.py
SOLVE = dict(max_staircase_iterations=40, seed=0, polish_time_budget=120.0)
X0_SEED = 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_pyfg(directory, name):
    path = os.path.join(directory, f"{name}.pyfg")
    if not os.path.exists(path):
        with open(path, "w") as fh:
            fh.write(multi_robot_pyfg(**MULTI[name]))
    return path


def _port_problem(name, directory):
    from cora_tpu_torch.io.pyfg import parse_pyfg

    if name in SYNTH:
        return synthetic_problem(**SYNTH[name])
    return parse_pyfg(_write_pyfg(directory, name))


def _jax_problem(name, directory):
    from cora_tpu.io.pyfg import parse_pyfg_python
    from cora_tpu.models.synthetic import synthetic_problem as jax_synthetic

    if name in SYNTH:
        return jax_synthetic(**SYNTH[name])
    return parse_pyfg_python(_write_pyfg(directory, name))


def _state(pd, seed=0, rank=4):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (pd.size, rank))).to(pd.dtype())


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _config(formulation):
    from cora_tpu_torch.types import (
        Formulation,
        Preconditioner,
        SolverConfig,
        TNTParams,
    )

    return SolverConfig(dtype=np.float64,
                        preconditioner=Preconditioner.REGULARIZED_CHOLESKY,
                        formulation=getattr(Formulation, formulation),
                        tnt=TNTParams(max_computation_time=600.0), **SOLVE)


def _x0(problem):
    return np.random.default_rng(X0_SEED).uniform(
        -1.0, 1.0, (problem.data_matrix_size, problem.dim + 2))


def _emulated_edge_product(pd, K):
    """Y ↦ the edge-sharded product of K shards in one process: each
    shard's partial product, summed in rank order (the all_reduce's sum)."""
    pdp = shd.pad_problem_data(pd, K)
    shards = [shd._edge_shard(pdp, K, k) for k in range(K)]
    rows = [shd._rng_rows(shard, k) for k, shard in enumerate(shards)]

    def op(Y):
        out = shd._partial_product(shards[0], rows[0], Y)
        for k in range(1, K):
            out = out + shd._partial_product(shards[k], rows[k], Y)
        return out

    return op


def _worker(rank, directory):
    """One rank of the four-process group: the sharded products on two
    graphs (and, on rank 0, the emulated K = 4 product), then the sharded
    solves; everything saved to `rank<k>.pt`."""
    import torch.distributed as dist

    from cora_tpu_torch.parallel.distributed import (
        init_distributed,
        make_global_mesh,
        process_info,
    )
    from cora_tpu_torch.solve.staircase import solve_cora

    torch.set_num_threads(1)
    assert init_distributed(f"file://{directory}/store", WORLD, rank,
                            device="cpu")
    assert process_info() == (rank, WORLD)
    mesh = make_global_mesh("cpu")
    out = {}
    for name in ("2d", "cross300"):
        problem = _port_problem(name, directory)
        pd = problem.device_data(np.float64, "cpu")
        Y = _state(pd)
        out[name, "blockrow"] = problem.sharded_operator(mesh)(Y)
        out[name, "edge"] = problem.sharded_operator(mesh, blockrow=False)(Y)
        if rank == 0:
            out[name, "emulated"] = shd.BlockRowOperator(
                pd, shd.build_rowblock_plan(pd, WORLD)).emulated(Y)
    problem = _port_problem("2d", directory)
    for formulation in ("EXPLICIT", "IMPLICIT"):
        res = solve_cora(problem, x0=_x0(problem),
                         config=_config(formulation), device="cpu", mesh=mesh)
        out[formulation] = dict(
            x=res.result.x, f=res.result.f, sdp_cost=res.sdp_cost,
            certified=res.certified, ranks=res.ranks_visited)
    torch.save(out, os.path.join(directory, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _join(ctx, t0):
    """Wait for the group, failing after GROUP_TIMEOUT_S (so a hung
    collective fails the test instead of the run)."""
    while not ctx.join(timeout=1.0):
        if time.time() - t0 > GROUP_TIMEOUT_S:
            pytest.fail(f"the {WORLD}-process group did not finish in "
                        f"{GROUP_TIMEOUT_S:.0f} s")


@pytest.fixture(scope="module")
def pyfg_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("pyfg"))


def test_four_process_group(tmp_path, pyfg_dir):
    """Four `gloo` ranks, started once in this one test (so one pytest
    worker spawns them). Products on two graphs: block-row on the emulated
    K = 4 bits on every rank, edge-sharded within 1e-12 of it, the same bits
    on every rank. The sharded staircase, explicit and implicit: the same
    bits on every rank, against the port's and the JAX package's unsharded
    solves (these run here while the group works)."""
    import torch.multiprocessing as mp

    pytest.importorskip("jax")
    from cora_tpu.solve import staircase as jax_staircase
    from cora_tpu.types import Formulation as JaxFormulation
    from cora_tpu.types import Preconditioner as JaxPrecond
    from cora_tpu.types import SolverConfig as JaxConfig
    from cora_tpu.types import TNTParams as JaxTNTParams
    from cora_tpu_torch.solve.staircase import solve_cora

    directory = str(tmp_path)
    _write_pyfg(directory, "2d")
    ctx = mp.start_processes(_worker, args=(directory,), nprocs=WORLD,
                             join=False, start_method="spawn")
    t0 = time.time()
    try:
        problem = _port_problem("2d", pyfg_dir)
        jp = _jax_problem("2d", pyfg_dir)
        refs = {}
        for formulation in ("EXPLICIT", "IMPLICIT"):
            refs[formulation] = (
                solve_cora(problem, x0=_x0(problem),
                           config=_config(formulation), device="cpu"),
                jax_staircase.solve_cora(jp, x0=_x0(jp), config=JaxConfig(
                    dtype=np.float64,
                    preconditioner=JaxPrecond.REGULARIZED_CHOLESKY,
                    formulation=getattr(JaxFormulation, formulation),
                    use_pallas="never",
                    tnt=JaxTNTParams(max_computation_time=600.0), **SOLVE)))
        _join(ctx, t0)
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    outs = [torch.load(os.path.join(directory, f"rank{k}.pt"),
                       weights_only=False) for k in range(WORLD)]

    for name in ("2d", "cross300"):
        emulated = outs[0][name, "emulated"]
        for k, out in enumerate(outs):
            assert torch.equal(out[name, "blockrow"], emulated), (name, k)
            assert torch.equal(out[name, "edge"], outs[0][name, "edge"])
        assert _rel(outs[0][name, "edge"], emulated) <= 1e-12, name
        pd = _port_problem(name, pyfg_dir).device_data(np.float64, "cpu")
        assert _rel(emulated, data_matrix_product(pd, _state(pd))) <= 1e-12

    for formulation, (ref, jref) in refs.items():
        runs = [out[formulation] for out in outs]
        first = runs[0]
        for k, run in enumerate(runs[1:], 1):
            assert torch.equal(run["x"], first["x"]), (formulation, k)
            assert (run["f"], run["ranks"]) == (first["f"], first["ranks"])
        assert first["certified"] == ref.certified == jref.certified
        assert abs(first["f"] - ref.result.f) <= 1e-8 * abs(ref.result.f)
        np.testing.assert_allclose(first["f"], jref.result.f, rtol=1e-4)
        np.testing.assert_allclose(first["sdp_cost"], jref.sdp_cost,
                                   rtol=1e-4)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("name", GRAPHS)
def test_plan_matches_jax(pyfg_dir, name, K):
    """`build_rowblock_plan` and `pad_problem_data`: JAX's arrays, exactly
    (the port's indices are int64 where JAX's are int32)."""
    pytest.importorskip("jax")
    from cora_tpu.parallel import sharding as jshd

    jpd = _jax_problem(name, pyfg_dir).device_data(dtype=np.float64)
    pd = _port_problem(name, pyfg_dir).device_data(np.float64, "cpu")
    jplan, plan = jshd.build_rowblock_plan(jpd, K), shd.build_rowblock_plan(
        pd, K)
    for f in plan.__dataclass_fields__:
        a, b = getattr(plan, f), getattr(jplan, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f
    jpad, pad = jshd.pad_problem_data(jpd, K), shd.pad_problem_data(pd, K)
    for f in ("rot_i", "rot_j", "rot_R", "rot_kappa", "pm_ti", "pm_tj",
              "pm_t", "pm_tau", "rng_ti", "rng_tj", "rng_r", "rng_omega"):
        np.testing.assert_array_equal(getattr(pad, f).numpy(),
                                      np.asarray(getattr(jpad, f)),
                                      err_msg=f)


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", GRAPHS)
def test_products_emulated(pyfg_dir, name, dtype):
    """K shards in one process, block-row and edge-sharded: the port's
    unsharded product at every K, the JAX package's sharded operators
    (jitted) on an 8-device mesh."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from cora_tpu.parallel import sharding as jshd

    tol = TOL[dtype]
    pd = _port_problem(name, pyfg_dir).device_data(dtype, "cpu")
    jpd = _jax_problem(name, pyfg_dir).device_data(dtype=dtype)
    Y = _state(pd)
    want = data_matrix_product(pd, Y)
    jY = jnp.asarray(Y.numpy())
    for K in KS:
        blockrow = shd.BlockRowOperator(pd, shd.build_rowblock_plan(pd, K))
        got = {"blockrow": blockrow.emulated(Y),
               "edge": _emulated_edge_product(pd, K)(Y)}
        for kind, out in got.items():
            assert out.dtype == want.dtype
            assert _rel(out, want) <= tol, (kind, K)
        if K in JAX_KS:
            mesh = Mesh(np.asarray(jax.devices()[:K]), (jshd.AXIS,))
            ref = {"blockrow": jshd.make_blockrow_operator(jpd, mesh),
                   "edge": jshd.make_sharded_operator(
                       jshd.shard_problem_data(jpd, mesh), mesh)}
            for kind, op in ref.items():
                assert _rel(got[kind], jax.jit(op)(jY)) <= tol, (kind, K)


def test_bootstrap_single_process(monkeypatch):
    """No environment: no group started, (0, 1); `make_global_mesh` makes
    a one-process group whose sharded operators are exact."""
    import torch.distributed as dist

    from cora_tpu_torch.parallel.distributed import (
        init_distributed,
        make_global_mesh,
        process_info,
    )

    for var in ("CORA_COORDINATOR", "CORA_NUM_PROCESSES", "CORA_PROCESS_ID",
                "RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    assert init_distributed() is False
    assert not dist.is_initialized()
    assert process_info() == (0, 1)
    mesh = make_global_mesh("cpu")
    try:
        assert mesh.size() == 1 and mesh.mesh_dim_names == (shd.AXIS,)
        assert process_info() == (0, 1)
        problem = synthetic_problem(**SYNTH["n16"])
        pd = problem.device_data(np.float64, "cpu")
        Y = _state(pd, rank=3)
        want = data_matrix_product(pd, Y)
        for blockrow in (True, False):
            op = problem.sharded_operator(mesh, blockrow=blockrow)
            assert op is problem.sharded_operator(mesh, blockrow=blockrow)
            assert op.implicit is None
            assert torch.equal(op(Y), want)
    finally:
        dist.destroy_process_group()


def test_sharded_operator_after_new_group():
    """A mesh made after the group was destroyed gets a new operator, bound
    to the new group, not the cached one of the old group."""
    import torch.distributed as dist

    from cora_tpu_torch.parallel.distributed import make_global_mesh

    problem = synthetic_problem(**SYNTH["n16"])
    pd = problem.device_data(np.float64, "cpu")
    Y = _state(pd, rank=3)
    want = data_matrix_product(pd, Y)
    ops = []
    for _ in range(2):
        mesh = make_global_mesh("cpu")
        try:
            ops.append(problem.sharded_operator(mesh))
            assert torch.equal(ops[-1](Y), want)
        finally:
            dist.destroy_process_group()
    assert ops[1] is not ops[0]


def test_implicit_full_product():
    """`make_operator(..., full_product=)` with the emulated block-row
    product (K = 4) gives the unsharded implicit operator's Q̃·Y and
    translations, to 1e-12."""
    from cora_tpu_torch.models.formulations import make_operator
    from cora_tpu_torch.types import Formulation

    problem = synthetic_problem(**SYNTH["cross300"])
    pd = problem.device_data(np.float64, "cpu")
    blockrow = shd.BlockRowOperator(pd, shd.build_rowblock_plan(pd, 4))
    calls = []

    def full_product(Z):
        calls.append(Z.shape)
        return blockrow.emulated(Z)

    op = make_operator(problem, pd, Formulation.IMPLICIT,
                       full_product=full_product)
    ref = make_operator(problem, pd, Formulation.IMPLICIT)
    Y = _state(pd)[: pd.rot_range_size]
    assert _rel(op(Y), ref(Y)) <= 1e-12
    assert len(calls) == 2  # [Y; 0] and [0; v]
    assert _rel(op.implicit.translation_explicit_solution(Y),
                ref.implicit.translation_explicit_solution(Y)) <= 1e-12


def test_kernel_path_reason_mesh():
    """Under a mesh the canonical path runs, whatever else the config
    says; `use_kernels="always"` then raises before any product."""
    from cora_tpu_torch.solve.staircase import kernel_path_reason, solve_cora
    from cora_tpu_torch.types import SolverConfig

    problem = synthetic_problem(**SYNTH["n16"])
    pd = problem.device_data(np.float32, "cpu")
    cfg = SolverConfig(dtype=np.float32)
    assert kernel_path_reason(cfg, pd) is None  # a chain: the kernels
    assert kernel_path_reason(cfg, pd, mesh=object()) == "mesh"
    cfg.use_kernels = "always"
    with pytest.raises(RuntimeError, match="mesh"):
        solve_cora(problem, config=cfg, device="cpu", mesh=object())
