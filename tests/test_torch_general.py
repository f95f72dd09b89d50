"""The general-graph path of the port against the JAX package, on the CPU.

Small multi-robot graphs (3 robots, odometry chains with ground truth,
inter-robot ranges between time-synchronous poses, ranges to landmarks and
loop closures; `scripts/torch_port_reference.py:multi_robot_pyfg`), written
once as PyFG text and parsed by each package's own parser. None of them is
an odometry chain, so the port solves them on the canonical path.

  * `parse_pyfg`: equal data matrices (exact);
  * `odometry_initialization`: equal bits (both are numpy-seeded);
  * the canonical ops in float64: to 1e-12 relative to the output's max
    entry (the same algebra summed in another order);
  * each preconditioner's apply in float64: to 1e-10, and BlockCholesky
    against a dense solve of its block-diagonal matrix;
  * `tnt_solve`'s first 8 iterations (f, ‖grad‖): 1e-10 in float64, 1e-4 /
    1e-3 in float32;
  * `saddle_escape`: the same escaped state (the same signed α) to 1e-10;
  * `solve_cora` end to end with the JAX package's XLA path: the same
    `certified`, f and `sdp_cost` to rtol 1e-4, ATE to 1e-3 m, and the
    first level's first 8 iterations to 1e-4 / 1e-3.
"""

import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cora_tpu import precond as jax_precond  # noqa: E402
from cora_tpu.io.pyfg import parse_pyfg_python as jax_parse  # noqa: E402
from cora_tpu.models.init import odometry_initialization as jax_odometry  # noqa: E402
from cora_tpu.models.synthetic import synthetic_problem as jax_synthetic  # noqa: E402
from cora_tpu.ops import quadratic as jq  # noqa: E402
from cora_tpu.ops import riemannian as jr  # noqa: E402
from cora_tpu.solve import staircase as jax_staircase  # noqa: E402
from cora_tpu.solve.certify import certify_solution as jax_certify  # noqa: E402
from cora_tpu.solve.saddle import saddle_escape as jax_escape  # noqa: E402
from cora_tpu.solve.tnt import tnt_solve as jax_tnt  # noqa: E402
from cora_tpu.types import Initialization as JaxInit  # noqa: E402
from cora_tpu.types import Preconditioner as JaxPrecond  # noqa: E402
from cora_tpu.types import SolverConfig as JaxConfig  # noqa: E402
from cora_tpu.types import TNTParams as JaxTNTParams  # noqa: E402
from cora_tpu.utils.evaluation import evaluate_ate as jax_ate  # noqa: E402
from cora_tpu_torch import precond  # noqa: E402
from cora_tpu_torch.io.pyfg import parse_pyfg  # noqa: E402
from cora_tpu_torch.models.init import odometry_initialization  # noqa: E402
from cora_tpu_torch.models.synthetic import synthetic_problem  # noqa: E402
from cora_tpu_torch.ops import quadratic as tq  # noqa: E402
from cora_tpu_torch.ops import riemannian as tr  # noqa: E402
from cora_tpu_torch.solve import staircase  # noqa: E402
from cora_tpu_torch.solve.saddle import saddle_escape  # noqa: E402
from cora_tpu_torch.solve.tnt import tnt_solve  # noqa: E402
from cora_tpu_torch.types import Initialization, Preconditioner  # noqa: E402
from cora_tpu_torch.types import SolverConfig, TNTParams  # noqa: E402
from cora_tpu_torch.utils.evaluation import evaluate_ate  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
from torch_port_reference import multi_robot_pyfg  # noqa: E402

GRAPHS = {
    "2d": dict(n_robots=3, poses_per_robot=12, n_inter_ranges=30,
               n_landmarks=2, n_landmark_ranges=12, n_loop_closures=2, dim=2,
               seed=0),
    "3d": dict(n_robots=3, poses_per_robot=14, n_inter_ranges=40,
               n_landmarks=2, n_landmark_ranges=14, n_loop_closures=2, dim=3,
               seed=1),
}
IDS = list(GRAPHS)
# the chain graph of tests/test_torch_solve.py
SMALL_CHAIN = dict(n_poses=14, n_landmarks=2, n_ranges=10, dim=2, seed=3)
KINDS = ["NONE", "JACOBI", "BLOCK_JACOBI", "BLOCK_CHOLESKY",
         "REGULARIZED_CHOLESKY"]
OPS = ["data_matrix_product", "jacobi_diagonal", "tangent_space_projection",
       "riemannian_hvp", "retract", "project_to_manifold"]
# the end-to-end config of tests/test_torch_solve.py
BASE = dict(dtype=np.float32, max_staircase_iterations=40, seed=0,
            polish_time_budget=120.0)
FIRST_CHUNK = 8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pyfg_files(tmp_path_factory):
    """name → the graph's PyFG file."""
    out = {}
    for name, g in GRAPHS.items():
        out[name] = str(tmp_path_factory.mktemp("pyfg") / f"{name}.pyfg")
        with open(out[name], "w") as fh:
            fh.write(multi_robot_pyfg(**g))
    return out


def _parse(path):
    """(JAX problem, port problem), each parsed by its own package."""
    return jax_parse(path), parse_pyfg(path)


@pytest.fixture(scope="module")
def problems(pyfg_files):
    return {name: _parse(path) for name, path in pyfg_files.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _start(problem, rank, seed=4):
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, (problem.data_matrix_size, rank))


def _point(jpd, rank, near_singular=False):
    """A projected start and a direction; `near_singular` makes the first
    rotation block's rows nearly parallel (σ_min/σ_max ≈ 1e-4), which the
    d = 2 closed form shifts and QDWH takes in its stride."""
    rng = np.random.default_rng(7)
    A = rng.uniform(-1.0, 1.0, (jpd.size, rank))
    if near_singular:
        d = jpd.d
        A[1:d] = A[0] + 1e-4 * rng.standard_normal((d - 1, rank))
    V = rng.standard_normal(A.shape)
    Y = np.asarray(jr.project_to_manifold(jpd, jnp.asarray(A)))
    return A, Y, V


@pytest.mark.parametrize("name", IDS)
def test_parse_pyfg_matches_jax(problems, name):
    jp, tp = problems[name]
    assert tp.data_matrix_size == jp.data_matrix_size
    assert tp.num_poses == jp.num_poses and tp.num_landmarks == jp.num_landmarks
    assert len(tp.range_measurements) == len(jp.range_measurements)
    assert (tp.data_matrix() != jp.data_matrix()).nnz == 0


@pytest.mark.parametrize("name", IDS)
def test_odometry_initialization_matches_jax(problems, name):
    jp, tp = problems[name]
    rank = GRAPHS[name]["dim"] + 2
    np.testing.assert_array_equal(odometry_initialization(tp, rank, seed=3),
                                  jax_odometry(jp, rank, seed=3))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name", IDS)
def test_general_op_f64(problems, name, op):
    jp, tp = problems[name]
    jpd, tpd = (jp.device_data(dtype=np.float64),
                tp.device_data(np.float64, "cpu"))
    rank = GRAPHS[name]["dim"] + 2
    A, Y, V = _point(jpd, rank, near_singular=op == "project_to_manifold")
    jY, jV = jnp.asarray(Y), jnp.asarray(V)
    tY, tV = torch.as_tensor(Y), torch.as_tensor(V)
    if op == "data_matrix_product":  # through `Problem.operator`
        ref, out = jq.data_matrix_product(jpd, jV), tp.operator(device="cpu")(tV)
    elif op == "jacobi_diagonal":
        ref, out = jq.jacobi_diagonal(jpd), tq.jacobi_diagonal(tpd)
    elif op == "tangent_space_projection":
        ref = jr.tangent_space_projection(jpd, jY, jV)
        out = tr.tangent_space_projection(tpd, tY, tV)
    elif op == "riemannian_hvp":
        G = jq.data_matrix_product(jpd, jY)
        ref = jr.riemannian_hvp(jpd, jY, G,
                                jr.tangent_space_projection(jpd, jY, jV))
        out = tr.riemannian_hvp(tpd, tY, torch.as_tensor(np.asarray(G)),
                                tr.tangent_space_projection(tpd, tY, tV))
    elif op == "retract":
        ref = jr.retract(jpd, jY, 0.3 * jV)
        out = tr.retract(tpd, tY, 0.3 * tV)
    else:
        ref = jr.project_to_manifold(jpd, jnp.asarray(A))
        out = tr.project_to_manifold(tpd, torch.as_tensor(A))
    assert out.dtype == torch.float64
    assert _rel(out, ref) < 1e-12


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", IDS)
def test_preconditioner_apply_f64(problems, name, kind):
    jp, tp = problems[name]
    jpd = jp.device_data(dtype=np.float64)
    V = np.random.default_rng(2).standard_normal((jpd.size, 4))
    ref = jax_precond.make_preconditioner(
        jp, jpd, getattr(JaxPrecond, kind))(jnp.asarray(V))
    out = precond.make_preconditioner(
        tp, tp.device_data(np.float64, "cpu"),
        getattr(Preconditioner, kind))(
            torch.as_tensor(V))
    assert _rel(out, ref) < 1e-10


@pytest.mark.parametrize("name", IDS)
def test_block_cholesky_matches_dense(problems, name):
    """BlockCholesky = blockdiag(Q + 1e-3·I per variable type)⁻¹, as in
    tests/test_solve.py, and not the RegularizedCholesky apply."""
    _, tp = problems[name]
    pd = tp.device_data(np.float64, "cpu")
    Q = tp.data_matrix().toarray()
    N, nd, ndm = pd.size, pd.rot_size, pd.rot_size + pd.m
    M = np.zeros_like(Q)
    for lo, hi in ((0, nd), (nd, ndm), (ndm, N)):
        M[lo:hi, lo:hi] = Q[lo:hi, lo:hi]
    M += 1e-3 * np.eye(N)
    V = np.random.default_rng(0).standard_normal((N, 3))
    got = precond.make_preconditioner(tp, pd, Preconditioner.BLOCK_CHOLESKY)(
        torch.as_tensor(V)).numpy()
    np.testing.assert_allclose(got, np.linalg.solve(M, V), rtol=1e-5,
                               atol=1e-8)
    reg = precond.make_preconditioner(
        tp, pd, Preconditioner.REGULARIZED_CHOLESKY)(torch.as_tensor(V))
    assert not np.allclose(reg.numpy(), got)


@pytest.mark.parametrize("dtype,tol_f,tol_g", [
    (np.float64, 1e-10, 1e-10), (np.float32, 1e-4, 1e-3)],
    ids=["f64", "f32"])
@pytest.mark.parametrize("name", IDS)
def test_tnt_solve_first_iterations(problems, name, dtype, tol_f, tol_g):
    """The canonical TNT from one projected start, RegularizedCholesky."""
    jp, tp = problems[name]
    rank = GRAPHS[name]["dim"] + 2
    jpd = jp.device_data(dtype=dtype)
    X = np.asarray(jr.project_to_manifold(
        jpd, jnp.asarray(_start(jp, rank), dtype)))
    ref = jax_tnt(jpd, jnp.asarray(X), jp.preconditioner_fn(
        JaxPrecond.REGULARIZED_CHOLESKY, dtype=dtype),
        JaxTNTParams(max_iterations=FIRST_CHUNK))
    out = tnt_solve(tp.device_data(dtype, "cpu"), torch.as_tensor(X),
                    tp.preconditioner_fn(Preconditioner.REGULARIZED_CHOLESKY,
                                         dtype=dtype, device="cpu"),
                    TNTParams(max_iterations=FIRST_CHUNK))
    assert out.num_iterations == ref.num_iterations == FIRST_CHUNK
    np.testing.assert_allclose(out.objective_values, ref.objective_values,
                               rtol=tol_f)
    np.testing.assert_allclose(out.gradient_norms, ref.gradient_norms,
                               rtol=tol_g)
    if dtype == np.float64:
        np.testing.assert_array_equal(out.inner_iterations,
                                      ref.inner_iterations)


@pytest.mark.parametrize("name", IDS)
def test_saddle_escape_matches_jax(problems, name):
    """From a float64 rank-d stationary point that fails its certificate,
    both escapes take the same signed step along the same eigenvector."""
    jp, tp = problems[name]
    d = GRAPHS[name]["dim"]
    jpd = jp.device_data(dtype=np.float64)
    jpre = jp.preconditioner_fn(JaxPrecond.REGULARIZED_CHOLESKY,
                                dtype=np.float64)
    Y0 = jr.project_to_manifold(jpd, jnp.asarray(_start(jp, d)))
    Y = np.asarray(jax_tnt(jpd, Y0, jpre, JaxTNTParams()).x)
    cert = jax_certify(jp, jpd, Y, 1e-5, method="auto")
    assert not cert.is_certified and cert.theta < 0
    v = cert.x / np.linalg.norm(cert.x)
    ref = np.asarray(jax_escape(jpd, jnp.asarray(Y), cert.theta, v, jpre))
    out = saddle_escape(
        tp.device_data(np.float64, "cpu"), torch.as_tensor(Y), cert.theta,
        v, tp.preconditioner_fn(Preconditioner.REGULARIZED_CHOLESKY,
                                dtype=np.float64, device="cpu"))
    assert out.shape == (Y.shape[0], d + 1)
    assert np.abs(ref[:, -1]).max() > 0  # the escape left the saddle
    assert _rel(out, ref) < 1e-10


def _record_levels(monkeypatch, module, name):
    """Wrap `module.name` (a TNT solve) to keep its results in call order."""
    levels = []
    solve = getattr(module, name)

    def recording(*args, **kwargs):
        levels.append(solve(*args, **kwargs))
        return levels[-1]

    monkeypatch.setattr(module, name, recording)
    return levels


# (graph, staircase start rank d + jump, start, preconditioner)
SOLVES = [
    ("2d", 0, "random", "REGULARIZED_CHOLESKY"),
    ("2d", 2, "odometry", "REGULARIZED_CHOLESKY"),
    ("3d", 2, "odometry", "REGULARIZED_CHOLESKY"),
    ("chain", 0, "random", "JACOBI"),
]


@pytest.mark.parametrize("name,jump,start,kind", SOLVES,
                         ids=[f"{s[0]}-{s[2]}-{s[3].lower()}" for s in SOLVES])
def test_solve_cora_general_matches_jax(pyfg_files, monkeypatch, name, jump,
                                        start, kind):
    # fresh problems: a certificate leaves its σ search's seed on the problem
    if name == "chain":
        jp, tp = jax_synthetic(**SMALL_CHAIN), synthetic_problem(**SMALL_CHAIN)
        d = SMALL_CHAIN["dim"]
    else:
        (jp, tp), d = _parse(pyfg_files[name]), GRAPHS[name]["dim"]
    x0 = _start(jp, d + jump) if start == "random" else None
    levels = _record_levels(monkeypatch, staircase, "tnt_solve")
    ref_levels = _record_levels(monkeypatch, jax_staircase, "tnt_solve")
    kw = dict(init_rank_jump=jump, **BASE)
    jcfg = JaxConfig(use_pallas="never",
                     preconditioner=getattr(JaxPrecond, kind),
                     initialization=JaxInit.ODOMETRY,
                     tnt=JaxTNTParams(max_computation_time=600.0), **kw)
    cfg = SolverConfig(preconditioner=getattr(Preconditioner, kind),
                       initialization=Initialization.ODOMETRY,
                       tnt=TNTParams(max_computation_time=600.0), **kw)
    ref = jax_staircase.solve_cora(jp, x0=x0, config=jcfg)
    res = staircase.solve_cora(tp, x0=x0, config=cfg, device="cpu")
    ref_ate = float(jax_ate(jp, jax_staircase.extract_solution(jp, jcfg, ref)))
    ate = float(evaluate_ate(tp, staircase.extract_solution(tp, cfg, res)))
    assert res.certified == ref.certified
    np.testing.assert_allclose(res.sdp_cost, ref.sdp_cost, rtol=1e-4)
    np.testing.assert_allclose(res.result.f, ref.result.f, rtol=1e-4)
    assert abs(ate - ref_ate) <= 1e-3
    first, ref_first = levels[0], ref_levels[0]
    assert first.num_iterations >= FIRST_CHUNK
    np.testing.assert_allclose(first.objective_values[:FIRST_CHUNK],
                               ref_first.objective_values[:FIRST_CHUNK],
                               rtol=1e-4)
    np.testing.assert_allclose(first.gradient_norms[:FIRST_CHUNK],
                               ref_first.gradient_norms[:FIRST_CHUNK],
                               rtol=1e-3)
