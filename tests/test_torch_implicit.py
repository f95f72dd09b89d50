"""The port's translation-implicit (marginalized) formulation against the
JAX package's, on the CPU in float64.

Small graphs made from a seed: synthetic odometry chains with landmarks
(2D and 3D) and a multi-robot PyFG graph with inter-robot ranges and loop
closures (`scripts/torch_port_reference.py:multi_robot_pyfg`).

  * the implicit operator Q̃Y against JAX's `make_operator(…, IMPLICIT)` and
    against a dense Schur complement Qmain − B·L⁻¹·Bᵀ: 1e-10 relative to
    the output's max entry (the same algebra; the JAX associative scan and
    the port's doubling scan sum in another order);
  * translation recovery against JAX's: 1e-10; the recovered state zeroes
    the translation rows of Q·X (below 1e-8 of its max), the pinned row
    is exactly 0; a Laplacian beyond the band cap raises in both packages;
  * `implicit_precond`, `riemannian_gradient(op=)`, `riemannian_hvp(op=)`:
    1e-10;
  * `tnt_solve(op=)` from one start, its first 8 iterations' f and ‖grad‖
    at 1e-8, and its iterate log (`log_iterates`): the same count, the
    iterates equal at 1e-8;
  * `solve_cora` in implicit mode from one numpy start: `certified` and
    ranks equal, f within 1e-6 relative, `extract_solution` equal at 1e-6;
  * routing: `kernel_path_reason` names the implicit formulation and
    `log_iterates`, `use_kernels="always"` raises for them, and a float32
    implicit solve of a chain graph never reaches the chain kernels.
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
from cora_tpu.models.formulations import make_operator as jax_make_operator  # noqa: E402
from cora_tpu.models.synthetic import synthetic_problem as jax_synthetic  # noqa: E402
from cora_tpu.ops import riemannian as jr  # noqa: E402
from cora_tpu.solve import staircase as jax_staircase  # noqa: E402
from cora_tpu.solve.tnt import tnt_solve as jax_tnt  # noqa: E402
from cora_tpu.types import Formulation as JaxFormulation  # noqa: E402
from cora_tpu.types import Preconditioner as JaxPrecond  # noqa: E402
from cora_tpu.types import SolverConfig as JaxConfig  # noqa: E402
from cora_tpu.types import TNTParams as JaxTNTParams  # noqa: E402
from cora_tpu_torch import precond  # noqa: E402
from cora_tpu_torch.io.pyfg import parse_pyfg  # noqa: E402
from cora_tpu_torch.models.formulations import BW_CAP_LRED  # noqa: E402
from cora_tpu_torch.models.synthetic import synthetic_problem  # noqa: E402
from cora_tpu_torch.ops import riemannian as tr  # noqa: E402
from cora_tpu_torch.solve import staircase  # noqa: E402
from cora_tpu_torch.solve.tnt import tnt_solve  # noqa: E402
from cora_tpu_torch.types import Formulation, Preconditioner  # noqa: E402
from cora_tpu_torch.types import SolverConfig, TNTParams  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
from torch_port_reference import multi_robot_pyfg  # noqa: E402

CHAINS = {
    "chain2d": dict(n_poses=60, n_landmarks=3, n_ranges=40, dim=2, seed=1),
    "chain3d": dict(n_poses=45, n_landmarks=2, n_ranges=30, dim=3, seed=2),
}
MULTI = dict(n_robots=3, poses_per_robot=12, n_inter_ranges=30,
             n_landmarks=2, n_landmark_ranges=12, n_loop_closures=2, dim=2,
             seed=0)
IDS = list(CHAINS) + ["multi"]
FIRST_CHUNK = 8
# the end-to-end config of tests/test_torch_solve.py, in float64
BASE = dict(dtype=np.float64, max_staircase_iterations=40, seed=0,
            polish_time_budget=120.0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def multi_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pyfg") / "multi.pyfg")
    with open(path, "w") as fh:
        fh.write(multi_robot_pyfg(**MULTI))
    return path


def _problems(name, multi_file):
    """(JAX problem, port problem), fresh."""
    if name == "multi":
        return jax_parse(multi_file), parse_pyfg(multi_file)
    return jax_synthetic(**CHAINS[name]), synthetic_problem(**CHAINS[name])


@pytest.fixture(scope="module")
def problems(multi_file):
    return {name: _problems(name, multi_file) for name in IDS}


def _ops(jp, tp):
    """(JAX implicit operator, port implicit operator), float64."""
    jop = jax_make_operator(jp, jp.device_data(dtype=np.float64),
                            JaxFormulation.IMPLICIT, dtype=np.float64)
    return jop, tp.operator(Formulation.IMPLICIT, np.float64, "cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _start(problem, rank, seed=4):
    """A numpy start of the implicit state's height."""
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, (problem.rot_and_range_matrix_size, rank))


def _point(jp, jpd, rank):
    """A projected implicit-height point and a tangent direction."""
    Y = np.asarray(jr.project_to_manifold(jpd, jnp.asarray(_start(jp, rank))))
    V = np.random.default_rng(7).standard_normal(Y.shape)
    V = np.asarray(jr.tangent_space_projection(jpd, jnp.asarray(Y),
                                               jnp.asarray(V)))
    return Y, V


@pytest.mark.parametrize("name", IDS)
def test_implicit_operator_matches_jax_and_schur(problems, name):
    jp, tp = problems[name]
    jop, op = _ops(jp, tp)
    Y = np.random.default_rng(0).standard_normal(
        (tp.rot_and_range_matrix_size, 4))
    out = op(torch.as_tensor(Y))
    assert out.dtype == torch.float64 and out.shape == Y.shape
    assert _rel(out, jop(jnp.asarray(Y))) < 1e-10
    # dense Schur complement, last translation pinned
    Q = tp.data_matrix().toarray()
    h, n_tr = tp.rot_and_range_matrix_size, tp.num_translational_states
    B, L = Q[:h, h:h + n_tr - 1], Q[h:h + n_tr - 1, h:h + n_tr - 1]
    S = Q[:h, :h] - B @ np.linalg.solve(L, B.T)
    assert _rel(out, S @ Y) < 1e-10


@pytest.mark.parametrize("name", IDS)
def test_translation_explicit_solution(problems, name):
    jp, tp = problems[name]
    jop, op = _ops(jp, tp)
    Y = np.random.default_rng(1).standard_normal(
        (tp.rot_and_range_matrix_size, 3))
    X = op.implicit.translation_explicit_solution(torch.as_tensor(Y)).numpy()
    ref = np.asarray(jop.implicit.translation_explicit_solution(
        jnp.asarray(Y)))
    assert X.shape == (tp.data_matrix_size, 3)
    assert _rel(X, ref) < 1e-10
    np.testing.assert_array_equal(X[:Y.shape[0]], Y)
    QX = tp.data_matrix() @ X
    h = tp.rot_and_range_matrix_size
    assert np.abs(QX[h:]).max() < 1e-8 * max(1.0, np.abs(QX).max())
    assert not X[-1].any()  # the pinned translation


def _star_pyfg(n_poses: int) -> str:
    """An odometry chain whose first pose ranges to every other pose: the
    translation Laplacian's bandwidth under any ordering is at least half
    that pose's degree."""
    lines = [f"VERTEX_SE2 {i}.0 A{i} {0.5 * i} 0 0" for i in range(n_poses)]
    cov = "0.0025 0 0 0.0025 0 0.0001"
    lines += [f"EDGE_SE2 {i + 1}.0 A{i} A{i + 1} 0.5 0 0 {cov}"
              for i in range(n_poses - 1)]
    lines += [f"EDGE_RANGE {i}.0 A0 A{i} {0.5 * i} 0.01"
              for i in range(2, n_poses)]
    return "\n".join(lines) + "\n"


def test_band_cap_raises_in_both(tmp_path):
    path = str(tmp_path / "star.pyfg")
    with open(path, "w") as fh:
        fh.write(_star_pyfg(2 * BW_CAP_LRED + 40))
    jp, tp = jax_parse(path), parse_pyfg(path)
    with pytest.raises(NotImplementedError, match="not banded"):
        tp.operator(Formulation.IMPLICIT, np.float64, "cpu")
    with pytest.raises(NotImplementedError, match="not banded"):
        jax_make_operator(jp, jp.device_data(dtype=np.float64),
                          JaxFormulation.IMPLICIT, dtype=np.float64)


@pytest.mark.parametrize("name", IDS)
def test_implicit_precond_matches_jax(problems, name):
    jp, tp = problems[name]
    jpre = jax_precond.implicit_precond(jp.preconditioner_fn(
        JaxPrecond.REGULARIZED_CHOLESKY, dtype=np.float64))
    pre = precond.implicit_precond(tp.preconditioner_fn(
        Preconditioner.REGULARIZED_CHOLESKY, np.float64, device="cpu"))
    V = np.random.default_rng(2).standard_normal(
        (tp.rot_and_range_matrix_size, 4))
    out = pre(torch.as_tensor(V))
    assert out.shape == V.shape
    assert _rel(out, jpre(jnp.asarray(V))) < 1e-10


@pytest.mark.parametrize("fn", ["riemannian_gradient", "riemannian_hvp"])
@pytest.mark.parametrize("name", IDS)
def test_riemannian_ops_with_implicit_op(problems, name, fn):
    jp, tp = problems[name]
    jop, op = _ops(jp, tp)
    jpd, tpd = jp.device_data(dtype=np.float64), tp.device_data(
        np.float64, "cpu")
    Y, V = _point(jp, jpd, jp.dim + 2)
    tY, tV = torch.as_tensor(Y), torch.as_tensor(V)
    if fn == "riemannian_gradient":
        ref = jr.riemannian_gradient(jpd, jnp.asarray(Y), op=jop)
        out = tr.riemannian_gradient(tpd, tY, op=op)
    else:
        ref = jr.riemannian_hvp(jpd, jnp.asarray(Y), jop(jnp.asarray(Y)),
                                jnp.asarray(V), op=jop)
        out = tr.riemannian_hvp(tpd, tY, op(tY), tV, op=op)
    assert out.shape == Y.shape
    assert _rel(out, ref) < 1e-10


def _tnt_pair(jp, tp, iters, log_iterates):
    """JAX's and the port's implicit `tnt_solve` from one projected start,
    RegularizedCholesky through `implicit_precond`."""
    jop, op = _ops(jp, tp)
    jpd = jp.device_data(dtype=np.float64)
    X = np.asarray(jr.project_to_manifold(
        jpd, jnp.asarray(_start(jp, jp.dim + 2))))
    ref = jax_tnt(jpd, jnp.asarray(X), jax_precond.implicit_precond(
        jp.preconditioner_fn(JaxPrecond.REGULARIZED_CHOLESKY,
                             dtype=np.float64)),
        JaxTNTParams(max_iterations=iters), op=jop,
        log_iterates=log_iterates)
    out = tnt_solve(tp.device_data(np.float64, "cpu"), torch.as_tensor(X),
                    precond.implicit_precond(tp.preconditioner_fn(
                        Preconditioner.REGULARIZED_CHOLESKY, np.float64,
                        device="cpu")),
                    TNTParams(max_iterations=iters), op=op,
                    log_iterates=log_iterates)
    return ref, out


@pytest.mark.parametrize("name", IDS)
def test_tnt_solve_implicit_first_iterations(problems, name):
    jp, tp = problems[name]
    ref, out = _tnt_pair(jp, tp, FIRST_CHUNK, False)
    assert out.num_iterations == ref.num_iterations == FIRST_CHUNK
    assert out.iterates is None
    np.testing.assert_allclose(out.objective_values, ref.objective_values,
                               rtol=1e-8)
    np.testing.assert_allclose(out.gradient_norms, ref.gradient_norms,
                               rtol=1e-8)
    np.testing.assert_array_equal(out.inner_iterations, ref.inner_iterations)


@pytest.mark.parametrize("name", ["chain2d", "multi"])
def test_log_iterates_match_jax(problems, name):
    jp, tp = problems[name]
    ref, out = _tnt_pair(jp, tp, 12, True)
    assert len(out.iterates) == len(ref.iterates) == out.num_iterations
    for a, b in zip(out.iterates, ref.iterates):
        assert a.dtype == np.float64 and a.shape == np.shape(b)
        assert _rel(a, b) < 1e-8
    np.testing.assert_array_equal(out.iterates[-1], out.x.numpy())


# (graph, staircase start rank d + jump)
SOLVES = [("chain2d", 0), ("chain3d", 1), ("multi", 0)]


@pytest.mark.parametrize("name,jump", SOLVES,
                         ids=[f"{s[0]}-jump{s[1]}" for s in SOLVES])
def test_solve_cora_implicit_matches_jax(multi_file, name, jump):
    # fresh problems: a certificate leaves its σ search's seed on the problem
    jp, tp = _problems(name, multi_file)
    x0 = _start(jp, jp.dim + jump)
    kw = dict(init_rank_jump=jump, **BASE)
    jcfg = JaxConfig(use_pallas="never", formulation=JaxFormulation.IMPLICIT,
                     tnt=JaxTNTParams(max_computation_time=600.0), **kw)
    cfg = SolverConfig(formulation=Formulation.IMPLICIT,
                       tnt=TNTParams(max_computation_time=600.0), **kw)
    ref = jax_staircase.solve_cora(jp, x0=x0, config=jcfg)
    res = staircase.solve_cora(tp, x0=x0, config=cfg, device="cpu")
    assert res.result.x.shape[0] == tp.rot_and_range_matrix_size
    assert res.certified == ref.certified
    assert res.ranks_visited == ref.ranks_visited
    np.testing.assert_allclose(res.result.f, ref.result.f, rtol=1e-6)
    soln = staircase.extract_solution(tp, cfg, res)
    assert soln.shape == (tp.data_matrix_size, tp.dim)
    assert _rel(soln, jax_staircase.extract_solution(jp, jcfg, ref)) < 1e-6


def test_kernel_path_reason_names_implicit_and_log_iterates():
    tp = synthetic_problem(**CHAINS["chain2d"])
    pd = tp.device_data(np.float32, "cpu")
    f32 = dict(dtype=np.float32)
    assert staircase.kernel_path_reason(SolverConfig(**f32), pd) is None
    implicit = SolverConfig(formulation=Formulation.IMPLICIT, **f32)
    logged = SolverConfig(log_iterates=True, **f32)
    assert staircase.kernel_path_reason(implicit, pd) == \
        "formulation implicit"
    assert staircase.kernel_path_reason(logged, pd) == "log_iterates"
    for cfg in (implicit, logged):
        cfg.use_kernels = "always"
        with pytest.raises(RuntimeError, match="do not cover this solve"):
            staircase.solve_cora(tp, config=cfg, device="cpu")


def test_float32_implicit_chain_solve_takes_the_canonical_path(monkeypatch):
    """A float32 RegularizedCholesky implicit solve of a chain graph would
    run the chain kernels on the explicit state without the routing rule;
    it must take the canonical path."""
    def refuse(*args, **kwargs):
        raise AssertionError("the chain kernels ran an implicit solve")

    monkeypatch.setattr(staircase, "tnt_solve_tiles", refuse)
    monkeypatch.setattr(staircase, "get_kernel_backend", refuse)
    tp = synthetic_problem(n_poses=14, n_landmarks=2, n_ranges=10, dim=2,
                           seed=3)
    cfg = SolverConfig(formulation=Formulation.IMPLICIT, dtype=np.float32,
                       max_staircase_iterations=40, seed=0, init_rank_jump=1,
                       polish_time_budget=120.0)
    res = staircase.solve_cora(tp, x0=_start(tp, 3), config=cfg,
                               device="cpu")
    assert res.result.x.dtype == torch.float32
    assert res.result.x.shape[0] == tp.rot_and_range_matrix_size
    assert np.isfinite(res.result.f)
