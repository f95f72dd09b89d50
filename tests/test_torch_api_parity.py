"""Public-name parity between the JAX package and the port, by AST.

For every module of `cora_tpu/` and its counterpart in `cora_tpu_torch/`
(the same path, or for the Pallas-only modules the module that replaces
it), the public top-level functions, classes, constants, class fields and
methods, and every parameter of them, are read from the source without
importing it. Whatever the JAX side has and the port lacks must be in
`DROPPED`, with the reason it was left out; an entry there that the port
now has, or that the JAX side never had, fails too. What the diff showed
to be behaviour is ported, each with a test against the JAX package below:
`certify_solution(rank_deficient_exit=)`, `saddle_escape(alpha_min=)` (and
the chain kernels' `saddle_escape_tiles`), and `tnt_solve`'s
`max_iterations_override`, `max_tcg_override` and `max_time`.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_ROOT, PORT_ROOT = REPO / "cora_tpu", REPO / "cora_tpu_torch"
# the Pallas-only modules and the port's modules that replace them
RENAMED = {"ops/tiles.py": "ops/chain.py",
           "ops/pallas_tcg.py": "ops/tnt_kernels.py",
           "solve/tnt_tiles.py": "solve/tnt_kernel.py"}
PALLAS = ("the TPU's 128-lane pose-pair tile layout and its Pallas kernel "
          "class; the port's kernels work on the canonical (N, r) state "
          "(chain.ChainPlan, CudaTNT, PlainTNT)")
KEY = ("a jax.random key; the port draws from a torch.Generator "
       "(`generator`)")
# (JAX module, name) → why the port leaves it out; a class or function
# entry covers its members and parameters
DROPPED = {
    ("ops/tiles.py", "LANES"): PALLAS,
    ("ops/tiles.py", "TilePlan"): PALLAS,
    ("ops/tiles.py", "TileOps"): PALLAS,
    ("ops/tiles.py", "build_tile_plan"): PALLAS + "; chain.build_chain_plan",
    ("ops/tiles.py", "to_tiles"): PALLAS,
    ("ops/tiles.py", "from_tiles"): PALLAS,
    ("ops/tiles.py", "make_host_ops"): PALLAS,
    ("ops/pallas_tcg.py", "LANES"): PALLAS,
    ("ops/pallas_tcg.py", "PallasTNT"): PALLAS,
    ("ops/pallas_tcg.py", "KernelCompileError"): (
        "Mosaic's compile failure, which the JAX package catches to fall "
        "back to XLA; a CUDA kernel that fails to build or launch raises "
        "KernelBuildError / KernelLaunchError and nothing falls back"),
    ("ops/pallas_tcg.py", "VMEM_BUDGET_BYTES"): (
        "the TPU's VMEM guard; the card's bound is chain.rank_bound"),
    ("ops/pallas_tcg.py", "plan_vmem_bytes"): (
        "the TPU's VMEM estimate; the card's is chain.chain_smem_bytes"),
    ("ops/pallas_tcg.py", "kernel_supported"): (
        "the TPU's VMEM guard per rank; the port checks max_rank against "
        "chain.rank_bound up front (staircase.kernel_path_reason)"),
    ("solve/tnt_tiles.py", "get_kernel_backend(interpret)"): (
        "Pallas' interpret mode; the CUDA kernels have none (the CPU runs "
        "PlainTNT)"),
    ("solve/tnt_tiles.py", "get_kernel_backend(pd)"): (
        "the port's backend builds its plan from the problem"),
    ("solve/tnt_tiles.py", "get_kernel_backend(rank)"): (
        "one CudaTNT serves every rank: the kernels read it from the state"),
    ("solve/tnt_tiles.py", "saddle_escape_tiles(plan)"): (
        "the plan travels in the kernels object (`kern.plan`)"),
    ("solve/tnt_tiles.py", "tnt_solve_tiles(plan)"): (
        "the plan travels in the kernels object (`kern.plan`)"),
    ("solve/tnt_tiles.py", "tnt_solve_tiles(max_iterations_override)"): (
        "dropped with the port's first slice: the staircase never passes "
        "it to the kernel path (the canonical tnt_solve takes it)"),
    ("solve/tnt_tiles.py", "tnt_solve_tiles(max_tcg_override)"): (
        "dropped with the port's first slice, as above"),
    ("solve/tnt_tiles.py", "tnt_solve_tiles(max_time)"): (
        "dropped with the port's first slice: params.max_computation_time"),
    ("io/pyfg.py", "parse_pyfg(use_native)"): (
        "the port parses with its native tokenizer whenever it builds "
        "(`native.pyfg_fast`), else in Python; no caller needs the "
        "switch"),
    ("ops/linalg.py", "UNROLL_LIMIT"): (
        "how far the TPU code unrolls small products into multiply-adds; "
        "PyTorch runs them as matmuls"),
    ("ops/manifolds.py", "oblique_project(eps)"): (
        "the JAX function ignores it (it clamps at the dtype's tiny)"),
    ("ops/manifolds.py", "oblique_random(key)"): KEY,
    ("ops/manifolds.py", "stiefel_random(key)"): KEY,
    ("ops/riemannian.py", "random_initial_guess(key)"): KEY,
    ("parallel/sharding.py", "make_mesh(devices)"): (
        "a torch DeviceMesh spans the processes of the default group, one "
        "card each, not a list of devices"),
    ("precond/__init__.py", "make_preconditioner(dtype)"): (
        "the port's preconditioner takes the dtype of `pd`"),
    ("precond/banded.py", "banded_apply(sequential)"): (
        "the TPU's sequential scan for Mosaic; the port applies the band "
        "by its doubling scan only"),
    ("precond/banded.py", "banded_apply_seq"): (
        "the TPU's sequential scan for Mosaic, as above"),
    ("solve/polish.py", "polish_solution(pd)"): (
        "the port's polish builds its float64 data from the problem on "
        "the solve's device"),
    ("solve/polish.py", "project_to_manifold"): (
        "the JAX polish's numpy helper; the port's polish runs on the "
        "device with ops.riemannian's"),
    ("solve/polish.py", "tangent_project"): (
        "the JAX polish's numpy helper, as above"),
    ("solve/tnt.py", "STALL_STATUSES"): "nothing in the JAX package reads it",
    ("types.py", "SolverConfig.use_pallas"): (
        "renamed `use_kernels`: the port's kernels are CUDA, not Pallas"),
}


def public(path: pathlib.Path) -> set:
    """The module's public surface: top-level functions, classes and
    constants; class fields and methods (`__init__` too); parameters as
    `name(arg)` (`self`/`cls` left out)."""
    out = set()

    def params(fn, pre):
        a = fn.args
        for x in a.posonlyargs + a.args + a.kwonlyargs:
            if x.arg not in ("self", "cls"):
                out.add(f"{pre}({x.arg})")
        for x, star in ((a.vararg, "*"), (a.kwarg, "**")):
            if x is not None:
                out.add(f"{pre}({star}{x.arg})")

    def names(node):
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        return [t.id for t in targets
                if isinstance(t, ast.Name) and not t.id.startswith("_")]

    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                out.add(node.name)
                params(node, node.name)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out.add(node.name)
            for b in node.body:
                if isinstance(b, ast.FunctionDef) and (
                        not b.name.startswith("_") or b.name == "__init__"):
                    out.add(f"{node.name}.{b.name}")
                    params(b, f"{node.name}.{b.name}")
                elif isinstance(b, (ast.Assign, ast.AnnAssign)):
                    out.update(f"{node.name}.{n}" for n in names(b))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out.update(names(node))
    return out


def covered(module: str, item: str) -> bool:
    """An item is dropped if it, or the class or function it belongs to,
    is in DROPPED."""
    head = item.split("(")[0].split(".")[0]
    return (module, item) in DROPPED or (module, head) in DROPPED


MODULES = sorted(str(p.relative_to(JAX_ROOT))
                 for p in JAX_ROOT.rglob("*.py"))


@pytest.mark.parametrize("module", MODULES)
def test_public_names_have_port_counterparts(module):
    port = PORT_ROOT / RENAMED.get(module, module)
    assert port.exists(), f"no counterpart of cora_tpu/{module}"
    ours, theirs = public(port), public(JAX_ROOT / module)
    missing = sorted(x for x in theirs - ours if not covered(module, x))
    assert not missing, f"{module}: not in the port and not in DROPPED"


def test_dropped_entries_are_real():
    """Every DROPPED entry names something the JAX module has and the
    port's counterpart lacks."""
    for (module, item), reason in DROPPED.items():
        assert reason
        theirs = public(JAX_ROOT / module)
        ours = public(PORT_ROOT / RENAMED.get(module, module))
        assert item in theirs, (module, item)
        assert item not in ours, (module, item)


# ---------------------------------------------------------------------------
# what the diff showed to be behaviour, against the JAX package

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cora_tpu.models.synthetic import synthetic_problem as jax_problem  # noqa: E402
from cora_tpu.ops import riemannian as jr  # noqa: E402
from cora_tpu.solve import certify as jax_certify  # noqa: E402
from cora_tpu.solve import saddle as jax_saddle  # noqa: E402
from cora_tpu.solve import tnt as jax_tnt  # noqa: E402
from cora_tpu.types import Preconditioner as JaxPrecond  # noqa: E402
from cora_tpu.types import TNTParams as JaxTNTParams  # noqa: E402
from cora_tpu_torch.models.synthetic import synthetic_problem  # noqa: E402
from cora_tpu_torch.ops.tnt_kernels import PlainTNT  # noqa: E402
from cora_tpu_torch.solve import certify, saddle, tnt  # noqa: E402
from cora_tpu_torch.solve.tnt_kernel import (  # noqa: E402
    get_chain_plan,
    saddle_escape_tiles,
)
from cora_tpu_torch.types import Preconditioner, TNTParams  # noqa: E402

GRAPH = dict(n_poses=30, n_landmarks=2, n_ranges=20, dim=2, seed=5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problems():
    return jax_problem(**GRAPH), synthetic_problem(**GRAPH)


def _point(jp, rank, seed=4):
    jpd = jp.device_data(dtype=np.float64)
    A = np.random.default_rng(seed).uniform(-1.0, 1.0, (jpd.size, rank))
    return np.asarray(jr.project_to_manifold(jpd, jnp.asarray(A)))


def _critical_point(tp):
    """A float64 critical point at rank d: the port's float64 solve."""
    from cora_tpu_torch.solve.staircase import solve_cora
    from cora_tpu_torch.types import SolverConfig

    res = solve_cora(tp, config=SolverConfig(seed=0), device="cpu")
    assert res.certified
    return res.result.x.double().numpy()


def test_certify_rank_deficient_exit_matches_jax(problems):
    jp, tp = problems
    jpd = jp.device_data(dtype=np.float64)
    pd = tp.device_data(np.float64, "cpu")
    # a critical point with a zero column: singular values span > 1e6
    Y = _critical_point(tp)
    Yz = np.concatenate([Y, np.zeros((Y.shape[0], 1))], axis=1)
    # a non-critical rank-deficient point: no early exit
    Xz = np.concatenate([_point(jp, 2), np.zeros((Y.shape[0], 1))], axis=1)
    for Z in (Yz, Xz):
        for flag in (True, False):
            kw = dict(rank_deficient_exit=flag, method="host")
            got = certify.certify_solution(tp, pd, Z, 1e-5, **kw)
            ref = jax_certify.certify_solution(jp, jpd, Z, 1e-5, **kw)
            assert got.is_certified == ref.is_certified
            assert got.num_iters == ref.num_iters
            assert got.all_eigvecs.shape == ref.all_eigvecs.shape
            if flag and Z is Yz:  # the early exit, in both
                assert got.is_certified and got.theta == ref.theta == 0.0
                assert not got.all_eigvecs.any()
            else:
                np.testing.assert_allclose(got.theta, ref.theta, rtol=1e-6,
                                           atol=1e-9)


@pytest.mark.parametrize("alpha_min", [1e-6, 0.5])
def test_saddle_escape_alpha_min_matches_jax(problems, alpha_min):
    """α₀ = max(16·α_min, 100·tol/|θ|, 1): α_min = 0.5 raises the ladder's
    top step to 8."""
    jp, tp = problems
    jpd = jp.device_data(dtype=np.float64)
    Y = _point(jp, 2)
    cert = jax_certify.certify_solution(jp, jpd, Y, 1e-5, method="auto")
    assert not cert.is_certified and cert.theta < 0
    theta, v = cert.theta, cert.x / np.linalg.norm(cert.x)
    pd = tp.device_data(np.float64, "cpu")
    pre = tp.preconditioner_fn(Preconditioner.REGULARIZED_CHOLESKY,
                               np.float64, device="cpu")
    jpre = jp.preconditioner_fn(JaxPrecond.REGULARIZED_CHOLESKY,
                                dtype=np.float64)
    out = saddle.saddle_escape(pd, torch.as_tensor(Y.copy()), theta, v,
                               pre, alpha_min=alpha_min)
    want = np.asarray(jax_saddle.saddle_escape(
        jpd, jnp.asarray(Y), theta, v, jpre, alpha_min=alpha_min))
    assert np.abs(out.numpy() - want).max() <= 1e-10 * np.abs(want).max()


def test_saddle_escape_tiles_alpha_min_sets_the_top_step(problems,
                                                         monkeypatch):
    jp, tp = problems
    Y = torch.as_tensor(_point(jp, 2)).float()
    plan = get_chain_plan(tp, np.float32, "cpu")
    kern = PlainTNT(plan, tnt.HashableParams(TNTParams()))
    seen = []
    ladder = kern.ladder
    monkeypatch.setattr(kern, "ladder", lambda Y, Yd, al: seen.append(
        al.clone()) or ladder(Y, Yd, al))
    v = np.random.default_rng(0).standard_normal(Y.shape[0])
    for alpha_min in (1e-6, 0.5):
        saddle_escape_tiles(kern, Y, -1.0, v, alpha_min=alpha_min)
    assert float(seen[0][0]) == 1.0 and float(seen[1][0]) == 8.0
    assert float(seen[1][1]) == -8.0 and len(seen[1]) == 48


@pytest.mark.parametrize("caps", [dict(max_iterations_override=3),
                                  dict(max_tcg_override=2),
                                  dict(max_iterations_override=500,
                                       max_tcg_override=4)],
                         ids=["iterations", "tcg", "above_caps"])
def test_tnt_solve_overrides_match_jax(problems, caps):
    """The caps lower the parameters' (never raise them)."""
    jp, tp = problems
    params = dict(max_iterations=40, max_tcg_iterations=10)
    got, ref = _both_tnt(jp, tp, params, caps)
    assert got.num_iterations == ref.num_iterations
    assert got.status == ref.status
    np.testing.assert_array_equal(got.inner_iterations,
                                  np.asarray(ref.inner_iterations))
    np.testing.assert_allclose(got.objective_values,
                               np.asarray(ref.objective_values), rtol=1e-8)
    assert max(got.inner_iterations) <= min(
        caps.get("max_tcg_override") or 10, 10)
    if "max_iterations_override" in caps:
        assert got.num_iterations <= min(caps["max_iterations_override"], 40)


def test_tnt_solve_max_time_matches_jax(problems):
    """`max_time` replaces the per-level time cap: at 0 both stop with
    "time_cap" after the first chunk (CHUNK_ITERS iterations) of a solve
    whose tolerances never stop it."""
    jp, tp = problems
    params = dict(max_iterations=300, max_tcg_iterations=4,
                  gradient_tolerance=0.0,
                  preconditioned_gradient_tolerance=0.0,
                  relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
                  delta_tolerance=0.0)
    got, ref = _both_tnt(jp, tp, params, dict(max_time=0.0))
    assert got.status == ref.status == "time_cap"
    assert got.num_iterations == ref.num_iterations == tnt.CHUNK_ITERS
    np.testing.assert_allclose(got.objective_values[:8],
                               np.asarray(ref.objective_values)[:8],
                               rtol=1e-8)


def _both_tnt(jp, tp, params, caps):
    """(port, JAX) `tnt_solve` from one point with `caps`, in float64."""
    jpd = jp.device_data(dtype=np.float64)
    pd = tp.device_data(np.float64, "cpu")
    Y = _point(jp, 3)
    ref = jax_tnt.tnt_solve(
        jpd, jnp.asarray(Y), jp.preconditioner_fn(
            JaxPrecond.REGULARIZED_CHOLESKY, dtype=np.float64),
        JaxTNTParams(**params), **caps)
    with tnt.device_loop(graphs=False):
        got = tnt.tnt_solve(
            pd, torch.as_tensor(Y), tp.preconditioner_fn(
                Preconditioner.REGULARIZED_CHOLESKY, np.float64,
                device="cpu"), TNTParams(**params), **caps)
    return got, ref
