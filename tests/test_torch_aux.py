"""The port's solve surroundings against the JAX package, on the CPU:
checkpoint / resume, solution export, MatrixMarket, the native PyFG
tokenizer, the experiment entry point, visualization, and the device
default of the `Problem` entry points.

  * checkpoints: the same fingerprint as `cora_tpu`'s, a file written by
    either package loads in the other, a save leaves nothing but the file,
    a resumed solve certifies, resumes at the checkpoint's (width, rank)
    as the JAX package does, and refuses another problem's checkpoint;
  * TUM and g2o exports byte-identical to the JAX package's for the same
    solution (2D, 3D, one robot and several);
  * MatrixMarket: a round trip, readable by the JAX package's reader;
  * the native tokenizer: the same data matrix and ground truth as the
    Python parser and the JAX package's, on every record type; the Python
    fallback when no compiler builds it;
  * `experiments.run_one`: the result line with `marginalized: 1` and the
    TUM files; `main` exits non-zero after a failed run;
  * viz: every plot writes its file; implicit iterates are lifted and
    aligned as the JAX package does (1e-8);
  * the JAX package's remaining public names: `profiler_trace` and
    `named_scope` (a trace written, the scope in it), `evaluate_objective`,
    `euclidean_gradient`, `make_certificate_operator` and the polish's
    host `hessian_vector_product` (1e-12), `stiefel_random` and
    `oblique_random` (shape and manifold membership, not the jax.random
    stream), `get_robot_pose_chains` (equal), `contract` and `rowdot`
    (1e-14).
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from cora_tpu.io.exporters import save_solution as jax_save_solution  # noqa: E402
from cora_tpu.io.matrix_market import read_matrix_market as jax_read_mm  # noqa: E402
from cora_tpu.io.pyfg import parse_pyfg_python as jax_parse  # noqa: E402
from cora_tpu.models.synthetic import synthetic_problem as jax_synthetic  # noqa: E402
from cora_tpu.solve import checkpoint as jax_ckpt  # noqa: E402
from cora_tpu.solve import staircase as jax_staircase  # noqa: E402
from cora_tpu.types import Formulation as JaxFormulation  # noqa: E402
from cora_tpu.types import SolverConfig as JaxConfig  # noqa: E402
from cora_tpu.types import TNTParams as JaxTNTParams  # noqa: E402
from cora_tpu_torch import experiments, native  # noqa: E402
from cora_tpu_torch.graph.data import build_problem_data  # noqa: E402
from cora_tpu_torch.io import matrix_market as mm  # noqa: E402
from cora_tpu_torch.io.exporters import save_solution  # noqa: E402
from cora_tpu_torch.io.pyfg import parse_pyfg, parse_pyfg_python  # noqa: E402
from cora_tpu_torch.models.synthetic import synthetic_problem  # noqa: E402
from cora_tpu_torch.native import pyfg_fast  # noqa: E402
from cora_tpu_torch.solve import checkpoint as ckpt_mod  # noqa: E402
from cora_tpu_torch.solve import staircase  # noqa: E402
from cora_tpu_torch.types import Formulation, Preconditioner  # noqa: E402
from cora_tpu_torch.types import SolverConfig, TNTParams  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
from torch_port_reference import multi_robot_pyfg  # noqa: E402

CHAIN = dict(n_poses=40, n_landmarks=2, n_ranges=30, dim=2, seed=3)
TINY = dict(n_poses=14, n_landmarks=2, n_ranges=10, dim=2, seed=3)
MULTI = {
    "multi2d": dict(n_robots=3, poses_per_robot=12, n_inter_ranges=30,
                    n_landmarks=2, n_landmark_ranges=12, n_loop_closures=2,
                    dim=2, seed=0),
    "multi3d": dict(n_robots=2, poses_per_robot=10, n_inter_ranges=16,
                    n_landmarks=2, n_landmark_ranges=10, n_loop_closures=2,
                    dim=3, seed=1),
}
# priors and pose→landmark edges, which `multi_robot_pyfg` does not write
EXTRA = {
    2: ["VERTEX_SE2:PRIOR 0.0 A0 0.1 -0.2 0.3 0.01 0 0 0.01 0 0.001",
        "VERTEX_XY:PRIOR 0.0 L0 1.5 2.5 0.04 0.001 0.04",
        "EDGE_SE2_XY 1.0 A1 L1 3.25 -1.75 0.02 0 0.02"],
    3: ["VERTEX_SE3:QUAT:PRIOR 0.0 A0 0.1 -0.2 0.3 0 0 0.0998 0.995 "
        + " ".join(["0.01", "0", "0", "0", "0", "0", "0.01", "0", "0", "0",
                    "0", "0.01", "0", "0", "0", "0.001", "0", "0", "0.001",
                    "0", "0.001"]),
        "VERTEX_XYZ:PRIOR 0.0 L0 1.5 2.5 -0.5 0.04 0 0 0.04 0 0.04",
        "EDGE_SE3_XYZ 1.0 A1 L1 3.25 -1.75 0.5 0.02 0 0 0.02 0 0.02"],
}
# the end-to-end config of tests/test_torch_solve.py, in float64
BASE = dict(dtype=np.float64, max_staircase_iterations=40, seed=0,
            polish_time_budget=120.0)
HAS_CXX = shutil.which(os.environ.get("CXX", "g++")) is not None


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pyfg_files(tmp_path_factory):
    """name → a multi-robot PyFG file with every record type."""
    out = {}
    for name, g in MULTI.items():
        out[name] = str(tmp_path_factory.mktemp("pyfg") / f"{name}.pyfg")
        with open(out[name], "w") as fh:
            fh.write(multi_robot_pyfg(**g) + "\n".join(EXTRA[g["dim"]])
                     + "\n")
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _config(**kw):
    """(JAX config, port config) of the small end-to-end solves."""
    fields = dict(BASE, **kw)
    return (JaxConfig(use_pallas="never",
                      tnt=JaxTNTParams(max_computation_time=600.0), **fields),
            SolverConfig(tnt=TNTParams(max_computation_time=600.0), **fields))


# ---------------------------------------------------------------- checkpoint


@pytest.mark.parametrize("name", ["chain", "multi2d", "multi3d"])
def test_fingerprint_matches_jax(pyfg_files, name):
    if name == "chain":
        jp, tp = jax_synthetic(**CHAIN), synthetic_problem(**CHAIN)
    else:
        jp, tp = jax_parse(pyfg_files[name]), parse_pyfg(pyfg_files[name])
    fp = ckpt_mod.problem_fingerprint(tp)
    assert fp == jax_ckpt.problem_fingerprint(jp)
    assert len(fp) == 16


def _checkpoint(mod, with_eigvecs):
    rng = np.random.default_rng(5)
    return mod.StaircaseCheckpoint(
        Y=rng.standard_normal((20, 4)), rank=5, ranks_visited=[3, 4, 4],
        eigvec_bootstrap=rng.standard_normal((20, 10)) if with_eigvecs
        else None, fingerprint="0123456789abcdef")


@pytest.mark.parametrize("with_eigvecs", [True, False],
                         ids=["eigvecs", "no-eigvecs"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_loads_across_packages(tmp_path, writer, with_eigvecs):
    mods = {"port": ckpt_mod, "jax": jax_ckpt}
    reader = mods["jax" if writer == "port" else "port"]
    path = str(tmp_path / "c.npz")
    saved = _checkpoint(mods[writer], with_eigvecs)
    saved.save(path)
    got = reader.StaircaseCheckpoint.load(path)
    np.testing.assert_array_equal(got.Y, saved.Y)
    assert (got.rank, got.ranks_visited, got.fingerprint, got.stage) == \
        (5, [3, 4, 4], "0123456789abcdef", "staircase")
    if with_eigvecs:
        np.testing.assert_array_equal(got.eigvec_bootstrap,
                                      saved.eigvec_bootstrap)
    else:
        assert got.eigvec_bootstrap is None


def test_checkpoint_save_leaves_no_stray_file(tmp_path):
    path = str(tmp_path / "c.npz")
    for _ in range(2):  # a first save and an overwrite
        _checkpoint(ckpt_mod, True).save(path)
        assert os.listdir(tmp_path) == ["c.npz"]


@pytest.mark.parametrize("formulation", [Formulation.EXPLICIT,
                                         Formulation.IMPLICIT],
                         ids=["explicit", "implicit"])
def test_resume_certifies(tmp_path, formulation):
    """A solve from rank d fails its first certificate and leaves a
    checkpoint of its state (no translation rows when implicit); a second
    call resumes from it and certifies within 1 % of the first."""
    tp = synthetic_problem(**CHAIN)
    _, cfg = _config(formulation=formulation)
    x0 = np.random.default_rng(4).uniform(-1, 1, (tp.data_matrix_size, 2))
    path = str(tmp_path / "ckpt.npz")
    whole = staircase.solve_cora(tp, x0=x0, config=cfg, device="cpu",
                                 checkpoint_path=path)
    assert os.listdir(tmp_path) == ["ckpt.npz"]
    saved = ckpt_mod.StaircaseCheckpoint.load(path)
    assert saved.fingerprint == ckpt_mod.problem_fingerprint(tp)
    assert saved.Y.shape[0] == (tp.rot_and_range_matrix_size
                                if formulation == Formulation.IMPLICIT
                                else tp.data_matrix_size)
    resumed = staircase.solve_cora(tp, config=cfg, device="cpu",
                                   checkpoint_path=path)
    k = len(saved.ranks_visited)
    assert resumed.ranks_visited[:k + 1] == saved.ranks_visited + [saved.rank]
    assert whole.certified and resumed.certified
    np.testing.assert_allclose(resumed.result.f, whole.result.f, rtol=1e-2)


def test_resume_width_matches_jax(tmp_path):
    """A checkpoint saved at a ramp lift holds the pre-lift Y (width r) with
    rank r + 1: both packages run the resumed first level at width r and
    record r + 1."""
    jp, tp = jax_synthetic(**TINY), synthetic_problem(**TINY)
    jcfg, cfg = _config()
    Y = np.random.default_rng(4).uniform(-1, 1, (tp.data_matrix_size, 3))
    path = str(tmp_path / "lift.npz")
    ckpt_mod.StaircaseCheckpoint(
        Y=Y, rank=4, ranks_visited=[3], eigvec_bootstrap=None,
        fingerprint=ckpt_mod.problem_fingerprint(tp)).save(path)
    widths = {}
    for name, module, problem, config in (
            ("jax", jax_staircase, jp, jcfg), ("port", staircase, tp, cfg)):
        levels = []
        solve = module.tnt_solve

        def recording(*args, _solve=solve, _levels=levels, **kwargs):
            _levels.append(_solve(*args, **kwargs))
            return _levels[-1]

        module.tnt_solve = recording
        try:
            kw = {} if name == "jax" else {"device": "cpu"}
            res = module.solve_cora(problem, config=config,
                                    checkpoint_path=path, **kw)
        finally:
            module.tnt_solve = solve
        widths[name] = (np.shape(levels[0].x)[1], res.ranks_visited[:2])
    assert widths["port"] == widths["jax"] == (3, [3, 4])


def test_checkpoint_of_another_problem_raises(tmp_path):
    path = str(tmp_path / "c.npz")
    other = synthetic_problem(**TINY)
    ckpt_mod.StaircaseCheckpoint(
        Y=np.zeros((other.data_matrix_size, 2)), rank=2, ranks_visited=[],
        eigvec_bootstrap=None,
        fingerprint=ckpt_mod.problem_fingerprint(other)).save(path)
    tp = synthetic_problem(**CHAIN)
    with pytest.raises(ValueError, match="different problem"):
        staircase.solve_cora(tp, config=_config()[1], device="cpu",
                             checkpoint_path=path)


# ------------------------------------------------------------------- export


def _solution(problem, seed=0):
    """A rank-d state whose rotation blocks are rotations."""
    d = problem.dim
    rng = np.random.default_rng(seed)
    soln = rng.standard_normal((problem.data_matrix_size, d)) * 10.0
    U, _, Vt = np.linalg.svd(rng.standard_normal((problem.num_poses, d, d)))
    R = U @ Vt
    R[np.linalg.det(R) < 0, :, 0] *= -1
    soln[:problem.num_poses * d] = R.reshape(-1, d)
    return soln


@pytest.mark.parametrize("fmt", ["tum", "g2o"])
@pytest.mark.parametrize("name", ["chain2d", "chain3d", "multi2d",
                                  "multi3d"])
def test_exports_byte_identical_to_jax(pyfg_files, tmp_path, name, fmt):
    if name.startswith("chain"):
        g = dict(CHAIN, dim=int(name[-2]))
        jp, tp = jax_synthetic(**g), synthetic_problem(**g)
    else:
        jp, tp = jax_parse(pyfg_files[name]), parse_pyfg(pyfg_files[name])
    soln = _solution(tp)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_save_solution(jp, soln, str(tmp_path / "jax" / f"x.{fmt}"), fmt=fmt)
    save_solution(tp, soln, str(tmp_path / "port" / f"x.{fmt}"), fmt=fmt)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port"))
    assert len(files) == len(tp.robot_chars())
    for f in files:
        port = (tmp_path / "port" / f).read_bytes()
        assert port == (tmp_path / "jax" / f).read_bytes()
        assert len(port.splitlines()) == len(tp.pose_symbols(f[-1])
                                             if len(files) > 1
                                             else tp.pose_symbols())


def test_matrix_market_round_trip(tmp_path):
    Q = synthetic_problem(**CHAIN).data_matrix()
    path = str(tmp_path / "Q.mtx")
    mm.write_matrix_market(Q, path)
    back = mm.read_matrix_market(path)
    assert back.format == "csr" and back.shape == Q.shape
    assert _rel(back.toarray(), Q.toarray()) < 1e-15
    assert (jax_read_mm(path) != back).nnz == 0
    dense = mm.read_matrix_market_dense(path)
    np.testing.assert_array_equal(dense, back.toarray())


# ------------------------------------------------------------------- native


@pytest.mark.skipif(not HAS_CXX, reason="no C++ compiler (g++ or $CXX) "
                    "found: the native PyFG tokenizer cannot be built")
@pytest.mark.parametrize("name", list(MULTI))
def test_native_parse_matches_python_and_jax(pyfg_files, name):
    path = pyfg_files[name]
    native_p = pyfg_fast.parse_pyfg_native(path)
    python_p = parse_pyfg_python(path)
    jax_p = jax_parse(path)
    assert native_p.num_poses == python_p.num_poses
    assert len(native_p.pose_priors) == len(native_p.landmark_priors) == 1
    assert len(native_p.rel_pose_landmark_measurements) == 1
    Q = native_p.data_matrix()
    assert (Q != python_p.data_matrix()).nnz == 0
    assert (Q != jax_p.data_matrix()).nnz == 0
    for sym, (R, t) in python_p.pose_gt.items():
        np.testing.assert_array_equal(native_p.pose_gt[sym][0], R)
        np.testing.assert_array_equal(native_p.pose_gt[sym][1], t)
    # `parse_pyfg` takes the native path by default
    assert (parse_pyfg(path).data_matrix() != Q).nnz == 0


def test_parse_falls_back_without_a_compiler(pyfg_files, tmp_path,
                                             monkeypatch):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(pyfg_fast, "_LIB", None)
    path = pyfg_files["multi2d"]
    with pytest.raises(native.NativeBuildError):
        pyfg_fast.parse_pyfg_native(path)
    assert (parse_pyfg(path).data_matrix()
            != parse_pyfg_python(path).data_matrix()).nnz == 0
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").glob("*.so"))


# -------------------------------------------------------------- experiments


def test_run_one_implicit_prints_and_exports(tmp_path, capsys):
    path = str(tmp_path / "multi2d.pyfg")  # no prior: every pose has GT
    with open(path, "w") as fh:
        fh.write(multi_robot_pyfg(**MULTI["multi2d"]))
    cfg = dict(experiments.load_config(None), formulation="implicit",
               init_type="odom", init_rank_jump=1, output_dir=str(tmp_path))
    res, elapsed, ate = experiments.run_one(path, cfg, device="cpu")
    line = capsys.readouterr().out
    assert "Experiment result, name: multi2d, " in line
    assert "marginalized: 1" in line and "t_cert: " in line
    assert res.result.x.shape[0] == 3 * 12 * 2 + 30 + 12  # rot + bearings
    assert np.isfinite(res.result.f) and np.isfinite(ate) and elapsed > 0
    for c in "ABC":
        rows = np.loadtxt(tmp_path / f"multi2d.tum.{c}")
        assert rows.shape == (12, 8)


def test_main_reports_a_failure_and_exits_nonzero(tmp_path, capsys):
    cfg = tmp_path / "config.json"
    cfg.write_text('{"output_dir": "%s"}' % (tmp_path / "out"))
    rc = experiments.main(["--dataset", str(tmp_path / "missing.pyfg"),
                           "--config", str(cfg), "--device", "cpu"])
    assert rc != 0
    assert "Experiment FAILED, name: missing, error: FileNotFoundError" in \
        capsys.readouterr().out


def test_sweep_grid():
    grid = experiments.sweep_grid(experiments.load_config(None))
    assert len(grid) == 12
    assert {(g["formulation"], g["init_type"], g["init_rank_jump"])
            for g in grid} == {(f, i, j) for f in ("explicit", "implicit")
                               for i in ("random", "odom") for j in (0, 1, 2)}


# --------------------------------------------------------------------- viz


@pytest.fixture(scope="module")
def logged_solve():
    """An implicit float64 solve of a small chain with its iterate log."""
    pytest.importorskip("matplotlib")
    tp = synthetic_problem(**TINY)
    cfg = SolverConfig(formulation=Formulation.IMPLICIT, log_iterates=True,
                       **dict(BASE, init_rank_jump=1))
    res = staircase.solve_cora(tp, config=cfg, device="cpu")
    return tp, cfg, res


def test_viz_plots_write_files(logged_solve, tmp_path):
    from cora_tpu_torch.io import viz

    tp, cfg, res = logged_solve
    soln = staircase.extract_solution(tp, cfg, res)
    viz.plot_solution(tp, soln, str(tmp_path / "soln.png"), show_gt=True)
    viz.plot_range_calibration(tp, str(tmp_path / "calib.png"))
    viz.animate_iterates(tp, res.result.iterates, str(tmp_path / "s.gif"),
                         cfg, max_frames=4)
    for f in ("soln.png", "calib.png", "s.gif"):
        assert (tmp_path / f).stat().st_size > 1000
    n = viz.play_iterates(tp, res.result.iterates, config=cfg, max_frames=5,
                          block=False)
    assert n == min(5, len(res.result.iterates))


def test_project_and_align_implicit_iterates_match_jax(logged_solve):
    from cora_tpu.io.viz import project_and_align_iterates as jax_align

    from cora_tpu_torch.io.viz import project_and_align_iterates

    tp, cfg, res = logged_solve
    its = res.result.iterates
    assert its and its[0].shape[0] == tp.rot_and_range_matrix_size
    picked = [its[0], its[len(its) // 2], its[-1]]
    aligned = project_and_align_iterates(tp, picked, cfg)
    ref = jax_align(jax_synthetic(**TINY), picked, JaxConfig(
        formulation=JaxFormulation.IMPLICIT, dtype=np.float64))
    d = tp.dim
    for Y, R in zip(aligned, ref):
        assert Y.shape == (tp.data_matrix_size, d)
        np.testing.assert_allclose(Y[:d, :d], np.eye(d), atol=1e-5)
        assert _rel(Y, R) < 1e-8


# ---------------------------------------------------------- device default


@pytest.mark.parametrize("entry", ["device_data", "operator",
                                   "preconditioner_fn", "build_problem_data"])
def test_problem_entry_points_default_to_the_card(entry, monkeypatch):
    """Called without a device, each entry point asks for the card and,
    with none there, raises before any work; `device="cpu"` runs here."""
    tp = synthetic_problem(**TINY)
    call = {
        "device_data": lambda **kw: tp.device_data(np.float64, **kw),
        "operator": lambda **kw: tp.operator(Formulation.IMPLICIT,
                                             np.float64, **kw),
        "preconditioner_fn": lambda **kw: tp.preconditioner_fn(
            Preconditioner.REGULARIZED_CHOLESKY, np.float64, **kw),
        "build_problem_data": lambda **kw: build_problem_data(tp, **kw),
    }[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert call(device="cpu") is not None


# ------------------------------------------------- public names of the JAX


def _multi_point(pyfg_files, rank=4):
    """(JAX problem, port problem, JAX float64 data, port float64 data,
    a projected point Y, a direction V) on the 2D multi-robot graph."""
    from cora_tpu.ops import riemannian as jr

    jp, tp = jax_parse(pyfg_files["multi2d"]), parse_pyfg(pyfg_files["multi2d"])
    jpd = jp.device_data(dtype=np.float64)
    rng = np.random.default_rng(11)
    Y = np.asarray(jr.project_to_manifold(jpd, jax.numpy.asarray(
        rng.uniform(-1.0, 1.0, (jp.data_matrix_size, rank)))))
    V = rng.standard_normal(Y.shape)
    return jp, tp, jpd, tp.device_data(np.float64, "cpu"), Y, V


def test_profiler_trace_and_named_scope_match_jax(tmp_path):
    """Both packages write a trace under `logdir`; the port's Chrome trace
    holds the named scope."""
    from cora_tpu.utils.timing import named_scope as jax_scope
    from cora_tpu.utils.timing import profiler_trace as jax_trace

    from cora_tpu_torch.utils.timing import named_scope, profiler_trace

    with jax_trace(str(tmp_path / "jax")):
        with jax_scope("cora/probe"):
            jax.numpy.ones(8).sum().block_until_ready()
    assert any(files for _, _, files in os.walk(tmp_path / "jax"))
    with profiler_trace(str(tmp_path / "port")) as prof:
        with named_scope("cora/probe"):
            torch.ones(8).sum()
    with open(tmp_path / "port" / "trace.json") as fh:
        assert "cora/probe" in fh.read()
    assert any(e.key == "cora/probe" for e in prof.key_averages())


def test_objective_and_euclidean_gradient_match_jax(pyfg_files):
    from cora_tpu.ops import quadratic as jq

    from cora_tpu_torch.ops import quadratic as tq

    _, _, jpd, pd, Y, _ = _multi_point(pyfg_files)
    f = tq.evaluate_objective(pd, torch.as_tensor(Y))
    assert f.shape == () and _rel(f, jq.evaluate_objective(jpd, Y)) < 1e-12
    g = tq.euclidean_gradient(pd, torch.as_tensor(Y))
    assert _rel(g, jq.euclidean_gradient(jpd, Y)) < 1e-12


def test_certificate_operator_matches_jax(pyfg_files):
    from cora_tpu.solve.certify import make_certificate_operator as jax_make

    from cora_tpu_torch.solve.certify import make_certificate_operator

    _, _, jpd, pd, Y, V = _multi_point(pyfg_files)
    jS, (jL, jl) = jax_make(jpd, jax.numpy.asarray(Y))
    S, (L, lam) = make_certificate_operator(pd, torch.as_tensor(Y))
    assert _rel(L, jL) < 1e-12 and _rel(lam, jl) < 1e-12
    assert _rel(S(torch.as_tensor(V)), jS(jax.numpy.asarray(V))) < 1e-12


def test_polish_hessian_vector_product_matches_jax(pyfg_files):
    from cora_tpu.solve.polish import hessian_vector_product as jax_hvp

    from cora_tpu_torch.solve.polish import hessian_vector_product

    jp, tp, jpd, pd, Y, V = _multi_point(pyfg_files)
    Q = tp.data_matrix()
    nablaF = Q @ Y
    ref = jax_hvp(jpd, jp.data_matrix(), Y, nablaF, V)
    out = hessian_vector_product(pd, Q, Y, nablaF, V)
    assert out.dtype == np.float64 and out.shape == Y.shape
    assert _rel(out, ref) < 1e-12
    # tensors in, the same array out
    same = hessian_vector_product(pd, Q, torch.as_tensor(Y),
                                  torch.as_tensor(nablaF),
                                  torch.as_tensor(V))
    np.testing.assert_array_equal(same, out)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("d", [2, 3])
def test_random_manifold_points(d, dtype):
    """Shapes and membership, as the JAX package's samples have them; one
    seed gives the same points (the streams differ from jax.random)."""
    from cora_tpu.ops import manifolds as jm

    from cora_tpu_torch.ops import manifolds as tm

    tol = 1e-12 if dtype == torch.float64 else 1e-5
    n, m, r = 7, 5, d + 2
    key = jax.random.PRNGKey(0)
    A = tm.stiefel_random(torch.Generator().manual_seed(3), n, d, r, dtype)
    B = np.asarray(jm.stiefel_random(key, n, d, r))
    assert A.shape == B.shape == (n, d, r) and A.dtype == dtype
    A = A.double()
    assert (A @ A.transpose(-1, -2) - torch.eye(d, dtype=A.dtype)).abs() \
        .max() < tol
    assert np.abs(B @ np.swapaxes(B, -1, -2) - np.eye(d)).max() < 1e-12
    S = tm.oblique_random(torch.Generator().manual_seed(3), m, r, dtype)
    J = np.asarray(jm.oblique_random(key, m, r))
    assert S.shape == J.shape == (m, r) and S.dtype == dtype
    assert (S.double().norm(dim=1) - 1).abs().max() < tol
    assert np.abs(np.linalg.norm(J, axis=1) - 1).max() < 1e-12
    again = tm.stiefel_random(torch.Generator().manual_seed(3), n, d, r,
                              dtype)
    assert torch.equal(again, tm.stiefel_random(
        torch.Generator().manual_seed(3), n, d, r, dtype))


@pytest.mark.parametrize("name", ["chain", "multi2d", "multi3d"])
def test_robot_pose_chains_match_jax(pyfg_files, name):
    from cora_tpu.models.init import get_robot_pose_chains as jax_chains

    from cora_tpu_torch.models.init import get_robot_pose_chains

    if name == "chain":
        jp, tp = jax_synthetic(**CHAIN), synthetic_problem(**CHAIN)
    else:
        jp, tp = jax_parse(pyfg_files[name]), parse_pyfg(pyfg_files[name])
    got = [[(s.chr, s.index) for s in c] for c in get_robot_pose_chains(tp)]
    want = [[(s.chr, s.index) for s in c] for c in jax_chains(jp)]
    assert got == want and len(got) >= 1
    assert all(c == sorted(c) for c in got)


def test_contract_and_rowdot_match_jax():
    from cora_tpu.ops import linalg as jl

    from cora_tpu_torch.ops import linalg as tl

    rng = np.random.default_rng(2)
    a, b = rng.standard_normal((2, 6, 5))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    assert _rel(tl.contract(ta, tb), jl.contract(a, b)) < 1e-14
    assert tl.rowdot(ta, tb).shape == (6,)
    assert _rel(tl.rowdot(ta, tb), jl.rowdot(a, b)) < 1e-14
