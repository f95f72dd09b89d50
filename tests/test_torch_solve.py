"""The slice as a whole: the port's `solve_cora` against the JAX package's,
on the CPU, from the same numpy-made start.

Both packages project the shared start onto the manifold themselves. Their
ramp-lift columns come from different random streams (jax.random against
torch.Generator), so the ranks they visit may differ; the end states may
not:
  * `certified` equal;
  * `sdp_cost` and the final f to rtol 1e-4 (float32 staircases that
    reach the same certified optimum through different rounding);
  * ATE to 1e-3 m.
The first TNT level starts from the same projected point in both, so its
first chunk (8 iterations) follows the same trajectory: f and ‖grad‖ per
iteration to rtol 1e-4 and 1e-3, as `chip_smoke.py` holds the card's first
level against the JAX fixture at full size.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cora_tpu.models.synthetic import synthetic_problem as jax_problem  # noqa: E402
from cora_tpu.solve.certify import certify_solution as jax_certify  # noqa: E402
from cora_tpu.solve import staircase as jax_staircase  # noqa: E402
from cora_tpu.solve.polish import _jax_polish_kernels  # noqa: E402
from cora_tpu.solve.polish import polish_solution as jax_polish  # noqa: E402
from cora_tpu.solve.staircase import extract_solution as jax_extract  # noqa: E402
from cora_tpu.solve.staircase import solve_cora as jax_solve  # noqa: E402
from cora_tpu.types import SolverConfig as JaxConfig  # noqa: E402
from cora_tpu.types import TNTParams as JaxTNTParams  # noqa: E402
from cora_tpu.utils.evaluation import evaluate_ate as jax_ate  # noqa: E402
from cora_tpu_torch.models.synthetic import synthetic_problem  # noqa: E402
from cora_tpu_torch.ops.riemannian import project_to_manifold  # noqa: E402
from cora_tpu_torch.solve import staircase  # noqa: E402
from cora_tpu_torch.solve.certify import certify_solution  # noqa: E402
from cora_tpu_torch.solve.polish import ALPHAS, probe_ladder  # noqa: E402
from cora_tpu_torch.solve.staircase import extract_solution, solve_cora  # noqa: E402
from cora_tpu_torch.types import SolverConfig, TNTParams  # noqa: E402
from cora_tpu_torch.utils.evaluation import evaluate_ate  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_2D = dict(n_poses=14, n_landmarks=2, n_ranges=10, dim=2, seed=3)
SMALL_3D = dict(n_poses=16, n_landmarks=2, n_ranges=12, dim=3, seed=3)
# the test_pallas_tcg.py end-to-end config, with the wall-clock caps
# raised so that machine speed cannot change the outcome
BASE = dict(dtype=np.float32, max_staircase_iterations=40, seed=0,
            polish_time_budget=120.0)
FIRST_CHUNK = 8  # iterations of the first TNT level compared step by step


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x0(n_rows, rank, seed=4):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (n_rows, rank))


def _record_levels(monkeypatch, module, name):
    """Wrap `module.name` (a TNT solve) to keep its results in call order."""
    levels = []
    solve = getattr(module, name)

    def recording(*args, **kwargs):
        levels.append(solve(*args, **kwargs))
        return levels[-1]

    monkeypatch.setattr(module, name, recording)
    return levels


def _jax_solve(g, use_pallas):
    problem = jax_problem(**g)
    cfg = JaxConfig(use_pallas=use_pallas,
                    tnt=JaxTNTParams(max_computation_time=600.0), **BASE)
    res = jax_solve(problem, x0=_x0(problem.data_matrix_size, g["dim"]),
                    config=cfg)
    return res, float(jax_ate(problem, jax_extract(problem, cfg, res)))


def _port_solve(g):
    problem = synthetic_problem(**g)
    cfg = SolverConfig(use_kernels="never",
                       tnt=TNTParams(max_computation_time=600.0), **BASE)
    res = solve_cora(problem, x0=_x0(problem.data_matrix_size, g["dim"]),
                     config=cfg, device="cpu")
    return res, float(evaluate_ate(problem, extract_solution(problem, cfg,
                                                             res)))


def _assert_same_end(port, ref):
    (res, ate), (ref_res, ref_ate) = port, ref
    assert res.certified == ref_res.certified
    np.testing.assert_allclose(res.sdp_cost, ref_res.sdp_cost, rtol=1e-4)
    np.testing.assert_allclose(res.result.f, ref_res.result.f, rtol=1e-4)
    assert abs(ate - ref_ate) <= 1e-3
    assert np.isfinite(res.grad_norm_f64)
    assert torch.isfinite(res.result.x).all()


@pytest.mark.parametrize("g", [SMALL_2D, SMALL_3D], ids=["2d", "3d"])
def test_solve_cora_matches_jax(g, monkeypatch):
    levels = _record_levels(monkeypatch, staircase, "tnt_solve_tiles")
    ref_levels = _record_levels(monkeypatch, jax_staircase, "tnt_solve")
    port = _port_solve(g)
    assert port[0].certified
    _assert_same_end(port, _jax_solve(g, "never"))
    first, ref = levels[0], ref_levels[0]
    assert first.num_iterations >= FIRST_CHUNK
    np.testing.assert_allclose(first.objective_values[:FIRST_CHUNK],
                               ref.objective_values[:FIRST_CHUNK], rtol=1e-4)
    np.testing.assert_allclose(first.gradient_norms[:FIRST_CHUNK],
                               ref.gradient_norms[:FIRST_CHUNK], rtol=1e-3)


def test_solve_cora_matches_jax_kernel_path():
    """The JAX package's Pallas path (interpreter mode) at the smallest
    size reaches the same end state as the port's plain path."""
    _assert_same_end(_port_solve(SMALL_2D), _jax_solve(SMALL_2D, "always"))


@pytest.mark.parametrize("g", [SMALL_2D, SMALL_3D], ids=["2d", "3d"])
def test_polish_ladder_matches_jax(g):
    """The polish's batched Armijo ladder: every trial state and its f
    against the JAX package's `probe_ladder`, to 1e-12 in float64."""
    jp = jax_problem(**g)
    jax_ladder = _jax_polish_kernels(jp, 1e6)[3]
    pd = synthetic_problem(**g).device_data(np.float64, "cpu")
    Y = project_to_manifold(pd, torch.as_tensor(
        _x0(jp.data_matrix_size, g["dim"] + 1)))
    s = torch.as_tensor(np.random.default_rng(5).standard_normal(Y.shape))
    Yb, f = probe_ladder(pd, Y, s, ALPHAS)
    ref_Yb, ref_f = jax_ladder(jnp.asarray(Y.numpy()), jnp.asarray(s.numpy()),
                               jnp.asarray(ALPHAS))
    ref_Yb, ref_f = np.asarray(ref_Yb), np.asarray(ref_f)
    assert Yb.shape == ref_Yb.shape
    assert np.abs(Yb.numpy() - ref_Yb).max() < 1e-12 * np.abs(ref_Yb).max()
    np.testing.assert_allclose(f, ref_f, rtol=1e-12)


def test_certify_host_matches_jax():
    """The banded/Lanczos host certificate (N > 100) decides alike."""
    g = dict(n_poses=37, n_landmarks=3, n_ranges=29, dim=2, seed=1)
    jp, tp = jax_problem(**g), synthetic_problem(**g)
    jpd = jp.device_data(dtype=np.float64)
    Y = _x0(jp.data_matrix_size, 3)
    Yp = jax_polish(jp, jpd, Y, time_budget=120.0).Y
    assert np.isfinite(Yp).all()
    for eta in (1e-4, 1e3):
        ref = jax_certify(jp, jpd, Yp, eta, method="host")
        got = certify_solution(
            tp, tp.device_data(dtype=np.float64, device="cpu"), Yp, eta)
        assert got.is_certified == ref.is_certified
        if not ref.is_certified:
            np.testing.assert_allclose(got.theta, ref.theta, rtol=1e-6)


def test_use_kernels_always_raises_on_cpu():
    problem = synthetic_problem(**SMALL_2D)
    cfg = SolverConfig(use_kernels="always", **BASE)
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_cora(problem, config=cfg, device="cpu")


def test_chip_smoke_fails_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
