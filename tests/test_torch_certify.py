"""The certificate's device stage against the JAX package, on the CPU.

  * `lobpcg_min` on the analytic cases of tests/test_solve.py (I − s·xxᵀ,
    s = 1, 2): the minimum eigenvalue to 1e-6, the eigenvector aligned with
    x to 1 − 1e-6 where it is unique, and both against JAX's `lobpcg_min`
    from the same start block;
  * `certify_solution(method="auto" | "device")` in float64 at a point whose
    certificate is not PSD, on a chain graph and on a multi-robot graph: the
    same verdict, θ to 1e-6 relative, |⟨x_port, x_jax⟩| ≥ 1 − 1e-4 (both
    start LOBPCG from the same `np.random.default_rng(seed)` block);
  * the staircase certifies with `method="auto"`, as the JAX package's
    does, and its saddle escape starts along the device LOBPCG's
    eigenvector.
"""

import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cora_tpu.io.pyfg import parse_pyfg_python as jax_parse  # noqa: E402
from cora_tpu.models.synthetic import synthetic_problem as jax_synthetic  # noqa: E402
from cora_tpu.ops.lobpcg import lobpcg_min as jax_lobpcg  # noqa: E402
from cora_tpu.ops.riemannian import project_to_manifold  # noqa: E402
from cora_tpu.solve import certify as jax_certify_module  # noqa: E402
from cora_tpu_torch.io.pyfg import parse_pyfg  # noqa: E402
from cora_tpu_torch.models.synthetic import synthetic_problem  # noqa: E402
from cora_tpu_torch.ops.lobpcg import lobpcg_min  # noqa: E402
from cora_tpu_torch.solve import certify, staircase  # noqa: E402
from cora_tpu_torch.types import SolverConfig, TNTParams  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
from torch_port_reference import multi_robot_pyfg  # noqa: E402

# N > 100, so the certificate is not the dense one
CHAIN = dict(n_poses=37, n_landmarks=3, n_ranges=29, dim=2, seed=1)
MULTI_ROBOT = dict(n_robots=3, poses_per_robot=12, n_inter_ranges=30,
                   n_landmarks=2, n_landmark_ranges=12, n_loop_closures=2,
                   dim=2, seed=0)
BASE = dict(dtype=np.float32, max_staircase_iterations=40, seed=0,
            polish_time_budget=120.0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """name → (JAX problem, port problem)."""
    path = tmp_path_factory.mktemp("pyfg") / "multi_robot.pyfg"
    path.write_text(multi_robot_pyfg(**MULTI_ROBOT))
    return {"chain": (jax_synthetic(**CHAIN), synthetic_problem(**CHAIN)),
            "multi_robot": (jax_parse(str(path)), parse_pyfg(str(path)))}


@pytest.mark.parametrize("scale,expected", [(1.0, 0.0), (2.0, -1.0)])
@pytest.mark.parametrize("n", [10, 1000])
def test_lobpcg_min_known_eigenpairs(n, scale, expected):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n)
    x /= np.linalg.norm(x)
    X0 = rng.standard_normal((n, 6))
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    theta, X, _, _ = lobpcg_min(lambda V: V - scale * torch.outer(xt, xt @ V),
                                torch.as_tensor(X0), max_iters=200, tol=1e-8)
    ref_theta, ref_X, _, _ = jax_lobpcg(
        lambda V: V - scale * jnp.outer(xj, xj @ V), jnp.asarray(X0),
        max_iters=200, tol=1e-8)
    assert abs(float(theta[0]) - expected) < 1e-6
    assert abs(float(theta[0]) - float(ref_theta[0])) < 1e-6
    if expected != 0.0:  # a unique eigenvector, up to sign
        v = X[:, 0].numpy()
        assert abs(v @ x) > 1 - 1e-6
        assert abs(v @ np.asarray(ref_X[:, 0])) > 1 - 1e-6


@pytest.mark.parametrize("method", ["auto", "device"])
@pytest.mark.parametrize("name", ["chain", "multi_robot"])
def test_certify_device_stage_matches_jax(graphs, name, method):
    jp, tp = graphs[name]
    jpd = jp.device_data(dtype=np.float64)
    A = np.random.default_rng(4).uniform(-1.0, 1.0, (jpd.size, 3))
    Y = np.asarray(project_to_manifold(jpd, jnp.asarray(A)))
    kw = dict(eta=1e-3, nx=10, max_lobpcg_iters=500, method=method,
              escape_eig_iters=160, seed=0)
    ref = jax_certify_module.certify_solution(jp, jpd, Y, **kw)
    got = certify.certify_solution(tp, tp.device_data(np.float64, "cpu"), Y, **kw)
    assert not ref.is_certified
    assert got.is_certified == ref.is_certified
    np.testing.assert_allclose(got.theta, ref.theta, rtol=1e-6)
    x, ref_x = np.asarray(got.x), np.asarray(ref.x)
    align = abs(x @ ref_x) / (np.linalg.norm(x) * np.linalg.norm(ref_x))
    assert align >= 1 - 1e-4


def test_staircase_escapes_along_device_eigenvector(graphs, monkeypatch):
    """From rank 2 on the multi-robot graph: the port certifies with
    method="auto", and its first saddle escape starts along the certificate
    that the device LOBPCG found, with no host Lanczos call before it. (The
    JAX package's first escape comes after a ramp lift whose random column
    jax.random draws, so its direction is compared at one shared point in
    `test_certify_device_stage_matches_jax`.)"""
    _, tp = graphs["multi_robot"]
    x0 = np.random.default_rng(4).uniform(-1.0, 1.0, (tp.data_matrix_size, 2))

    def record(module, name, log):
        """Wrap `module.name` to log (name, args, kwargs, result)."""
        fn = getattr(module, name)

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            log.append((name, args, kwargs, out))
            return out

        monkeypatch.setattr(module, name, wrapped)

    from cora_tpu_torch.solve import verification

    log = []
    for module, name in ((staircase, "certify_solution"),
                         (staircase, "saddle_escape"),
                         (certify, "lobpcg_min"),
                         (verification, "verify_psd_host")):
        record(module, name, log)
    staircase.solve_cora(tp, x0=x0, device="cpu", config=SolverConfig(
        tnt=TNTParams(max_computation_time=600.0), **BASE))

    def first_escape(events):
        """(v of the first escape, the certificate just before it, the
        names of the calls before it)."""
        i = next(i for i, e in enumerate(events) if e[0] == "saddle_escape")
        cert = [e for e in events[:i] if e[0] == "certify_solution"][-1][3]
        return np.asarray(events[i][1][3]), cert, [e[0] for e in events[:i]]

    assert all(e[2]["method"] == "auto" for e in log
               if e[0] == "certify_solution")
    v, cert, before = first_escape(log)
    assert "lobpcg_min" in before and "verify_psd_host" not in before
    x = np.asarray(cert.x)
    assert not cert.is_certified and cert.num_iters > 0
    assert abs(v @ x) / np.linalg.norm(x) > 1 - 1e-12
