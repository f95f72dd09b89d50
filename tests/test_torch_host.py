"""The port's host layer against the JAX package: import hygiene, the data
matrix Q, the edge-list problem data and the banded factor."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from cora_tpu.models.synthetic import synthetic_problem as jax_problem  # noqa: E402
from cora_tpu.ops import tiles as T  # noqa: E402
from cora_tpu.precond.banded import factor_banded as jax_factor_banded  # noqa: E402
from cora_tpu.precond.banded import host_banded_solve as jax_banded_solve  # noqa: E402
from cora_tpu_torch.graph.data import ProblemData  # noqa: E402
from cora_tpu_torch.models.synthetic import synthetic_problem  # noqa: E402
from cora_tpu_torch.ops import chain  # noqa: E402
from cora_tpu_torch.precond.banded import factor_banded, host_banded_solve  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPHS = [
    dict(n_poses=37, n_landmarks=3, n_ranges=29, dim=2, seed=1),
    dict(n_poses=37, n_landmarks=3, n_ranges=29, dim=3, seed=1),
    dict(n_poses=14, n_landmarks=2, n_ranges=10, dim=2, seed=3),
]
IDS = ["2d", "3d", "2d-n14"]


def test_port_imports_without_jax():
    code = ("import sys, cora_tpu_torch, cora_tpu_torch.solve.staircase, "
            "cora_tpu_torch.ops.tnt_kernels; "
            "assert 'jax' not in sys.modules; "
            "assert 'cora_tpu' not in sys.modules")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("g", GRAPHS, ids=IDS)
def test_data_matrix_equal(g):
    Qj = jax_problem(**g).data_matrix().tocsr()
    Qt = synthetic_problem(**g).data_matrix().tocsr()
    assert Qj.shape == Qt.shape
    assert (Qj != Qt).nnz == 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("g", GRAPHS, ids=IDS)
def test_problem_data_equals_from_numpy(g, dtype):
    jpd = jax_problem(**g).device_data(dtype=dtype)
    fields = {f.name: np.asarray(getattr(jpd, f.name))
              for f in dataclasses.fields(jpd)}
    carried = ProblemData.from_numpy(fields, device="cpu", dtype=dtype)
    own = synthetic_problem(**g).device_data(dtype=dtype, device="cpu")
    for f in dataclasses.fields(own):
        a, b = getattr(own, f.name), getattr(carried, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype, f.name
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    assert own.dtype() == (torch.float32 if dtype == np.float32
                           else torch.float64)


@pytest.mark.parametrize("g", GRAPHS, ids=IDS)
def test_banded_factor_equal(g):
    jp, tp = jax_problem(**g), synthetic_problem(**g)
    jpd = jp.device_data(dtype=np.float64)
    tpd = tp.device_data(dtype=np.float64)
    lam = 0.37
    order = np.arange(jpd.n, dtype=np.int64)
    Fj = jax_factor_banded(None, jpd, jp.data_matrix(), lam, order=order)
    Ft = factor_banded(None, tpd, tp.data_matrix(), lam, order=order)
    for name in ("L", "M", "Linv", "s_sph", "BinvC", "cap_inv", "C"):
        a, b = getattr(Ft, name), getattr(Fj, name)
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12, err_msg=name)
    V = np.random.default_rng(0).standard_normal((jpd.size, 3))
    np.testing.assert_allclose(host_banded_solve(tpd, Ft, V),
                               jax_banded_solve(jpd, Fj, V),
                               rtol=1e-12, atol=1e-12)
    # the doubling propagators of the plan against the tile plan's
    plan_t = T.build_tile_plan(jp, jp.device_data(dtype=np.float64), 3,
                               dtype=np.float64)
    plan = chain.build_chain_plan(tp, dtype=np.float64)
    assert plan.lam == pytest.approx(plan_t.lam, rel=1e-12)
    nb, w = plan.nb, plan.w
    for k in range(plan.levels):
        tile = plan_t.const["AF"][k][:, :nb].reshape(w, w, nb)
        np.testing.assert_allclose(plan.AF[k].numpy(),
                                   tile.transpose(2, 0, 1),
                                   rtol=1e-12, atol=1e-12)
    linv = plan_t.const["Linv"][:, :nb].reshape(w, w, nb).transpose(2, 0, 1)
    np.testing.assert_allclose(plan.Linv.numpy(), linv, rtol=1e-12,
                               atol=1e-12)


def test_plan_supported_matches():
    from cora_tpu.measurements import RelativePoseMeasurement as JaxRPM
    from cora_tpu.symbol import Symbol as JaxSymbol
    from cora_tpu_torch.measurements import RelativePoseMeasurement
    from cora_tpu_torch.symbol import Symbol

    g = dict(n_poses=10, n_landmarks=1, n_ranges=5, seed=0)
    jp, tp = jax_problem(**g), synthetic_problem(**g)
    assert chain.plan_supported(tp.device_data()) is None
    assert T.plan_supported(jp.device_data()) is None
    # a loop-closure edge 0 -> 5 leaves the chain family in both packages
    jp.add_relative_pose_measurement(JaxRPM(
        JaxSymbol("a", 0), JaxSymbol("a", 5), np.eye(2), np.zeros(2),
        np.eye(3)))
    tp.add_relative_pose_measurement(RelativePoseMeasurement(
        Symbol("a", 0), Symbol("a", 5), np.eye(2), np.zeros(2), np.eye(3)))
    reason = chain.plan_supported(tp.device_data())
    assert reason is not None
    assert reason == T.plan_supported(jp.device_data())
