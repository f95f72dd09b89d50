"""The plain chain ops (`cora_tpu_torch.ops.chain`) against the JAX package.

float64: against the canonical operators (`data_matrix_product`,
`tangent_space_projection`, `riemannian_hvp`, `banded_apply`,
`project_to_manifold`), to 1e-12 relative to the output's max entry —
the same algebra summed in a different order.

float32: against the Pallas kernels' tile math (`make_host_ops` through
`to_tiles`/`from_tiles`), to 2e-6 relative (a few float32 ulps of the
output's scale; the preconditioner solve, whose doubling scan compounds
rounding over its levels, to 1e-5).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cora_tpu.models.synthetic import synthetic_problem as jax_problem  # noqa: E402
from cora_tpu.ops import tiles as T  # noqa: E402
from cora_tpu.ops.quadratic import data_matrix_product  # noqa: E402
from cora_tpu.ops.riemannian import (  # noqa: E402
    project_to_manifold,
    riemannian_hvp,
    tangent_space_projection,
)
from cora_tpu.precond.banded import banded_apply, device_factor, factor_banded  # noqa: E402
from cora_tpu_torch.models.synthetic import synthetic_problem  # noqa: E402
from cora_tpu_torch.ops import chain  # noqa: E402

GRAPHS = [
    (2, 3, dict(n_poses=37, n_landmarks=3, n_ranges=29, dim=2, seed=1)),
    (3, 4, dict(n_poses=37, n_landmarks=3, n_ranges=29, dim=3, seed=1)),
    (2, 4, dict(n_poses=14, n_landmarks=2, n_ranges=10, dim=2, seed=3)),
]
IDS = ["2d-r3", "3d-r4", "2d-n14"]
OPS = ["qv", "tangent_project", "hvp", "precon_solve", "project_manifold"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(g, rank, np_dtype):
    rng = np.random.default_rng(7)
    jp = jax_problem(**g)
    jpd = jp.device_data(dtype=np_dtype)
    Y = np.asarray(project_to_manifold(
        jpd, jnp.asarray(rng.uniform(-1, 1, (jpd.size, rank)), np_dtype)))
    V = rng.standard_normal(Y.shape).astype(np_dtype)
    return jp, jpd, Y, V


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _torch_out(plan, op, Y, V, nablaF):
    Yt, Vt = torch.as_tensor(Y.copy()), torch.as_tensor(V.copy())
    if op == "qv":
        return chain.qv(plan, Vt)
    if op == "tangent_project":
        return chain.tangent_project(plan, Yt, Vt)
    if op == "hvp":
        tang = chain.tangent_project(plan, Yt, Vt)
        return chain.hvp(plan, Yt, torch.as_tensor(nablaF.copy()), tang)
    if op == "precon_solve":
        return chain.precon_solve(plan, Vt)
    return chain.project_manifold(plan, Yt + 0.1 * Vt)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dim,rank,g", GRAPHS, ids=IDS)
def test_chain_op_f64_vs_canonical(dim, rank, g, op):
    jp, jpd, Y, V = _inputs(g, rank, np.float64)
    plan = chain.build_chain_plan(synthetic_problem(**g), dtype=np.float64)
    nablaF = np.asarray(data_matrix_product(jpd, jnp.asarray(Y)))
    jY, jV = jnp.asarray(Y), jnp.asarray(V)
    if op == "qv":
        ref = data_matrix_product(jpd, jV)
    elif op == "tangent_project":
        ref = tangent_space_projection(jpd, jY, jV)
    elif op == "hvp":
        ref = riemannian_hvp(jpd, jY, jnp.asarray(nablaF),
                             tangent_space_projection(jpd, jY, jV))
    elif op == "precon_solve":
        F = factor_banded(None, jpd, jp.data_matrix(), plan.lam,
                          order=np.arange(jpd.n, dtype=np.int64))
        ref = banded_apply(jpd, device_factor(jpd, F, dtype=np.float64), jV)
    else:
        ref = project_to_manifold(jpd, jY + 0.1 * jV)
    out = _torch_out(plan, op, Y, V, nablaF)
    assert out.dtype == torch.float64
    assert _rel(out, ref) < 1e-12


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dim,rank,g", GRAPHS, ids=IDS)
def test_chain_op_f32_vs_tile_math(dim, rank, g, op):
    jp, jpd, Y, V = _inputs(g, rank, np.float32)
    plan_t = T.build_tile_plan(jp, jpd, rank, dtype=np.float32)
    ops = T.make_host_ops(plan_t)
    plan = chain.build_chain_plan(synthetic_problem(**g), dtype=np.float32)
    nablaF = np.asarray(data_matrix_product(jpd, jnp.asarray(Y)))
    Yt = T.to_tiles(plan_t, jnp.asarray(Y))
    Vt = T.to_tiles(plan_t, jnp.asarray(V))
    if op == "qv":
        ref = ops.qv(*Vt)
    elif op == "tangent_project":
        ref = ops.tangent_project(Yt, Vt)
    elif op == "hvp":
        ref = ops.hvp(Yt, T.to_tiles(plan_t, jnp.asarray(nablaF)),
                      ops.tangent_project(Yt, Vt))
    elif op == "precon_solve":
        ref = ops.precon_solve(Vt)
    else:
        ref = ops.project_manifold(ops.axpy(0.1, Vt, Yt))
    ref = np.asarray(T.from_tiles(plan_t, *ref))
    out = _torch_out(plan, op, Y, V, nablaF)
    assert out.dtype == torch.float32
    tol = 1e-5 if op == "precon_solve" else 2e-6
    assert _rel(out, ref) < tol
