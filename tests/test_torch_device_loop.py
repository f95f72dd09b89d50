"""The device-resident TNT loop of the port (`cora_tpu_torch/solve/tnt.py`)
on the CPU, against the host-driven loop it replaces and against the JAX
package.

Small graphs made from a seed: the 3-robot 2D PyFG graph of
`tests/test_torch_general.py` (explicit, RegularizedCholesky) and the 2D
chain of `tests/test_torch_implicit.py` (implicit, float64).

  * (a) the masked tCG in blocks of 1, 3 and `max_tcg_iterations`
    iterations ends on the bits (s, model decrease, boundary hit,
    iterations) of the host loop that read its flags after every
    iteration; `tnt_solve` at two block sizes ends on that loop's bits:
    histories, state, f, norms, status;
  * (b) the step functions (tCG set-up, a block, the outer step) read
    nothing back to the host: they run with `Tensor.__bool__`, `.item`,
    `.tolist`, `.cpu`, `.numpy` and the number conversions patched to
    raise, which is what lets them be captured as CUDA graphs;
  * (c) each way a level ends, against the JAX package on the same graph
    and start: a ramp exit, a promotion to the finish (at the ramp's end,
    and by a stall during the ramp) that ends at the iteration cap or at a
    relative-decrease stall, and the degenerate zero-gradient start that
    ends in a trust-region collapse. Status, iteration count and tCG
    iterations equal; f, ‖grad‖, √⟨g,Pg⟩ and ‖s‖ per iteration at 1e-10 in
    float64, at 1e-4 / 1e-3 (f / norms) in float32, the tolerances of
    `test_tnt_solve_first_iterations`;
  * (d) the preallocated iterate log equals the host loop's list of
    states bit for bit, and the JAX package's log at 1e-8.
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
from cora_tpu.solve.tnt import tnt_solve as jax_tnt  # noqa: E402
from cora_tpu.types import Formulation as JaxFormulation  # noqa: E402
from cora_tpu.types import Preconditioner as JaxPrecond  # noqa: E402
from cora_tpu.types import TNTParams as JaxTNTParams  # noqa: E402
from cora_tpu_torch import precond  # noqa: E402
from cora_tpu_torch.io.pyfg import parse_pyfg  # noqa: E402
from cora_tpu_torch.models.synthetic import synthetic_problem  # noqa: E402
from cora_tpu_torch.ops.riemannian import (  # noqa: E402
    retract,
    riemannian_hvp,
    tangent_space_projection,
)
from cora_tpu_torch.solve import tnt  # noqa: E402
from cora_tpu_torch.types import Formulation, Preconditioner  # noqa: E402
from cora_tpu_torch.types import TNTParams  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
from torch_port_reference import multi_robot_pyfg  # noqa: E402

# the 2D graph of tests/test_torch_general.py and the chain of
# tests/test_torch_implicit.py
MULTI = dict(n_robots=3, poses_per_robot=12, n_inter_ranges=30,
             n_landmarks=2, n_landmark_ranges=12, n_loop_closures=2, dim=2,
             seed=0)
CHAIN = dict(n_poses=60, n_landmarks=3, n_ranges=40, dim=2, seed=1)
# the staircase's first-level arguments at a small budget, with no lift
# (so the level goes on to its finish)
RAMP = dict(ramp_iterations=6, ramp_tcg=4, lift_grad_norm=float("inf"),
            stall_window=3, stall_tol=1e-4)
TOL = {np.float64: (1e-10, 1e-10), np.float32: (1e-4, 1e-3)}
HIST = ("objective_values", "gradient_norms",
        "preconditioned_gradient_norms", "update_step_norms")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def multi(tmp_path_factory):
    """(JAX problem, port problem) of the 2D multi-robot graph."""
    path = str(tmp_path_factory.mktemp("pyfg") / "multi.pyfg")
    with open(path, "w") as fh:
        fh.write(multi_robot_pyfg(**MULTI))
    return jax_parse(path), parse_pyfg(path)


@pytest.fixture(scope="module")
def chain():
    return jax_synthetic(**CHAIN), synthetic_problem(**CHAIN)


def _start(height, rank, seed=4):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (height, rank))


def _explicit(jp, tp, dtype):
    """(start, JAX args, port args) of an explicit solve at rank d + 2."""
    jpd = jp.device_data(dtype=dtype)
    X = np.asarray(jr.project_to_manifold(
        jpd, jnp.asarray(_start(jp.data_matrix_size, jp.dim + 2), dtype)))
    jargs = (jpd, jp.preconditioner_fn(JaxPrecond.REGULARIZED_CHOLESKY,
                                       dtype=dtype), None)
    targs = (tp.device_data(dtype, "cpu"),
             tp.preconditioner_fn(Preconditioner.REGULARIZED_CHOLESKY,
                                  dtype=dtype, device="cpu"), None)
    return X, jargs, targs


def _implicit(jp, tp):
    """(start, JAX args, port args) of an implicit float64 solve."""
    jpd = jp.device_data(dtype=np.float64)
    X = np.asarray(jr.project_to_manifold(
        jpd, jnp.asarray(_start(jp.rot_and_range_matrix_size, jp.dim + 2))))
    jop = jax_make_operator(jp, jpd, JaxFormulation.IMPLICIT,
                            dtype=np.float64)
    jargs = (jpd, jax_precond.implicit_precond(jp.preconditioner_fn(
        JaxPrecond.REGULARIZED_CHOLESKY, dtype=np.float64)), jop)
    targs = (tp.device_data(np.float64, "cpu"),
             precond.implicit_precond(tp.preconditioner_fn(
                 Preconditioner.REGULARIZED_CHOLESKY, np.float64,
                 device="cpu")),
             tp.operator(Formulation.IMPLICIT, np.float64, "cpu"))
    return X, jargs, targs


# ---------------------------------------------------------------------------
# the host-driven loop that the device loop replaced: flags read back after
# every tCG iteration and twice per outer iteration, Python branches


def _flags(*conds):
    return [bool(x) for x in torch.stack(conds).tolist()]


def _host_tcg(grad, hess, prec, delta, max_iters, kappa, theta):
    tiny = torch.finfo(grad.dtype).tiny
    s, r = torch.zeros_like(grad), grad
    z = prec(r)
    d = -z
    rz = tnt._inner(r, z)
    rz_stop = rz * torch.clamp(torch.pow(torch.sqrt(rz) + tiny, theta),
                               max=kappa) ** 2
    phi = sigma = mdec = torch.zeros((), dtype=grad.dtype)
    dmd = rz
    k, hit = 0, False
    done = bool(rz <= 0)
    while k < max_iters and not done:
        Hd = hess(d)
        dHd = tnt._inner(d, Hd)
        alpha = rz / torch.where(dHd == 0, tiny, dHd)
        phi_next = phi + 2.0 * alpha * sigma + alpha * alpha * dmd
        stop_here = (phi_next >= delta * delta) | (dHd <= 0)
        disc = torch.clamp(sigma * sigma + dmd * (delta * delta - phi),
                           min=0.0)
        tau = (-sigma + torch.sqrt(disc)) / torch.where(dmd == 0, tiny, dmd)
        s = torch.where(stop_here, s + tau * d, s + alpha * d)
        mdec = torch.where(stop_here, mdec + tau * rz - 0.5 * tau * tau * dHd,
                           mdec + 0.5 * alpha * rz)
        r = r + alpha * Hd
        z = prec(r)
        rz_new = tnt._inner(r, z)
        beta = rz_new / torch.where(rz == 0, tiny, rz)
        d = -z + beta * d
        sigma = beta * (sigma + alpha * dmd)
        dmd = rz_new + beta * beta * dmd
        phi = torch.where(stop_here, phi, phi_next)
        stop, converged = _flags(stop_here, rz_new <= rz_stop)
        rz = rz_new
        k += 1
        done = stop or converged
        hit = hit or stop
    return s, mdec, hit, k


def _host_tnt(pd, Y, precon, p, ramp_iterations=0, ramp_tcg=0,
              lift_grad_norm=float("inf"), stall_window=0, stall_tol=0.0,
              op=None, log_iterates=False):
    """(f, Y, ‖grad‖, √⟨g,Pg⟩, k, status, (5, k) histories, iterates)."""
    dt = Y.dtype
    tiny = torch.finfo(dt).tiny

    def T(x):
        return torch.tensor(x, dtype=dt)

    def prec(Yb, v):
        return tangent_space_projection(pd, Yb, precon(v))

    ramp_until = max(ramp_iterations, 0)
    iter_cap = p.max_iterations + ramp_until
    tcg_cap = p.max_tcg_iterations
    ramp_tcg = min(ramp_tcg if ramp_tcg > 0 else tcg_cap, tcg_cap)
    lift, sw = T(lift_grad_norm), stall_window
    stall_rel = T(float(sw)) * T(stall_tol)
    f, grad, nablaF = tnt._f_and_grad(pd, Y, op)
    gn = torch.sqrt(tnt._inner(grad, grad))
    pgn = tnt._pgrad_norm(grad, prec(Y, grad), gn)
    Delta = T(p.delta0)
    hist = Y.new_zeros((5, iter_cap))
    iterates = [] if log_iterates else None
    g_ok, pg_ok = _flags(gn <= p.gradient_tolerance,
                         pgn <= p.preconditioned_gradient_tolerance)
    status = tnt.GRAD_TOL if g_ok else tnt.PRECON_GRAD_TOL if pg_ok \
        else tnt.RUNNING
    k, finish, dec_streak, step_streak = 0, False, 0, 0
    while k < iter_cap and status == tnt.RUNNING:
        in_ramp = (not finish) and k < ramp_until
        Yk, nF = Y, nablaF
        s, mdec, hit, inner_k = _host_tcg(
            grad, lambda v: riemannian_hvp(pd, Yk, nF, v, op=op),
            lambda v: prec(Yk, v), Delta, ramp_tcg if in_ramp else tcg_cap,
            p.kappa_fgr, p.theta)
        Y_prop = retract(pd, Y, s)
        f_prop, grad_prop, nablaF_prop = tnt._f_and_grad(pd, Y_prop, op)
        step_norm = torch.sqrt(tnt._inner(s, s))
        rho = (f - f_prop) / torch.where(mdec == 0, tiny, mdec)
        rel_decrease = (f - f_prop) / (f.abs() + tiny)
        accept, very, small_dec, small_step = _flags(
            (rho >= p.eta1) & (mdec > 0), rho >= p.eta2,
            rel_decrease < p.relative_decrease_tolerance,
            step_norm < p.stepsize_tolerance)
        if accept:
            Y, f, grad, nablaF = Y_prop, f_prop, grad_prop, nablaF_prop
            gn = torch.sqrt(tnt._inner(grad_prop, grad_prop))
            pgn = tnt._pgrad_norm(grad_prop, prec(Y_prop, grad_prop), gn)
            Delta_new = p.alpha2 * Delta if very and hit else Delta
        else:
            Delta_new = p.alpha1 * Delta
        dec_streak = dec_streak + 1 if accept and small_dec else \
            0 if accept else dec_streak
        step_streak = step_streak + 1 if accept and small_step else \
            0 if accept else step_streak
        hist[0, k] = f
        f_lag = hist[0, max(k - sw, 0)]
        g_ok, pg_ok, delta_small, plateau, far, near = _flags(
            gn <= p.gradient_tolerance,
            pgn <= p.preconditioned_gradient_tolerance,
            Delta_new < p.delta_tolerance,
            (f_lag - f) < stall_rel * f.abs(), gn > lift, gn <= lift)
        st = (tnt.GRAD_TOL if g_ok else tnt.PRECON_GRAD_TOL if pg_ok
              else tnt.REL_DECREASE if dec_streak >= tnt.STREAK
              else tnt.STEPSIZE if step_streak >= tnt.STREAK
              else tnt.DELTA_TOL if delta_small else tnt.RUNNING)
        plateaued = sw > 0 and k >= sw and plateau
        boundary = (in_ramp and (k + 1 == ramp_until or plateaued)
                    and st == tnt.RUNNING)
        promote = (in_ramp and st in (tnt.REL_DECREASE, tnt.STEPSIZE,
                                      tnt.DELTA_TOL)) or (boundary and near)
        status = tnt.RAMP_EXIT if boundary and far else \
            tnt.RUNNING if promote else st
        finish = finish or promote
        if promote:
            Delta_new = T(p.delta0)
            dec_streak = step_streak = 0
        Delta = Delta_new
        hist[1, k], hist[2, k] = gn, pgn
        hist[3, k] = step_norm if accept else 0.0
        hist[4, k] = inner_k
        if iterates is not None:
            iterates.append(Y)
        k += 1
    return f, Y, gn, pgn, k, status, hist[:, :k], iterates


# ---------------------------------------------------------------------------


def _same_bits(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("delta", [5.0, 1e8], ids=["delta5", "delta1e8"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_masked_tcg_blocks_match_host_loop(multi, dtype, delta):
    """With ∇F = 0 in the Weingarten term the Hessian is PSD (as the
    card's `tcg` check takes it), so at Δ = 1e8 the tCG runs to its
    superlinear stop, at Δ = 5 it hits the boundary; B ∈ {1, 3, max_tcg}
    against the host loop."""
    jp, tp = multi
    X, _, (pd, pre, _) = _explicit(jp, tp, dtype)
    Y = torch.as_tensor(X)
    f, grad, nablaF = tnt._f_and_grad(pd, Y)
    p = TNTParams()

    def hess(v):
        return riemannian_hvp(pd, Y, torch.zeros_like(nablaF), v)

    def prec(v):
        return tangent_space_projection(pd, Y, pre(v))

    D = torch.tensor(delta, dtype=Y.dtype)
    want = _host_tcg(grad, hess, prec, D, p.max_tcg_iterations, p.kappa_fgr,
                     p.theta)
    # the boundary stop at Δ = 5, more iterations than the smallest blocks
    # at Δ = 1e8
    assert want[2] if delta == 5.0 else want[3] > 3
    for block in (1, 3, p.max_tcg_iterations):
        s, mdec, hit, k = tnt.steihaug_toint_tcg(
            grad, hess, prec, D, p.max_tcg_iterations, p.kappa_fgr, p.theta,
            block=block)
        assert _same_bits(s, want[0]) and _same_bits(mdec, want[1])
        assert (hit, k) == (want[2], want[3])


def _check_same(out, want):
    f, Y, gn, pgn, k, status, hist, iterates = want
    assert out.num_iterations == k
    assert out.status == tnt.STATUS_NAMES.get(status, "max_iterations")
    assert (out.f, out.gradfx_norm, out.preconditioned_gradfx_norm) == (
        float(f), float(gn), float(pgn))
    assert _same_bits(out.x, Y)
    h = hist.numpy()
    for row, name in enumerate(HIST):
        np.testing.assert_array_equal(getattr(out, name), h[row])
    np.testing.assert_array_equal(out.inner_iterations,
                                  h[4].astype(np.int32))
    if iterates is None:
        assert out.iterates is None
    else:
        assert len(out.iterates) == len(iterates)
        for a, b in zip(out.iterates, iterates):
            np.testing.assert_array_equal(a, b.double().numpy())


@pytest.mark.parametrize("case", ["explicit-f32", "explicit-f64",
                                  "implicit-f64"])
def test_tnt_solve_blocks_match_host_loop(multi, chain, case):
    """The staircase's first-level arguments (ramp, plateau window) at
    blocks of 1 and 2 iterations."""
    if case == "implicit-f64":
        X, _, (pd, pre, op) = _implicit(*chain)
    else:
        dtype = np.float32 if case.endswith("f32") else np.float64
        X, _, (pd, pre, op) = _explicit(*multi, dtype)
    p = TNTParams(max_iterations=10, max_computation_time=600.0)
    want = _host_tnt(pd, torch.as_tensor(X), pre, p, op=op, **RAMP)
    assert want[4] > RAMP["ramp_iterations"]  # the finish ran too
    assert want[6][4].max() > 2  # tCG runs of several blocks
    for block in (1, 2):
        with tnt.device_loop(block=block):
            out = tnt.tnt_solve(pd, torch.as_tensor(X), pre, p, op=op,
                                **RAMP)
        _check_same(out, want)


class _HostRead(AssertionError):
    pass


def _forbid_host_reads(monkeypatch):
    def read(self, *a, **k):
        raise _HostRead("a host read inside a step function")

    for name in ("__bool__", "__int__", "__float__", "__index__", "item",
                 "tolist", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, read)


@pytest.mark.parametrize("case", ["explicit-f32", "implicit-f64"])
def test_step_functions_make_no_host_read(multi, chain, monkeypatch, case):
    """The off-card proof that the step functions can be captured."""
    if case == "implicit-f64":
        X, _, (pd, pre, op) = _implicit(*chain)
    else:
        X, _, (pd, pre, op) = _explicit(*multi, np.float32)
    Y0 = torch.as_tensor(X)
    p = TNTParams()
    lvl = tnt._Level(pd, Y0, pre, p, op, 20, True, 3, graphs=False)
    lvl.start(Y0, 6, p.max_tcg_iterations, 4, 1e3, 3, 1e-4)
    before = lvl.ks.clone()
    with monkeypatch.context() as m:
        _forbid_host_reads(m)
        lvl._setup()
        lvl._block()
        lvl._block()
        lvl._step()
    # and the guard does fire on a read
    with monkeypatch.context() as m:
        _forbid_host_reads(m)
        with pytest.raises(_HostRead):
            bool(lvl.t["done"])
    assert lvl.ks.tolist() == [int(before[0]) + 1, tnt.RUNNING]
    assert int(lvl.t["k"]) > 0 and lvl.hist[4, 0] == lvl.t["k"]


def _zero_op(Y):
    return torch.zeros_like(Y)


def _jax_zero_op(Y):
    return jnp.zeros_like(Y)


# (params, tnt_solve keywords, expected status); the degenerate start's
# operator is zero, so its gradient is exactly zero at every point
ENDS = {
    "ramp_exit": (dict(max_iterations=10),
                  dict(ramp_iterations=3, ramp_tcg=2, lift_grad_norm=1e-3),
                  "ramp_exit"),
    "promote_at_ramp_end": (dict(max_iterations=5),
                            dict(ramp_iterations=3, ramp_tcg=2),
                            "max_iterations"),
    "promote_by_stall": (dict(max_iterations=20,
                              relative_decrease_tolerance=1.0),
                         dict(ramp_iterations=10, ramp_tcg=3),
                         "relative_decrease"),
    "zero_gradient": (dict(gradient_tolerance=-1.0,
                           preconditioned_gradient_tolerance=-1.0),
                      dict(zero_op=True), "trust_region_collapse"),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("end", list(ENDS))
def test_level_ends_match_jax(multi, end, dtype):
    params, kw, status = ENDS[end]
    kw = dict(kw)
    X, (jpd, jpre, _), (pd, pre, _) = _explicit(*multi, dtype)
    jop = op = None
    if kw.pop("zero_op", False):
        jop, op = _jax_zero_op, _zero_op
    ref = jax_tnt(jpd, jnp.asarray(X), jpre,
                  JaxTNTParams(max_computation_time=600.0, **params),
                  op=jop, **kw)
    out = tnt.tnt_solve(pd, torch.as_tensor(X), pre,
                        TNTParams(max_computation_time=600.0, **params),
                        op=op, **kw)
    assert out.status == ref.status == status
    assert out.num_iterations == ref.num_iterations
    np.testing.assert_array_equal(out.inner_iterations, ref.inner_iterations)
    tol_f, tol_g = TOL[dtype]
    for name in HIST:
        np.testing.assert_allclose(
            getattr(out, name), getattr(ref, name),
            rtol=tol_f if name == "objective_values" else tol_g,
            atol=0 if dtype == np.float64 else 1e-30)
    if end == "promote_at_ramp_end":
        # the ramp's tCG budget, then the full one
        assert (out.inner_iterations[:3] <= 2).all()
        assert out.inner_iterations[3:].max() > 2
    if end == "zero_gradient":
        assert not out.inner_iterations.any() and out.f == 0.0


@pytest.mark.parametrize("case", ["explicit-f64", "implicit-f64"])
def test_iterate_log_matches_list_and_jax(multi, chain, case):
    if case == "implicit-f64":
        X, (jpd, jpre, jop), (pd, pre, op) = _implicit(*chain)
    else:
        X, (jpd, jpre, jop), (pd, pre, op) = _explicit(*multi, np.float64)
    p = TNTParams(max_iterations=12, max_computation_time=600.0)
    want = _host_tnt(pd, torch.as_tensor(X), pre, p, op=op,
                     log_iterates=True)
    out = tnt.tnt_solve(pd, torch.as_tensor(X), pre, p, op=op,
                        log_iterates=True)
    _check_same(out, want)
    ref = jax_tnt(jpd, jnp.asarray(X), jpre,
                  JaxTNTParams(max_iterations=12, max_computation_time=600.0),
                  op=jop, log_iterates=True)
    assert len(out.iterates) == len(ref.iterates) == out.num_iterations
    for a, b in zip(out.iterates, ref.iterates):
        rel = np.abs(a - np.asarray(b)).max() / np.abs(np.asarray(b)).max()
        assert rel < 1e-8
