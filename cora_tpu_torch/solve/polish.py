"""Float64 endgame polish: drive the Riemannian gradient to ~1e-6 before
certification.

The staircase runs in float32 and stalls at that dtype's precision floor,
but the certificate S = Q − Λ(Y) proves optimality only together with
(near-)stationarity of Y, and the reference certifies TNT output converged
to its 1e-6 gradient tolerance in double precision
(`src/CORA.cpp:98-109,139-171`). This is the handoff: a damped Riemannian
Newton-CG in float64, preconditioned by the exact banded factor of
Q + λI, with a batched Armijo backtracking ladder.

It runs on the solve's device in float64 (the H100 has native float64),
on every graph with the canonical ops (`cora_tpu_torch.ops.riemannian`)
and the float64 RegularizedCholesky banded preconditioner
(`cora_tpu_torch.precond.banded`), as the JAX package's polish does
(`cora_tpu/solve/polish.py:247-352`).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from cora_tpu_torch.ops import riemannian as rm
from cora_tpu_torch.ops.quadratic import data_matrix_product
from cora_tpu_torch.utils.device import check_device

# zero columns are exactly invariant under the whole polish; the JAX
# package pads to one width to compile once, and the port keeps the same
# width so that both polish the same problem
POLISH_PAD_RANK = 6
# the Armijo ladder's step lengths, largest first
ALPHAS = 0.5 ** np.arange(16, dtype=np.float64)


@dataclasses.dataclass
class PolishResult:
    Y: np.ndarray  # float64 host copy of the polished state
    f: float
    grad_norm: float  # float64 Riemannian gradient norm at Y
    iterations: int
    status: str


def _q_norm(problem) -> float:
    """Cached ‖Q‖₂ estimate."""
    cached = getattr(problem, "_polish_cache", None)
    if cached is None:
        from cora_tpu_torch.precond.banded import estimate_spectral_norm

        cached = problem._polish_cache = float(
            estimate_spectral_norm(problem.data_matrix()))
    return cached


def _dot(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return (A * B).sum()


def hessian_vector_product(pd, Q, Y, nablaF, dotY) -> np.ndarray:
    """Riemannian Hv (reference `CORA_problem.cpp:822-867`) in float64 on
    the host, with Q the host sparse data matrix: the JAX package's host
    form (`cora_tpu/solve/polish.py:87-106`) on the canonical blockwise
    ops. Arrays or tensors in, a float64 array out."""
    def host(x):
        return torch.as_tensor(np.asarray(
            x.detach().cpu() if isinstance(x, torch.Tensor) else x,
            np.float64))

    def q_op(V):
        return torch.as_tensor(Q @ V.numpy())

    return rm.riemannian_hvp(pd, host(Y), host(nablaF), host(dotY),
                             op=q_op).numpy()


def newton_step(pd, precon, Y, tau: float, max_cg: int):
    """f and grad at Y, plus the damped-Newton direction s from a
    preconditioned CG solve of (Hess + τI)s = −grad (negative-curvature
    truncation, superlinear forcing term). Returns (f, grad, ‖grad‖, s,
    ⟨grad, s⟩, CG iterations)."""
    nablaF = data_matrix_product(pd, Y)
    f = 0.5 * float(_dot(Y, nablaF))
    grad = rm.tangent_space_projection(pd, Y, nablaF)
    gn = float(torch.sqrt(_dot(grad, grad)))

    def hess(v):
        return rm.riemannian_hvp(pd, Y, nablaF, v) + tau * v

    def prec(v):
        return rm.tangent_space_projection(pd, Y, precon(v))

    tiny = float(np.finfo(np.float64).tiny)
    z0 = prec(grad)
    rz0 = float(_dot(grad, z0))
    rz_stop = rz0 * min(0.25, np.sqrt(max(rz0, 0.0))) ** 2
    s = torch.zeros_like(grad)
    r, d, rz = grad, -z0, rz0
    k = 0
    done = rz0 <= 0
    while k < max_cg and not done:
        Hd = hess(d)
        dHd = float(_dot(d, Hd))
        neg = dHd <= 0
        alpha = rz / (tiny if dHd == 0 else dHd)
        if neg:
            s = d if k == 0 else s
        else:
            s = s + alpha * d
        r = r + alpha * Hd
        z = prec(r)
        rz_new = float(_dot(r, z))
        conv = rz_new <= rz_stop
        beta = rz_new / (tiny if rz == 0 else rz)
        d = -z + beta * d
        rz = rz_new
        k += 1
        done = neg or conv
    gdir = float(_dot(grad, s))
    if not gdir < 0:  # not a descent direction: preconditioned steepest
        s, gdir = -z0, -rz0
    return f, grad, gn, s, gdir, k


def probe_ladder(pd, Y, s, alphas):
    """The whole Armijo ladder in one batched pass: the retractions
    project(Y + α s) for every α and their f, with one host read. The
    trial states go through Q side by side as columns (Q acts on each
    column alone). Returns (trial states (B, N, r), f (B,) on the host)."""
    N, r = Y.shape
    a = torch.as_tensor(alphas, dtype=Y.dtype, device=Y.device)
    Yb = rm.project_to_manifold(pd, Y + a[:, None, None] * s)
    QYb = data_matrix_product(pd, Yb.permute(1, 0, 2).reshape(N, -1))
    QYb = QYb.reshape(N, len(alphas), r).permute(1, 0, 2)
    f = 0.5 * (Yb * QYb).sum((1, 2))
    return Yb, f.cpu().numpy()


def polish_solution(
    problem,
    Y,
    grad_tol: float | None = None,
    max_iterations: int = 30,
    max_tcg_iterations: int = 60,
    max_cond: float = 1e6,
    time_budget: float | None = None,
    device="cuda",
    clock=None,
) -> PolishResult:
    """Polish Y to a float64 (near-)critical point of f(Y) = ½tr(YᵀQY)
    on the product manifold (translation-explicit formulation).

    Regularized Riemannian Newton-CG: each outer iteration solves
    (Hess + τI)s = −grad inexactly with preconditioned CG and takes the
    largest step of an Armijo ladder α = 2⁻ⁱ, i < 16, with τ = min(1,
    |grad|). `grad_tol` defaults to 1e-6·‖Q‖₂, the reference's 1e-6
    gradient tolerance (`src/CORA.cpp:100-101`) made scale-invariant.
    `clock(t0)` reads the seconds since t0 for `time_budget` (a sharded
    solve passes one that every rank reads alike).
    """
    from cora_tpu_torch.types import Preconditioner

    device = check_device(device)
    if grad_tol is None:
        grad_tol = 1e-6 * max(1.0, _q_norm(problem))
    pd = problem.device_data(np.float64, device)
    precon = problem.preconditioner_fn(
        Preconditioner.REGULARIZED_CHOLESKY, np.float64, max_cond, device)
    if isinstance(Y, torch.Tensor):
        Y = Y.detach()
    Yin = torch.as_tensor(np.asarray(Y.cpu() if isinstance(Y, torch.Tensor)
                                     else Y, np.float64))
    r_in = int(Yin.shape[1])
    r_pad = max(r_in, POLISH_PAD_RANK)
    Y = torch.zeros((Yin.shape[0], r_pad), dtype=torch.float64)
    Y[:, :r_in] = Yin
    Y = rm.project_to_manifold(pd, Y.to(device))
    t0 = time.time()

    gn = float("inf")
    status = "max_iterations"
    k = 0
    elapsed = clock or (lambda t: time.time() - t)
    for k in range(1, max_iterations + 1):
        if time_budget is not None and elapsed(t0) > time_budget:
            status = "time_budget"
            break
        tau = min(1.0, gn if np.isfinite(gn) else 1.0)
        f, _, gn, s, gdir, _ = newton_step(pd, precon, Y, tau,
                                           max_tcg_iterations)
        if gn <= grad_tol:
            status = "gradient_tolerance"
            break
        Y_props, f_props = probe_ladder(pd, Y, s, ALPHAS)
        ok = (f_props <= f + 1e-4 * ALPHAS * gdir) | (f_props < f)
        if not ok.any():
            status = "line_search_failure"
            break
        Y = Y_props[int(np.argmax(ok))]  # the largest accepted step
    f, _, gn, _, _, _ = newton_step(pd, precon, Y, 1.0, 1)
    if gn <= grad_tol:
        status = "gradient_tolerance"
    return PolishResult(
        Y=Y[:, :r_in].cpu().numpy(), f=f, grad_norm=gn, iterations=k,
        status=status,
    )
