"""Truncated-Newton trust-region (TNT) solver on the canonical ops.

The general-graph counterpart of the chain kernels: the JAX package's
`cora_tpu/solve/tnt.py` (which re-implements the vendored
`Optimization::Riemannian::TNT` that the reference drives from
`src/CORA.cpp:52-141`) with the same semantics — Steihaug–Toint
preconditioned tCG in the M-norm (M = P⁻¹), trust-region update, streak
stopping tests, the staircase's ramp budget, ramp exit and stall window,
a chunked wall-clock cap and per-iteration histories — as a Python loop
over tensor ops on the state's device. Each tCG iteration reads two flags
back to the host; each outer iteration reads two small groups of flags.
Every comparison runs on the device in the state's dtype, so the float32
path decides as the JAX package's float32 program does.

Parameter semantics follow the reference's hardcoded CORA settings
(`src/CORA.cpp:95-109`). The chain graphs' solves run on the kernels
instead (`cora_tpu_torch.solve.tnt_kernel`), which share the status codes
below.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from cora_tpu_torch.ops.quadratic import data_matrix_product
from cora_tpu_torch.ops.riemannian import (
    retract,
    riemannian_hvp,
    tangent_space_projection,
)
from cora_tpu_torch.types import TNTParams, TNTResult

# termination reason codes
RUNNING = 0
GRAD_TOL = 1
PRECON_GRAD_TOL = 2
REL_DECREASE = 3
STEPSIZE = 4
DELTA_TOL = 5
MAX_ITERS = 6
TIME_CAP = 7
RAMP_EXIT = 8  # ramp budget exhausted far from criticality (lift + climb)

STATUS_NAMES = {
    GRAD_TOL: "gradient_tolerance",
    PRECON_GRAD_TOL: "preconditioned_gradient_tolerance",
    REL_DECREASE: "relative_decrease",
    STEPSIZE: "stepsize",
    DELTA_TOL: "trust_region_collapse",
    MAX_ITERS: "max_iterations",
    TIME_CAP: "time_cap",
    RAMP_EXIT: "ramp_exit",
}

# upper bound on the outer iterations of one chunk; between chunks the
# host checks the per-rank wall-clock cap (reference
# `max_computation_time`, `src/CORA.cpp:106`)
CHUNK_ITERS = 128
STREAK = 3  # consecutive accepted steps for the decrease / step tests


def _inner(a, b):
    """Trace inner product ⟨A, B⟩ = tr(AᵀB) (reference `CORA.cpp:119-122`)."""
    return (a * b).sum()


def _pgrad_norm(grad, pgrad, gradnorm):
    """√⟨grad, P grad⟩, or ‖grad‖ where float32 cancellation makes the
    inner product non-positive (a clamp to 0 would read as converged)."""
    inner = _inner(grad, pgrad)
    return torch.where(inner > 0, torch.sqrt(torch.clamp(inner, min=0.0)),
                       gradnorm)


def _flags(*conds) -> list:
    """Device booleans → host bools, in one read."""
    return [bool(x) for x in torch.stack(conds).tolist()]


def steihaug_toint_tcg(grad, hess: Callable, precon: Callable, delta,
                       max_iters: int, kappa: float, theta: float):
    """Preconditioned truncated CG for the trust-region subproblem

        min_s ⟨grad, s⟩ + ½⟨s, H s⟩   s.t.  ‖s‖_M ≤ Δ,   M = P⁻¹.

    Returns (s, model decrease, boundary hit, iterations)."""
    tiny = torch.finfo(grad.dtype).tiny
    s = torch.zeros_like(grad)
    r = grad
    z = precon(r)
    d = -z
    rz = _inner(r, z)
    # stop on the preconditioned residual with the superlinear rule
    rz_stop = rz * torch.clamp(torch.pow(torch.sqrt(rz) + tiny, theta),
                               max=kappa) ** 2
    zero = torch.zeros((), dtype=grad.dtype, device=grad.device)
    phi = sigma = mdec = zero  # ⟨s,Ms⟩, ⟨s,Md⟩, model decrease
    dmd = rz  # ⟨d,Md⟩
    k, hit = 0, False
    done = bool(rz <= 0)  # degenerate: zero (preconditioned) gradient
    while k < max_iters and not done:
        Hd = hess(d)
        dHd = _inner(d, Hd)
        alpha = rz / torch.where(dHd == 0, tiny, dHd)
        phi_next = phi + 2.0 * alpha * sigma + alpha * alpha * dmd
        stop_here = (phi_next >= delta * delta) | (dHd <= 0)
        # the boundary step: ‖s + τ d‖_M = Δ, τ ≥ 0
        disc = torch.clamp(sigma * sigma + dmd * (delta * delta - phi),
                           min=0.0)
        tau = (-sigma + torch.sqrt(disc)) / torch.where(dmd == 0, tiny, dmd)
        s = torch.where(stop_here, s + tau * d, s + alpha * d)
        mdec = torch.where(stop_here, mdec + tau * rz - 0.5 * tau * tau * dHd,
                           mdec + 0.5 * alpha * rz)
        r = r + alpha * Hd
        z = precon(r)
        rz_new = _inner(r, z)
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


@dataclasses.dataclass
class _Carry:
    """The TNT loop state between chunks."""

    Y: torch.Tensor
    f: torch.Tensor
    grad: torch.Tensor
    nablaF: torch.Tensor
    gradnorm: torch.Tensor
    pgradnorm: torch.Tensor
    Delta: torch.Tensor
    hist: torch.Tensor  # (5, H): f, ‖grad‖, √⟨g,Pg⟩, ‖s‖, tCG iterations
    iterates: list | None = None  # Y after each iteration (`log_iterates`)
    k: int = 0
    status: int = RUNNING
    finish: bool = False
    dec_streak: int = 0
    step_streak: int = 0


def _f_and_grad(pd, Y, op=None):
    nablaF = op(Y) if op is not None else data_matrix_product(pd, Y)
    return 0.5 * _inner(Y, nablaF), \
        tangent_space_projection(pd, Y, nablaF), nablaF


def _tnt_init(pd, Y0, precon, params: TNTParams, history_len: int,
              op=None, log_iterates: bool = False) -> _Carry:
    """The TNT carry at Y0: objective, gradient, norms, empty histories."""
    f0, grad0, nablaF0 = _f_and_grad(pd, Y0, op)
    gn0 = torch.sqrt(_inner(grad0, grad0))
    pgn0 = _pgrad_norm(grad0, tangent_space_projection(pd, Y0, precon(grad0)),
                       gn0)
    c = _Carry(Y=Y0, f=f0, grad=grad0, nablaF=nablaF0, gradnorm=gn0,
               pgradnorm=pgn0,
               Delta=torch.tensor(params.delta0, dtype=Y0.dtype,
                                  device=Y0.device),
               hist=Y0.new_zeros((5, history_len)),
               iterates=[] if log_iterates else None)
    g_ok, pg_ok = _flags(gn0 <= params.gradient_tolerance,
                         pgn0 <= params.preconditioned_gradient_tolerance)
    c.status = GRAD_TOL if g_ok else PRECON_GRAD_TOL if pg_ok else RUNNING
    return c


def _tnt_chunk(pd, c: _Carry, precon, params: TNTParams, op=None,
               iter_cap: int = 0, tcg_cap: int = 0, chunk_end: int = 0,
               ramp_until: int = 0, ramp_tcg: int = 0,
               lift_grad_norm: float = float("inf"), stall_window: int = 0,
               stall_tol: float = 0.0) -> _Carry:
    """Advance the TNT loop to `chunk_end` outer iterations (or a stop).

    The staircase's ramp→finish transition runs inside the loop:
    iterations below `ramp_until` get the cheap `ramp_tcg` inner budget;
    at the ramp's end (its budget, or an objective plateau over
    `stall_window` iterations) a level with |grad| > `lift_grad_norm`
    exits with status `ramp_exit`, any other continues at the full tCG
    budget with the trust region restarted at Δ₀. A stall status during
    the ramp also promotes to the finish. `op` is the quadratic-form
    operator (explicit Q when None); with `c.iterates` a list, each
    iteration appends its (accepted or kept) Y."""
    Y = c.Y
    dt, dev = Y.dtype, Y.device
    tiny = torch.finfo(dt).tiny

    def T(x):
        return torch.tensor(x, dtype=dt, device=dev)

    ramp_until = max(int(ramp_until), 0)
    iter_cap = min(int(iter_cap), params.max_iterations + ramp_until)
    tcg_cap = min(int(tcg_cap), params.max_tcg_iterations)
    stop_at = min(int(chunk_end), iter_cap)
    ramp_tcg = min(int(ramp_tcg) if ramp_tcg > 0 else tcg_cap, tcg_cap)
    lift = T(lift_grad_norm)
    sw = int(stall_window)
    stall_rel = T(float(sw)) * T(stall_tol)

    def prec(Yb, v):
        return tangent_space_projection(pd, Yb, precon(v))

    while c.k < stop_at and c.status == RUNNING:
        k, Y = c.k, c.Y
        in_ramp = (not c.finish) and k < ramp_until
        s, mdec, hit, inner_k = steihaug_toint_tcg(
            c.grad, lambda v: riemannian_hvp(pd, Y, c.nablaF, v, op=op),
            lambda v: prec(Y, v), c.Delta, ramp_tcg if in_ramp else tcg_cap,
            params.kappa_fgr, params.theta)
        Y_prop = retract(pd, Y, s)
        f_prop, grad_prop, nablaF_prop = _f_and_grad(pd, Y_prop, op)
        step_norm = torch.sqrt(_inner(s, s))
        rho = (c.f - f_prop) / torch.where(mdec == 0, tiny, mdec)
        rel_decrease = (c.f - f_prop) / (c.f.abs() + tiny)
        accept, very_successful, small_dec, small_step = _flags(
            (rho >= params.eta1) & (mdec > 0), rho >= params.eta2,
            rel_decrease < params.relative_decrease_tolerance,
            step_norm < params.stepsize_tolerance)
        if accept:
            c.Y, c.f, c.grad, c.nablaF = Y_prop, f_prop, grad_prop, nablaF_prop
            c.gradnorm = torch.sqrt(_inner(grad_prop, grad_prop))
            c.pgradnorm = _pgrad_norm(grad_prop, prec(Y_prop, grad_prop),
                                      c.gradnorm)
            Delta = params.alpha2 * c.Delta if very_successful and hit \
                else c.Delta
        else:
            Delta = params.alpha1 * c.Delta
        c.dec_streak = c.dec_streak + 1 if accept and small_dec else \
            0 if accept else c.dec_streak
        c.step_streak = c.step_streak + 1 if accept and small_step else \
            0 if accept else c.step_streak
        c.hist[0, k] = c.f
        f_lag = c.hist[0, max(k - sw, 0)]
        g_ok, pg_ok, delta_small, plateau, far, near = _flags(
            c.gradnorm <= params.gradient_tolerance,
            c.pgradnorm <= params.preconditioned_gradient_tolerance,
            Delta < params.delta_tolerance,
            (f_lag - c.f) < stall_rel * c.f.abs(),
            c.gradnorm > lift, c.gradnorm <= lift)
        status = (GRAD_TOL if g_ok else PRECON_GRAD_TOL if pg_ok
                  else REL_DECREASE if c.dec_streak >= STREAK
                  else STEPSIZE if c.step_streak >= STREAK
                  else DELTA_TOL if delta_small else RUNNING)
        plateaued = sw > 0 and k >= sw and plateau
        boundary = (in_ramp and (k + 1 == ramp_until or plateaued)
                    and status == RUNNING)
        stall_now = status in (REL_DECREASE, STEPSIZE, DELTA_TOL)
        promote = (in_ramp and stall_now) or (boundary and near)
        c.status = RAMP_EXIT if boundary and far else \
            RUNNING if promote else status
        c.finish = c.finish or promote
        if promote:
            Delta = T(params.delta0)
            c.dec_streak = c.step_streak = 0
        c.Delta = Delta
        c.hist[1, k] = c.gradnorm
        c.hist[2, k] = c.pgradnorm
        c.hist[3, k] = step_norm if accept else 0.0
        c.hist[4, k] = inner_k
        if c.iterates is not None:
            c.iterates.append(c.Y)
        c.k = k + 1
    return c


def tnt_solve(
    pd,
    Y0: torch.Tensor,
    precon: Callable,
    params: TNTParams | None = None,
    ramp_iterations: int = 0,
    ramp_tcg: int = 0,
    lift_grad_norm: float = float("inf"),
    stall_window: int = 0,
    stall_tol: float = 0.0,
    op: Callable | None = None,
    log_iterates: bool = False,
    clock: Callable[[float], float] | None = None,
) -> TNTResult:
    """Run TNT to convergence from Y0 on Y0's device and dtype. `precon`
    maps ambient V → P·V (the tangent projection is applied here,
    reference `CORA.cpp:87-92`). `op` replaces the explicit Q·Y (the
    implicit formulation's Q̃); `log_iterates` keeps the state after every
    iteration in `TNTResult.iterates` (float64 host arrays).

    The loop runs in chunks of at most `CHUNK_ITERS` outer iterations,
    sized from the measured time per iteration; between chunks the host
    enforces `params.max_computation_time` (the reference's 20 s per-rank
    cap), read from `clock(t0)` (seconds since t0; a sharded solve passes
    one that every rank reads alike). Ramp mode (`ramp_iterations > 0`):
    see `_tnt_chunk`; the ramp budget rides on top of the finish budget.
    """
    params = params or TNTParams()
    t0 = time.time()
    iter_cap = params.max_iterations + max(int(ramp_iterations), 0)
    tcg_cap = params.max_tcg_iterations
    max_time = params.max_computation_time

    c = _tnt_init(pd, Y0, precon, params, iter_cap, op, log_iterates)
    timed_out = False
    chunk_iters = CHUNK_ITERS
    elapsed = clock or (lambda t: time.time() - t)
    while c.status == RUNNING and c.k < iter_cap:
        if c.k > 0 and max_time is not None:
            spent = elapsed(t0)
            per_iter = max(spent / max(c.k, 1), 1e-6)
            remaining = max(max_time - spent, 0.0)
            chunk_iters = int(min(max(remaining * 0.5 / per_iter, 8),
                                  CHUNK_ITERS))
        c = _tnt_chunk(pd, c, precon, params, op, iter_cap, tcg_cap,
                       min(c.k + chunk_iters, iter_cap), ramp_iterations,
                       ramp_tcg, lift_grad_norm, stall_window, stall_tol)
        if (c.status == RUNNING and c.k < iter_cap and max_time is not None
                and elapsed(t0) > max_time):
            timed_out = True
            break

    k = c.k
    h = c.hist[:, :k].cpu().numpy()
    status = c.status
    if status == RUNNING:
        status = TIME_CAP if timed_out else MAX_ITERS
    return TNTResult(
        f=float(c.f),
        x=c.Y,
        gradfx_norm=float(c.gradnorm),
        preconditioned_gradfx_norm=float(c.pgradnorm),
        num_iterations=k,
        inner_iterations=h[4].astype(np.int32),
        objective_values=h[0],
        gradient_norms=h[1],
        preconditioned_gradient_norms=h[2],
        update_step_norms=h[3],
        elapsed_time=time.time() - t0,
        status=STATUS_NAMES.get(status, str(status)),
        iterates=(None if c.iterates is None else
                  [np.array(Y.detach().cpu(), np.float64)
                   for Y in c.iterates]),
    )


class HashableParams:
    """Wraps TNTParams so a parameter set can key a cache."""

    def __init__(self, params: TNTParams):
        self._params = params
        self._key = tuple(dataclasses.asdict(params).items())

    def __getattr__(self, name):
        return getattr(self._params, name)

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, HashableParams) and self._key == other._key
