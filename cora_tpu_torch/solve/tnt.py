"""Truncated-Newton trust-region (TNT) solver on the canonical ops, as a
device-resident loop.

The general-graph counterpart of the chain kernels: the JAX package's
`cora_tpu/solve/tnt.py` (which re-implements the vendored
`Optimization::Riemannian::TNT` that the reference drives from
`src/CORA.cpp:52-141`) with the same semantics — Steihaug–Toint
preconditioned tCG in the M-norm (M = P⁻¹), trust-region update, streak
stopping tests, the staircase's ramp budget, ramp exit and stall window,
a chunked wall-clock cap and per-iteration histories.

As in the JAX package, the whole loop state lives on the device: the
iterate, the trust radius, the streaks, the status, the ramp flag, the
histories, the iterate log and the tCG state are tensors in buffers
allocated once per level (`_Level`), and three step functions advance
them without reading anything back:

  * `setup`  — the tCG start at s = 0 (z = P r, ⟨r, z⟩, the stopping
    threshold) and this iteration's tCG cap (ramp or full budget);
  * `block`  — `block` masked tCG iterations: once the tCG is done (or at
    its cap) every update keeps the old value, so extra iterations change
    nothing, as the JAX body's `lax.while_loop` never runs them;
  * `step`   — retract, f and gradient, ρ, accept, Δ, streaks, status, the
    ramp boundary (promote or ramp exit) and the history row at the
    device's k.

The host reads one flag per block (`done`) and (k, status) once per outer
iteration. On a CUDA device each step function is captured once as a CUDA
graph (`torch.cuda.CUDAGraph`, after a warm-up on a side stream) and
replayed; on the CPU, and on the card inside `device_loop(graphs=False)`,
the same functions run eagerly. Every comparison runs on the device in
the state's dtype, so the float32 path decides as the JAX package's
float32 program does, and the selected values are the same floats whether
the loop runs eagerly, captured, or at any block size.

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
from cora_tpu_torch.utils import graphs as loops
from cora_tpu_torch.utils.graphs import (  # noqa: F401 (the loop's names)
    clear_graphs,
    copy_into as _copy_into,
    device_loop,
)

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
# tCG iterations per captured block on the card, from the measured tCG
# lengths and costs (PERF.md §6); an eager loop reads `done` after every
# iteration, since a masked iteration costs it a full dispatch
TCG_BLOCK = 4

# what the loop did, summed over levels until `reset_loop_stats()`:
# captures and their seconds, graph replays, eager step calls, host reads
# inside the loop (one per block, one per outer iteration), blocks, outer
# and tCG iterations
LOOP_STATS = dict(captures=0, capture_s=0.0, replays=0, eager_calls=0,
                  host_reads=0, blocks=0, outer_iters=0, tcg_iters=0)


def reset_loop_stats():
    loops.reset_stats(LOOP_STATS)


def _inner(a, b):
    """Trace inner product ⟨A, B⟩ = tr(AᵀB) (reference `CORA.cpp:119-122`)."""
    return (a * b).sum()


def _pgrad_norm(grad, pgrad, gradnorm):
    """√⟨grad, P grad⟩, or ‖grad‖ where float32 cancellation makes the
    inner product non-positive (a clamp to 0 would read as converged)."""
    inner = _inner(grad, pgrad)
    return torch.where(inner > 0, torch.sqrt(torch.clamp(inner, min=0.0)),
                       gradnorm)


def tcg_start(grad, z, cap, kappa: float, theta: float) -> dict:
    """The tCG state at s = 0 from r = grad and z = P·grad: s, r, d, ⟨r, z⟩,
    the M-norm bookkeeping (φ = ⟨s,Ms⟩, σ = ⟨s,Md⟩, ⟨d,Md⟩), the model
    decrease, the iteration count, `done`, `hit`, the stopping threshold
    on ⟨r, z⟩ (the superlinear rule) and the iteration `cap` (an int64
    scalar). A non-positive ⟨r, z⟩ (zero preconditioned gradient) or cap
    starts done."""
    tiny = torch.finfo(grad.dtype).tiny
    rz = _inner(grad, z)
    zero = torch.zeros_like(rz)
    return dict(
        s=torch.zeros_like(grad), r=grad, d=-z, rz=rz,
        phi=zero, sigma=zero, dmd=rz, mdec=zero,
        k=torch.zeros_like(cap), done=(rz <= 0) | (cap <= 0),
        hit=torch.zeros_like(rz, dtype=torch.bool),
        rz_stop=rz * torch.clamp(torch.pow(torch.sqrt(rz) + tiny, theta),
                                 max=kappa) ** 2,
        cap=cap)


def tcg_iteration(t: dict, hess: Callable, precon: Callable, delta) -> dict:
    """One masked Steihaug–Toint iteration (the JAX `body`,
    `cora_tpu/solve/tnt.py:131-185`): both the boundary and the interior
    step are computed and one is selected, and once `t["done"]` every
    value keeps its old one."""
    tiny = torch.finfo(t["s"].dtype).tiny
    s, r, d, rz = t["s"], t["r"], t["d"], t["rz"]
    phi, sigma, dmd, mdec = t["phi"], t["sigma"], t["dmd"], t["mdec"]
    Hd = hess(d)
    dHd = _inner(d, Hd)
    alpha = rz / torch.where(dHd == 0, tiny, dHd)
    phi_next = phi + 2.0 * alpha * sigma + alpha * alpha * dmd
    stop_here = (phi_next >= delta * delta) | (dHd <= 0)
    # the boundary step: ‖s + τ d‖_M = Δ, τ ≥ 0
    disc = torch.clamp(sigma * sigma + dmd * (delta * delta - phi), min=0.0)
    tau = (-sigma + torch.sqrt(disc)) / torch.where(dmd == 0, tiny, dmd)
    r_new = r + alpha * Hd
    z = precon(r_new)
    rz_new = _inner(r_new, z)
    beta = rz_new / torch.where(rz == 0, tiny, rz)
    k = t["k"] + 1
    new = dict(
        s=torch.where(stop_here, s + tau * d, s + alpha * d),
        r=r_new, d=-z + beta * d, rz=rz_new,
        phi=torch.where(stop_here, phi, phi_next),
        sigma=beta * (sigma + alpha * dmd),
        dmd=rz_new + beta * beta * dmd,
        mdec=torch.where(stop_here, mdec + tau * rz - 0.5 * tau * tau * dHd,
                         mdec + 0.5 * alpha * rz),
        k=k,
        done=stop_here | (rz_new <= t["rz_stop"]) | (k >= t["cap"]),
        hit=t["hit"] | stop_here)
    keep = t["done"]
    out = {key: torch.where(keep, t[key], v) for key, v in new.items()}
    out["rz_stop"], out["cap"] = t["rz_stop"], t["cap"]
    return out


def steihaug_toint_tcg(grad, hess: Callable, precon: Callable, delta,
                       max_iters: int, kappa: float, theta: float,
                       block: int = 1):
    """Preconditioned truncated CG for the trust-region subproblem

        min_s ⟨grad, s⟩ + ½⟨s, H s⟩   s.t.  ‖s‖_M ≤ Δ,   M = P⁻¹,

    in masked blocks of `block` iterations, reading `done` after each.
    Returns (s, model decrease, boundary hit, iterations)."""
    cap = torch.full((), int(max_iters), dtype=torch.int64,
                     device=grad.device)
    t = tcg_start(grad, precon(grad), cap, kappa, theta)
    while True:
        for _ in range(block):
            t = tcg_iteration(t, hess, precon, delta)
        if bool(t["done"]):
            return t["s"], t["mdec"], bool(t["hit"]), int(t["k"])


def _f_and_grad(pd, Y, op=None):
    nablaF = op(Y) if op is not None else data_matrix_product(pd, Y)
    return 0.5 * _inner(Y, nablaF), \
        tangent_space_projection(pd, Y, nablaF), nablaF


class _Level:
    """The device loop of one TNT level: the carry in fixed-address
    buffers and the three step functions over them, eager or captured.

    Buffers: the iterate state (`Y`, `f`, `grad`, `nablaF`, norms, `Delta`,
    streaks, `finish`), `ks` = [k, status] (read together), the (5, H)
    histories (f, ‖grad‖, √⟨g,Pg⟩, ‖s‖, tCG iterations), the (H, N, r)
    iterate log when asked for, the level's scalars (Δ₀, the lift
    threshold, the stall threshold and window, the ramp length and the
    tCG caps), and the tCG state. Each step function ends by copying its
    results into the buffers, so a captured graph reads and writes only
    them, and nothing outside a graph holds one of its pool's tensors."""

    def __init__(self, pd, Y0, precon, params: TNTParams, op, history_len,
                 log_iterates, block, graphs, sync_debug=False):
        self.pd, self.precon, self.op, self.params = pd, precon, op, params
        self.block, self.graphs, self.sync_debug = block, graphs, sync_debug
        N, r = Y0.shape
        dt, dev = Y0.dtype, Y0.device

        def scalar(dtype=dt):
            return torch.zeros((), dtype=dtype, device=dev)

        def state():
            return torch.zeros((N, r), dtype=dt, device=dev)

        i64 = torch.int64
        self.c = dict(Y=state(), f=scalar(), grad=state(), nablaF=state(),
                      gradnorm=scalar(), pgradnorm=scalar(), Delta=scalar(),
                      dec_streak=scalar(i64), step_streak=scalar(i64),
                      finish=scalar(torch.bool))
        self.ks = torch.zeros(2, dtype=i64, device=dev)
        self.hist = torch.zeros((5, history_len), dtype=dt, device=dev)
        self.iterates = (torch.zeros((history_len, N, r), dtype=dt,
                                     device=dev) if log_iterates else None)
        self.lv = dict(delta0=scalar(), lift=scalar(), stall_rel=scalar(),
                       sw=scalar(i64), ramp_until=scalar(i64),
                       tcg_cap=scalar(i64), ramp_tcg=scalar(i64))
        self.t = dict(s=state(), r=state(), d=state(), rz=scalar(),
                      phi=scalar(), sigma=scalar(), dmd=scalar(),
                      mdec=scalar(), k=scalar(i64), done=scalar(torch.bool),
                      hit=scalar(torch.bool), rz_stop=scalar(),
                      cap=scalar(i64))
        self.loop = loops.StepGraphs(
            dict(setup=self._setup, block=self._block, step=self._step),
            LOOP_STATS, graphs, dev, sync_debug, scope="tnt")

    # --- the operators at the carry's point --------------------------------

    def _prec(self, Y, v):
        return tangent_space_projection(self.pd, Y, self.precon(v))

    def _prec_at_Y(self, v):
        return self._prec(self.c["Y"], v)

    def _hess(self, v):
        c = self.c
        return riemannian_hvp(self.pd, c["Y"], c["nablaF"], v, op=self.op)

    # --- level start (eager, once per call) ---------------------------------

    def start(self, Y0, ramp_until, tcg_cap, ramp_tcg, lift_grad_norm,
              stall_window, stall_tol):
        """Load Y0 and the level's scalars; f, gradient, norms and the
        starting status at Y0, empty histories."""
        p, c, lv = self.params, self.c, self.lv
        dt = Y0.dtype
        c["Y"].copy_(Y0)
        f0, grad0, nablaF0 = _f_and_grad(self.pd, c["Y"], self.op)
        gn0 = torch.sqrt(_inner(grad0, grad0))
        pgn0 = _pgrad_norm(grad0, self._prec(c["Y"], grad0), gn0)
        for key, v in (("f", f0), ("grad", grad0), ("nablaF", nablaF0),
                       ("gradnorm", gn0), ("pgradnorm", pgn0)):
            c[key].copy_(v)
        c["Delta"].fill_(p.delta0)
        c["dec_streak"].zero_()
        c["step_streak"].zero_()
        c["finish"].zero_()
        self.hist.zero_()
        if self.iterates is not None:
            self.iterates.zero_()
        lv["delta0"].fill_(p.delta0)
        lv["lift"].fill_(lift_grad_norm)
        sw = int(stall_window)
        lv["stall_rel"].copy_(torch.tensor(float(sw), dtype=dt)
                              * torch.tensor(stall_tol, dtype=dt))
        lv["sw"].fill_(sw)
        lv["ramp_until"].fill_(ramp_until)
        lv["tcg_cap"].fill_(tcg_cap)
        lv["ramp_tcg"].fill_(ramp_tcg)
        self.ks[0] = 0
        self.ks[1:].copy_(torch.where(
            gn0 <= p.gradient_tolerance, GRAD_TOL,
            torch.where(pgn0 <= p.preconditioned_gradient_tolerance,
                        PRECON_GRAD_TOL, RUNNING)).view(1).to(self.ks))

    # --- the step functions -------------------------------------------------

    def _in_ramp(self):
        return ~self.c["finish"] & (self.ks[0] < self.lv["ramp_until"])

    def _setup(self, commit=True):
        c, lv = self.c, self.lv
        cap = torch.where(self._in_ramp(), lv["ramp_tcg"], lv["tcg_cap"])
        t = tcg_start(c["grad"], self._prec_at_Y(c["grad"]), cap,
                      self.params.kappa_fgr, self.params.theta)
        if commit:
            _copy_into(self.t, t)

    def _block(self, commit=True):
        t = self.t
        delta = self.c["Delta"]
        for _ in range(self.block):
            t = tcg_iteration(t, self._hess, self._prec_at_Y, delta)
        if commit:
            _copy_into(self.t, t)

    def _step(self, commit=True):
        """The outer iteration after its tCG (the JAX body,
        `cora_tpu/solve/tnt.py:331-452`)."""
        p, c, lv, t, pd = self.params, self.c, self.lv, self.t, self.pd
        tiny = torch.finfo(c["f"].dtype).tiny
        k = self.ks[0]
        Y, f, Delta = c["Y"], c["f"], c["Delta"]
        s, mdec, hit = t["s"], t["mdec"], t["hit"]
        Y_prop = retract(pd, Y, s)
        f_prop, grad_prop, nablaF_prop = _f_and_grad(pd, Y_prop, self.op)
        step_norm = torch.sqrt(_inner(s, s))
        rho = (f - f_prop) / torch.where(mdec == 0, tiny, mdec)
        rel_decrease = (f - f_prop) / (f.abs() + tiny)
        accept = (rho >= p.eta1) & (mdec > 0)
        very_successful = rho >= p.eta2
        small_dec = rel_decrease < p.relative_decrease_tolerance
        small_step = step_norm < p.stepsize_tolerance
        gn_prop = torch.sqrt(_inner(grad_prop, grad_prop))
        pgn_prop = _pgrad_norm(grad_prop, self._prec(Y_prop, grad_prop),
                               gn_prop)
        f_new = torch.where(accept, f_prop, f)
        gradnorm = torch.where(accept, gn_prop, c["gradnorm"])
        pgradnorm = torch.where(accept, pgn_prop, c["pgradnorm"])
        Delta_new = torch.where(
            accept, torch.where(very_successful & hit, p.alpha2 * Delta,
                                Delta), p.alpha1 * Delta)
        zero = torch.zeros_like(k)
        dec_streak = torch.where(accept, torch.where(
            small_dec, c["dec_streak"] + 1, zero), c["dec_streak"])
        step_streak = torch.where(accept, torch.where(
            small_step, c["step_streak"] + 1, zero), c["step_streak"])
        # f over the stall window, with this iteration's row written first
        lag = torch.clamp(k - lv["sw"], min=0)
        f_lag = torch.where(lag == k, f_new,
                            self.hist[0].index_select(0, lag.view(1))[0])
        status = torch.where(
            gradnorm <= p.gradient_tolerance, GRAD_TOL, torch.where(
                pgradnorm <= p.preconditioned_gradient_tolerance,
                PRECON_GRAD_TOL, torch.where(
                    dec_streak >= STREAK, REL_DECREASE, torch.where(
                        step_streak >= STREAK, STEPSIZE, torch.where(
                            Delta_new < p.delta_tolerance, DELTA_TOL,
                            RUNNING)))))
        plateaued = (lv["sw"] > 0) & (k >= lv["sw"]) & (
            (f_lag - f_new) < lv["stall_rel"] * f_new.abs())
        in_ramp = self._in_ramp()
        boundary = in_ramp & ((k + 1 == lv["ramp_until"]) | plateaued) & (
            status == RUNNING)
        stall_now = (status == REL_DECREASE) | (status == STEPSIZE) | (
            status == DELTA_TOL)
        far, near = gradnorm > lv["lift"], gradnorm <= lv["lift"]
        promote = (in_ramp & stall_now) | (boundary & near)
        status = torch.where(boundary & far, RAMP_EXIT,
                             torch.where(promote, RUNNING, status))
        new = dict(
            Y=torch.where(accept, Y_prop, Y), f=f_new,
            grad=torch.where(accept, grad_prop, c["grad"]),
            nablaF=torch.where(accept, nablaF_prop, c["nablaF"]),
            gradnorm=gradnorm, pgradnorm=pgradnorm,
            Delta=torch.where(promote, lv["delta0"], Delta_new),
            dec_streak=torch.where(promote, zero, dec_streak),
            step_streak=torch.where(promote, zero, step_streak),
            finish=c["finish"] | promote)
        row = torch.stack([f_new, gradnorm, pgradnorm,
                           torch.where(accept, step_norm,
                                       torch.zeros_like(step_norm)),
                           t["k"].to(f_new.dtype)])
        ks = torch.stack([k + 1, status])
        if commit:
            at = k.view(1)
            self.hist.index_copy_(1, at, row[:, None])
            if self.iterates is not None:
                self.iterates.index_copy_(0, at, new["Y"][None])
            _copy_into(c, new)
            self.ks.copy_(ks)

    # --- driving ------------------------------------------------------------

    def outer_iteration(self):
        """One TNT iteration: tCG set-up, blocks until `done`, the step.
        Returns (k, status) after it."""
        self.loop.run("setup")
        while True:
            self.loop.run("block")
            LOOP_STATS["blocks"] += 1
            if self.loop.read(self.t["done"]):
                break
        self.loop.run("step")
        LOOP_STATS["outer_iters"] += 1
        return self.loop.read(self.ks)


def _level_for(pd, Y0, precon, params, op, history_len, log_iterates,
               block, graphs, sync_debug) -> _Level:
    """The level's loop: eager levels are built per call; a captured level
    is kept and reused while (problem data, operator, preconditioner,
    shape, dtype, parameters, history length, log, block) stay the same,
    and freed when any of them changes."""
    if not graphs:
        return _Level(pd, Y0, precon, params, op, history_len, log_iterates,
                      block, False)
    key = (id(pd), id(op), id(precon), tuple(Y0.shape), Y0.dtype,
           Y0.device, tuple(dataclasses.asdict(params).items()), history_len,
           log_iterates, block)

    def make():
        return _Level(pd, Y0, precon, params, op, history_len, log_iterates,
                      block, True, sync_debug)

    lvl = loops.keep("tnt", key, make, fresh=sync_debug)
    if lvl.pd is not pd or lvl.op is not op or lvl.precon is not precon:
        lvl = loops.keep("tnt", key, make, fresh=True)
    return lvl


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
    max_iterations_override: int | None = None,
    max_tcg_override: int | None = None,
    max_time: float | None = None,
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
    iterations below `ramp_iterations` get the cheap `ramp_tcg` inner
    budget; at the ramp's end (its budget, or an objective plateau over
    `stall_window` iterations) a level with |grad| > `lift_grad_norm`
    exits with status `ramp_exit`, any other continues at the full tCG
    budget with the trust region restarted at Δ₀; a stall status during
    the ramp also promotes to the finish. The ramp budget rides on top of
    the finish budget. `max_iterations_override` and `max_tcg_override`
    lower the outer and tCG caps below `params`' (never above), and
    `max_time` replaces `params.max_computation_time`, as the JAX
    package's `tnt_solve` takes them. On a CUDA device the loop's step
    functions run as captured CUDA graphs unless
    `device_loop(graphs=False)` is in force.
    """
    params = params or TNTParams()
    t0 = time.time()
    opts = loops.options()
    ramp_until = max(int(ramp_iterations), 0)
    iter_cap = min(max_iterations_override or params.max_iterations,
                   params.max_iterations) + ramp_until
    tcg_cap = min(max_tcg_override or params.max_tcg_iterations,
                  params.max_tcg_iterations)
    ramp_tcg = min(int(ramp_tcg) if ramp_tcg > 0 else tcg_cap, tcg_cap)
    if max_time is None:
        max_time = params.max_computation_time
    graphs = Y0.device.type == "cuda" and opts.graphs
    block = opts.block_of("block", TCG_BLOCK, graphs)

    lvl = _level_for(pd, Y0, precon, params, op, iter_cap, log_iterates,
                     block, graphs, opts.sync_debug)
    lvl.start(Y0, ramp_until, tcg_cap, ramp_tcg, lift_grad_norm,
              stall_window, stall_tol)
    k, status = lvl.ks.tolist()
    timed_out = False
    chunk_iters = CHUNK_ITERS
    elapsed = clock or (lambda t: time.time() - t)
    while status == RUNNING and k < iter_cap:
        if k > 0 and max_time is not None:
            spent = elapsed(t0)
            per_iter = max(spent / max(k, 1), 1e-6)
            remaining = max(max_time - spent, 0.0)
            chunk_iters = int(min(max(remaining * 0.5 / per_iter, 8),
                                  CHUNK_ITERS))
        stop_at = min(k + chunk_iters, iter_cap)
        while k < stop_at and status == RUNNING:
            k, status = lvl.outer_iteration()
        if (status == RUNNING and k < iter_cap and max_time is not None
                and elapsed(t0) > max_time):
            timed_out = True
            break

    h = lvl.hist[:, :k].cpu().numpy()
    LOOP_STATS["tcg_iters"] += int(h[4].sum())
    if status == RUNNING:
        status = TIME_CAP if timed_out else MAX_ITERS
    c = lvl.c
    f, gn, pgn = (float(v) for v in torch.stack(
        [c["f"], c["gradnorm"], c["pgradnorm"]]).tolist())
    return TNTResult(
        f=f,
        x=c["Y"].clone(),
        gradfx_norm=gn,
        preconditioned_gradfx_norm=pgn,
        num_iterations=k,
        inner_iterations=h[4].astype(np.int32),
        objective_values=h[0],
        gradient_norms=h[1],
        preconditioned_gradient_norms=h[2],
        update_step_norms=h[3],
        elapsed_time=time.time() - t0,
        status=STATUS_NAMES.get(status, str(status)),
        iterates=(None if lvl.iterates is None else
                  list(lvl.iterates[:k].detach().cpu().double().numpy())),
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
