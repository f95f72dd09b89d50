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
from cora_tpu_torch.utils import graphs as loops
from cora_tpu_torch.utils.device import check_device

# zero columns are exactly invariant under the whole polish; the JAX
# package pads to one width to compile once, and the port keeps the same
# width so that both polish the same problem
POLISH_PAD_RANK = 6
# the Armijo ladder's step lengths, largest first
ALPHAS = 0.5 ** np.arange(16, dtype=np.float64)
# CG iterations per captured block (chosen on the card, PERF.md §6); eager
# loops read after every iteration
CG_BLOCK = 4
# what the Newton-CG loops did, summed until `reset_loop_stats()`: captures
# and their seconds, replays, eager step calls, host reads (one per block,
# one per Newton step), blocks, CG iterations and Newton steps
LOOP_STATS = dict(captures=0, capture_s=0.0, replays=0, eager_calls=0,
                  host_reads=0, blocks=0, cg_iters=0, newton_steps=0)


def reset_loop_stats():
    loops.reset_stats(LOOP_STATS)


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


class _NewtonCG:
    """The damped-Newton direction's CG as a device loop (the JAX
    package's `lax.while_loop` inside its jitted `newton_step`,
    `cora_tpu/solve/polish.py:300-328`): the iterate Y, τ and the CG cap
    are buffers filled before each step; `setup` forms f, the gradient and
    the CG start, `block` runs `CG_BLOCK` masked CG iterations (once done
    or at the cap every value keeps its old one), and `finish` takes the
    descent test, the fallback to −z₀ and packs (f, ‖grad‖, ⟨grad, s⟩,
    iterations) for the step's one read. On a CUDA device the three are
    captured once per problem (the rank is padded to `POLISH_PAD_RANK`)
    and replayed; the host reads the stop flag once per block."""

    def __init__(self, pd, precon, N, r, device, block, graphs,
                 sync_debug=False):
        self.pd, self.precon, self.block = pd, precon, block
        f64, i64 = torch.float64, torch.int64

        def buf(*shape, dt=f64):
            return torch.zeros(shape, dtype=dt, device=device)

        self.Y, self.tau, self.cap = buf(N, r), buf(), buf(dt=i64)
        self.c = dict(nablaF=buf(N, r), grad=buf(N, r), z0=buf(N, r),
                      f=buf(), gn=buf(), rz0=buf(), rz_stop=buf())
        self.t = dict(s=buf(N, r), r=buf(N, r), d=buf(N, r), rz=buf(),
                      k=buf(dt=i64), done=buf(dt=torch.bool))
        self.stop = buf(dt=torch.bool)
        self.out = buf(4)
        self.loop = loops.StepGraphs(
            dict(setup=self._setup, block=self._block, finish=self._finish),
            LOOP_STATS, graphs, device, sync_debug, scope="polish")

    def _prec(self, v):
        return rm.tangent_space_projection(self.pd, self.Y,
                                           self.precon(v))

    def _hess(self, v):
        return rm.riemannian_hvp(self.pd, self.Y, self.c["nablaF"],
                                 v) + self.tau * v

    def _setup(self, commit=True):
        pd, Y = self.pd, self.Y
        nablaF = data_matrix_product(pd, Y)
        grad = rm.tangent_space_projection(pd, Y, nablaF)
        z0 = self._prec(grad)
        rz0 = _dot(grad, z0)
        c = dict(nablaF=nablaF, grad=grad, z0=z0, f=0.5 * _dot(Y, nablaF),
                 gn=torch.sqrt(_dot(grad, grad)), rz0=rz0,
                 rz_stop=rz0 * torch.clamp(torch.sqrt(torch.clamp(
                     rz0, min=0.0)), max=0.25) ** 2)
        done = (rz0 <= 0) | (self.cap <= 0)
        t = dict(s=torch.zeros_like(grad), r=grad, d=-z0, rz=rz0,
                 k=torch.zeros_like(self.t["k"]), done=rz0 <= 0)
        if commit:
            loops.copy_into(self.c, c)
            loops.copy_into(self.t, t)
            self.stop.copy_(done)

    def _iteration(self, t):
        """One masked CG iteration (the JAX body, `cora_tpu/solve/
        polish.py:306-319`): negative-curvature truncation, superlinear
        forcing term."""
        tiny = torch.finfo(torch.float64).tiny
        s, r, d, rz, k = t["s"], t["r"], t["d"], t["rz"], t["k"]
        Hd = self._hess(d)
        dHd = _dot(d, Hd)
        neg = dHd <= 0
        alpha = rz / torch.where(dHd == 0, tiny, dHd)
        r_new = r + alpha * Hd
        z = self._prec(r_new)
        rz_new = _dot(r_new, z)
        beta = rz_new / torch.where(rz == 0, tiny, rz)
        new = dict(s=torch.where(neg, torch.where(k == 0, d, s),
                                 s + alpha * d),
                   r=r_new, d=-z + beta * d, rz=rz_new, k=k + 1,
                   done=neg | (rz_new <= self.c["rz_stop"]))
        active = ~t["done"] & (k < self.cap)
        return {key: torch.where(active, v, t[key]) for key, v in new.items()}

    def _block(self, commit=True):
        t = self.t
        for _ in range(self.block):
            t = self._iteration(t)
        if commit:
            loops.copy_into(self.t, t)
            self.stop.copy_(t["done"] | (t["k"] >= self.cap))

    def _finish(self, commit=True):
        c, s = self.c, self.t["s"]
        gdir = _dot(c["grad"], s)
        # not a descent direction: preconditioned steepest descent
        descent = gdir < 0
        s = torch.where(descent, s, -c["z0"])
        gdir = torch.where(descent, gdir, -c["rz0"])
        out = torch.stack([c["f"], c["gn"], gdir,
                           self.t["k"].to(torch.float64)])
        if commit:
            self.t["s"].copy_(s)
            self.out.copy_(out)

    def step(self, Y, tau: float, max_cg: int):
        """(f, ‖grad‖, ⟨grad, s⟩, CG iterations) at Y; s and the gradient
        stay in the buffers."""
        self.Y.copy_(Y)
        self.tau.fill_(tau)
        self.cap.fill_(int(max_cg))
        self.loop.run("setup")
        ran = 0
        while True:
            self.loop.run("block")
            LOOP_STATS["blocks"] += 1
            ran += self.block
            # no read once the blocks have covered the cap
            if ran >= max_cg or self.loop.read(self.stop):
                break
        self.loop.run("finish")
        f, gn, gdir, k = self.loop.read(self.out)
        LOOP_STATS["newton_steps"] += 1
        LOOP_STATS["cg_iters"] += int(k)
        return f, gn, gdir, int(k)


def _newton_loop(pd, precon, Y) -> _NewtonCG:
    """The Newton-CG loop for Y's shape: built per call when eager; kept
    while (problem data, preconditioner, shape, block) hold when captured,
    so one capture serves every polish of a problem."""
    opts = loops.options()
    graphs = Y.device.type == "cuda" and opts.graphs
    block = opts.block_of("cg_block", CG_BLOCK, graphs)

    def make():
        return _NewtonCG(pd, precon, *Y.shape, Y.device, block, graphs,
                         opts.sync_debug)

    if not graphs:
        return make()
    key = (id(pd), id(precon), tuple(Y.shape), Y.device, block,
           opts.sync_debug)
    nl = loops.keep("polish", key, make)
    if nl.pd is not pd or nl.precon is not precon:
        nl = loops.keep("polish", key, make, fresh=True)
    return nl


def newton_step(pd, precon, Y, tau: float, max_cg: int):
    """f and grad at Y, plus the damped-Newton direction s from a
    preconditioned CG solve of (Hess + τI)s = −grad (negative-curvature
    truncation, superlinear forcing term), as a device loop (`_NewtonCG`).
    Returns (f, grad, ‖grad‖, s, ⟨grad, s⟩, CG iterations)."""
    nl = _newton_loop(pd, precon, Y)
    f, gn, gdir, k = nl.step(Y, tau, max_cg)
    return f, nl.c["grad"].clone(), gn, nl.t["s"].clone(), gdir, k


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
