"""TNT trust-region solves and the saddle escape on the chain kernels.

Mirrors the JAX package's `cora_tpu.solve.tnt_tiles` (same TNT
parameters, status codes, ramp→finish semantics, adaptive plateau pacing
and chunked host time-cap checks) on the canonical (N, r) state: each chunk of outer
iterations is ONE `chunk` launch (`cora_tpu_torch.ops.tnt_kernels`), and
between chunks only the 12 scalars come back to the host, for the
wall-clock cap (reference `max_computation_time`, `src/CORA.cpp:106`).
A level counts its host reads inside the loop (two per chunk), outer and
tCG iterations into `tnt.LOOP_STATS`, as the canonical path's levels do,
and the chain kernels' group barriers, worked out from those counts.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cora_tpu_torch.ops import chain
from cora_tpu_torch.ops.tnt_kernels import kernels_for
from cora_tpu_torch.solve.tnt import (
    CHUNK_ITERS,
    LOOP_STATS,
    MAX_ITERS,
    RUNNING,
    STATUS_NAMES,
    TIME_CAP,
    HashableParams,
)
from cora_tpu_torch.types import TNTParams, TNTResult
from cora_tpu_torch.utils.timing import named_scope

N_ALPHAS = 24  # saddle-escape step lengths per sign (reference CORA.cpp:245-350)


def tnt_solve_tiles(
    kern,
    Y0: torch.Tensor,
    params: TNTParams | None = None,
    ramp_iterations: int = 0,
    ramp_tcg: int = 0,
    lift_grad_norm: float = float("inf"),
    stall_window: int = 0,
    stall_tol: float = 0.0,
) -> TNTResult:
    """One TNT solve from Y0 with `kern` (a `CudaTNT` or `PlainTNT`)."""
    params = params or TNTParams()
    plan = kern.plan
    t0 = time.time()
    iter_cap = params.max_iterations + max(int(ramp_iterations), 0)
    tcg_cap = params.max_tcg_iterations
    max_time = params.max_computation_time

    # the first chunk evaluates f/grad/nablaF in-kernel (init flag):
    # grad/nablaF enter as zeros and one launch does init + loop
    Y = Y0.to(plan.device, plan.dtype).contiguous().clone()
    grad = torch.zeros_like(Y)
    nablaF = torch.zeros_like(Y)
    H = int(iter_cap)
    hist = torch.zeros((5, H), dtype=plan.dtype, device=plan.device)
    fscal = torch.zeros(8, dtype=plan.dtype, device=plan.device)
    iscal = torch.zeros(12, dtype=torch.int32, device=plan.device)
    f = gn = pgn = 0.0
    k, status = 0, RUNNING
    Delta = float(params.delta0)
    finish = dec = stp = 0
    init_flag = 1
    timed_out = False
    # the FIRST chunk is a 0-iteration init-only launch, so the level's
    # clock starts from real state; the next chunk is small (8) to give
    # the host an early per-iteration cost sample, so the per-rank time
    # cap is enforceable from the start
    chunk_iters = 8
    first_call = True
    launches = 0
    while (status == RUNNING and k < iter_cap) or first_call:
        if k > 0 and max_time is not None:
            per_iter = max((time.time() - t0) / max(k, 1), 1e-6)
            remaining = max(max_time - (time.time() - t0), 0.0)
            chunk_iters = int(
                min(max(remaining * 0.5 / per_iter, 8), CHUNK_ITERS))
        chunk_end = min(k, iter_cap) if first_call else min(
            k + chunk_iters, iter_cap)
        fscal.copy_(torch.tensor(
            [f, gn, pgn, Delta, lift_grad_norm, stall_tol, 0.0, 0.0],
            dtype=fscal.dtype))
        iscal.copy_(torch.tensor(
            [k, status, finish, dec, stp, chunk_end, tcg_cap,
             int(ramp_iterations), int(ramp_tcg), int(stall_window),
             init_flag, 0], dtype=torch.int32))
        init_flag = 0
        with named_scope("tnt/chunk"):
            kern.chunk(Y, grad, nablaF, fscal, iscal, hist)
            launches += 1
            f, gn, pgn, Delta = (float(x) for x in fscal[:4].tolist())
            k, status, finish, dec, stp = (int(x) for x in iscal[:5].tolist())
        LOOP_STATS["host_reads"] += 2
        if first_call:
            first_call = False
            t0 = time.time()
        if (
            status == RUNNING and k < iter_cap
            and max_time is not None
            and time.time() - t0 > max_time
        ):
            timed_out = True
            break

    h = hist[:, :k].cpu().numpy()
    LOOP_STATS["outer_iters"] += k
    LOOP_STATS["tcg_iters"] += int(h[4].sum())
    kern.count_chunks(launches, k, int(h[4].sum()))
    elapsed = time.time() - t0
    if status == RUNNING:
        status = TIME_CAP if timed_out else MAX_ITERS
    return TNTResult(
        f=f,
        x=Y,
        gradfx_norm=gn,
        preconditioned_gradfx_norm=pgn,
        num_iterations=k,
        inner_iterations=h[4].astype(np.int32),
        objective_values=h[0],
        gradient_norms=h[1],
        preconditioned_gradient_norms=h[2],
        update_step_norms=h[3],
        elapsed_time=elapsed,
        status=STATUS_NAMES.get(status, str(status)),
        iterates=None,
    )


def get_kernel_backend(problem, params: TNTParams, max_cond: float = 1e6,
                       dtype=np.float32, device="cuda",
                       use_kernels: str = "auto"):
    """The TNT kernels (`CudaTNT` or `PlainTNT`) for this problem, cached
    on the problem. The chain plan (constants + banded factor) is built
    once per (dtype, device, max_cond); the kernels read the rank from the
    state, so one backend serves every rank. Raises NotImplementedError
    for a graph the chain plan does not cover."""
    hp = params if isinstance(params, HashableParams) else HashableParams(params)
    key = (np.dtype(dtype).name, str(torch.device(device)), float(max_cond),
           use_kernels, hp)
    cache = getattr(problem, "_kernel_cache", None)
    if cache is None:
        cache = problem._kernel_cache = {}
    if key not in cache:
        plan = get_chain_plan(problem, dtype, device, max_cond)
        cache[key] = kernels_for(plan, hp, use_kernels)
    return cache[key]


def get_chain_plan(problem, dtype=np.float32, device="cuda",
                   max_cond: float = 1e6) -> chain.ChainPlan:
    """`build_chain_plan`, cached on the problem (on the card unless the
    caller asks for another device)."""
    key = (np.dtype(dtype).name, str(torch.device(device)), float(max_cond))
    cache = getattr(problem, "_chain_plan_cache", None)
    if cache is None:
        cache = problem._chain_plan_cache = {}
    if key not in cache:
        cache[key] = chain.build_chain_plan(problem, dtype=dtype,
                                            device=device, max_cond=max_cond)
    return cache[key]


def saddle_escape_tiles(
    kern,
    Y: torch.Tensor,
    theta: float,
    v,
    gradient_tolerance: float = 1e-4,
    preconditioned_gradient_tolerance: float = 1e-4,
    alpha_min: float = 1e-6,
    verbose: bool = False,
) -> torch.Tensor:
    """Saddle escape (reference `src/CORA.cpp:245-350`): the whole ±α trial
    ladder is ONE `ladder` call, then one `step` retracts along the
    chosen direction; the largest step is α₀ = max(16·`alpha_min`,
    100·tol/|θ|, 1), as in the JAX package. Returns the rank-(r+1)
    state."""
    plan = kern.plan
    N, r = Y.shape
    Y_aug = torch.cat(
        [Y.to(plan.device, plan.dtype),
         torch.zeros((N, 1), dtype=plan.dtype, device=plan.device)],
        dim=1).contiguous()
    Ydot = torch.zeros_like(Y_aug)
    Ydot[:, -1] = torch.as_tensor(np.asarray(v).reshape(N)).to(Ydot)

    _, _, _, scal = kern.step(Y_aug, torch.zeros_like(Y_aug), False)
    f_saddle = float(scal[0])

    alpha0 = max(16 * alpha_min, 100 * gradient_tolerance / abs(theta), 1.0)
    alphas = alpha0 * 0.5 ** np.arange(N_ALPHAS)
    signed = np.stack([alphas, -alphas], axis=1).reshape(-1)
    out = kern.ladder(Y_aug, Ydot, torch.as_tensor(signed, dtype=plan.dtype))
    f, gn, pgn = out.cpu().numpy()

    ok = (
        (f < f_saddle)
        & (gn > gradient_tolerance)
        & (pgn > preconditioned_gradient_tolerance)
    )
    if ok.any():
        best = int(np.argmax(ok))  # largest acceptable step first
    elif float(f.min()) < f_saddle:
        best = int(np.argmin(f))
    else:
        if verbose:
            print("WARNING: saddle-escape line search failed to escape "
                  "the saddle point")
        return Y_aug
    a = torch.tensor(float(signed[best]), dtype=plan.dtype)
    Yn, _, _, _ = kern.step(Y_aug, (a.to(plan.device) * Ydot).contiguous(),
                            True)
    return Yn
