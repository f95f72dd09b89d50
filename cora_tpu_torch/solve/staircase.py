"""The Riemannian staircase: solve → certify → escape → … → round → refine.

Parity with `solveCORA` (reference `src/CORA.cpp:26-243`) and with the
JAX package's `cora_tpu.solve.staircase`, whose control flow this module
keeps:

  * per-rank TNT solve (the `chunk` kernel) with the reference's
    hardcoded parameters, a cheap-tCG ramp and a full-budget finish;
  * ramp levels that end far from criticality lift the rank with a small
    random column instead of certifying;
  * near-critical levels: trim dead columns, pre-certify at the float32
    point, polish in float64, re-certify at the polished point;
  * certification threshold η = clamp(f · 5e-6, 1e-7, 1e-1)
    (`CORA.cpp:112-116,154`), NaN-θ retry with doubled η
    (`CORA_problem.cpp:1076-1083`);
  * saddle escape (`step` + `ladder` kernels) with rank increment on
    certification failure;
  * post-loop rank-d rounding + TNT refine + final polish and certificate
    (`CORA.cpp:200-233`).

The port covers the main path: the explicit formulation, the
RegularizedCholesky preconditioner and chain graphs. Anything else raises
NotImplementedError; nothing falls back silently.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cora_tpu_torch.graph.problem import Problem
from cora_tpu_torch.ops import chain
from cora_tpu_torch.solve.certify import certify_solution
from cora_tpu_torch.solve.rounding import (
    align_estimate_to_origin,
    project_solution,
)
from cora_tpu_torch.solve.tnt_kernel import (
    get_kernel_backend,
    saddle_escape_tiles,
    tnt_solve_tiles,
)
from cora_tpu_torch.types import (
    CertResults,
    CoraResult,
    Formulation,
    Initialization,
    Preconditioner,
    SolverConfig,
)
from cora_tpu_torch.utils.timing import PhaseTimer

SADDLE_GRAD_TOL = 1e-4  # reference `CORA.cpp:191-192`
PRECON_SADDLE_GRAD_TOL = 1e-4


def _clamp(val, lo, hi):
    return min(max(val, lo), hi)


def _trim_rank(Y: np.ndarray, d: int, rel_tol: float = 1e-3) -> np.ndarray:
    """Drop numerically-dead columns of Y via thin SVD: Y ↦ U_r Σ_r.

    X = YYᵀ (and with it cost, Λ blocks and the certificate S) is
    preserved up to the trimmed singular energy; the right factor Vᵀ is
    pure gauge. Keeps at least d columns (St(d,r) needs r ≥ d)."""
    U, s, _ = np.linalg.svd(np.asarray(Y, np.float64), full_matrices=False)
    if s.size == 0 or s[0] == 0:
        return np.asarray(Y, np.float64)
    r = max(int((s > rel_tol * s[0]).sum()), d)
    return U[:, :r] * s[:r]


def _lift_random(plan, Y: torch.Tensor, generator: torch.Generator,
                 scale: float) -> torch.Tensor:
    """Lift Y to rank r+1 with a small random column, reprojected.

    A zero column would leave the lifted point on a rank-r invariant
    subspace of the dynamics; the random column breaks the symmetry so
    TNT can populate the new dimension. The column is drawn on the CPU
    from `generator`, so one seed lifts alike on every device."""
    col = torch.randn((Y.shape[0], 1), generator=generator,
                      dtype=torch.float64).to(Y)
    return chain.project_manifold(
        plan, torch.cat([Y, scale * col], dim=1)).contiguous()


def _check_device(device: torch.device) -> None:
    if device.type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available")
    # reduced-precision float32 matmuls break the polar/QDWH retraction
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 must be "
                           "False for the float32 solve")
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("torch.get_float32_matmul_precision() must be "
                           "'highest' for the float32 solve")


def solve_cora(
    problem: Problem,
    x0=None,
    max_rank: int | None = None,
    config: SolverConfig | None = None,
    verbose: bool | None = None,
    device="cuda",
) -> CoraResult:
    """Full certifiable solve of a range-aided SLAM problem on `device`.

    `x0`: an explicit (N, r) start (numpy or tensor), projected onto the
    manifold; otherwise a random start from `config.seed`."""
    config = config or SolverConfig()
    device = torch.device(device)
    _check_device(device)
    if config.formulation != Formulation.EXPLICIT:
        raise NotImplementedError("the implicit formulation is not ported")
    if config.preconditioner != Preconditioner.REGULARIZED_CHOLESKY:
        raise NotImplementedError(
            f"preconditioner {config.preconditioner}: only "
            "REGULARIZED_CHOLESKY is ported")
    if config.log_iterates:
        raise NotImplementedError("log_iterates is not ported")
    if max_rank is None:
        max_rank = config.max_rank
    if verbose is None:
        verbose = config.verbose

    def vprint(msg):
        if verbose:
            print(msg)

    t_start = time.time()
    pd = problem.device_data(dtype=config.dtype, device=device)
    reason = chain.plan_supported(pd)
    if reason is not None:
        raise NotImplementedError(
            f"graph not covered by the chain kernels: {reason}")
    cert_p = config.cert
    state_height = pd.size
    rank = problem.dim + config.init_rank_jump
    kern = get_kernel_backend(
        problem, config.tnt, max_cond=config.reg_chol_max_cond,
        dtype=config.dtype, device=device, use_kernels=config.use_kernels)
    plan = kern.plan

    if x0 is None:
        if config.initialization == Initialization.ODOMETRY:
            raise NotImplementedError("odometry initialization is not ported")
        X = chain.random_initial_guess(
            pd, rank, torch.Generator().manual_seed(config.seed))
    else:
        X = torch.as_tensor(np.asarray(
            x0.cpu() if isinstance(x0, torch.Tensor) else x0))
        X = X.to(device, plan.dtype)
        if X.shape[0] != state_height:
            raise ValueError(
                f"x0 has {X.shape[0]} rows, expected {state_height}")
        X = chain.project_manifold(plan, X)
        rank = X.shape[1]
    X = X.contiguous()

    def as_state(Y) -> torch.Tensor:
        return torch.as_tensor(np.asarray(Y)).to(device, plan.dtype)

    ranks_visited = []
    cert = None
    eigvec_bootstrap = None
    eta = cert_p.min_eta
    first_loop = True
    result = None
    sdp_cost = float("nan")
    t_certificate = float("nan")

    def run_tnt(X, **kw):
        return tnt_solve_tiles(kern, X, config.tnt, **kw)

    timer = PhaseTimer(device)
    grad_norm_f64 = float("nan")
    # tr(Q): calibrates the ramp-lift column so its objective energy is a
    # fixed small fraction of the current cost
    trace_q = float(problem.data_matrix().diagonal().sum())

    def _polish(Y_explicit, label="polish_f64"):
        """Float64 polish on the solve's device; returns a PolishResult or
        None when disabled."""
        if not config.polish:
            return None
        from cora_tpu_torch.solve.polish import polish_solution

        with timer(label):
            pres = polish_solution(
                problem, Y_explicit,
                grad_tol=config.polish_grad_tol,
                time_budget=config.polish_time_budget,
                device=device,
            )
        vprint(
            f"[t={time.time()-t_start:7.2f}s] f64 polish: f {pres.f:.6f}, "
            f"|grad| {pres.grad_norm:.2e} ({pres.iterations} its, "
            f"{pres.status})"
        )
        return pres

    ramp_budget = config.max_staircase_iterations or config.tnt.max_iterations
    while rank <= max_rank:
        ranks_visited.append(rank)
        vprint(f"\n[t={time.time()-t_start:7.2f}s] Solving problem at rank {rank}")
        with timer("tnt_level"):
            result = run_tnt(
                X,
                ramp_iterations=ramp_budget,
                ramp_tcg=config.ramp_tcg_iterations,
                lift_grad_norm=(
                    config.lift_grad_norm
                    if rank < max_rank
                    else float("inf")  # final level: finish best-effort
                ),
                stall_window=config.ramp_stall_window,
                stall_tol=config.ramp_stall_tol,
            )
        vprint(
            f"Obtained solution with objective {result.f:.6f} "
            f"(|grad| {result.gradfx_norm:.2e}, {result.num_iterations} its, "
            f"{result.elapsed_time:.2f}s, {result.status})"
        )

        # a level that ends far from criticality has no certificate to
        # check and no saddle to escape: lift instead
        capped_far = result.gradfx_norm > config.lift_grad_norm
        if (result.status == "ramp_exit" or capped_far) and rank < max_rank:
            rank += 1
            # column scaled so E[colᵀQ col] ≈ lift_rel_energy · 2f
            scale = float(
                np.sqrt(
                    config.lift_rel_energy * 2.0 * max(result.f, 1e-12)
                    / max(trace_q, 1e-12)
                )
            )
            with timer("lift"):
                X = _lift_random(
                    plan, result.x,
                    torch.Generator().manual_seed(config.seed * 1000 + rank),
                    scale,
                )
            vprint(f"[t={time.time()-t_start:7.2f}s] ramp level: lifted to "
                   f"rank {rank} (column scale {scale:.2e})")
            continue

        Y_explicit = result.x
        # near-critical points of the rank-r relaxation collapse to the
        # SDP rank: trim numerically-dead columns (reference exploits the
        # same rank deficiency at `CORA_problem.cpp:1036-1049`)
        if result.gradfx_norm <= config.lift_grad_norm:
            Y_trim = _trim_rank(Y_explicit.cpu().numpy(), problem.dim)
            if Y_trim.shape[1] < Y_explicit.shape[1]:
                vprint(
                    f"[t={time.time()-t_start:7.2f}s] trimmed solution rank "
                    f"{Y_explicit.shape[1]} → {Y_trim.shape[1]}"
                )
                Y_explicit = Y_trim
                result.x = as_state(Y_trim)
                rank = Y_trim.shape[1]

        near_critical = result.gradfx_norm <= config.lift_grad_norm
        if first_loop:
            eigvec_bootstrap = (Y_explicit.cpu().numpy()
                                if isinstance(Y_explicit, torch.Tensor)
                                else np.asarray(Y_explicit))
            first_loop = False
        elif cert is not None:
            eigvec_bootstrap = cert.all_eigvecs

        # pre-certification at the float32 point: a NOT-PSD verdict there
        # already carries the escape eigenvector, so failed levels skip the
        # polish; a level whose certificate looks PSD is polished and
        # re-certified at the polished (stationary) point
        pres = None
        cert_final = None
        f_current = result.f
        eta = _clamp(f_current * cert_p.rel_eta, cert_p.min_eta, cert_p.max_eta)
        if near_critical:
            if config.polish:
                t_c = time.time()
                with timer("certify"):
                    pre = _certify_with_retry(
                        problem, pd, Y_explicit, eta, cert_p, eigvec_bootstrap
                    )
                vprint(
                    f"[t={time.time()-t_start:7.2f}s] Pre-certificate "
                    f"(f32 point): {pre.is_certified} (eta={eta:.2e}, "
                    f"theta={pre.theta:.3e}, {time.time()-t_c:.2f}s)"
                )
                if np.isnan(pre.theta):
                    raise RuntimeError("certification produced NaN theta")
                if pre.is_certified:
                    pres = _polish(Y_explicit)
                elif abs(pre.theta) <= 10.0 * result.gradfx_norm:
                    # marginal NOT-PSD verdict at an unpolished point: Λ(Y)
                    # carries O(|grad|) error there, so polish and let the
                    # re-certification decide
                    pres = _polish(Y_explicit)
                else:
                    cert_final = pre
        else:
            # forced finish at max_rank far from criticality: S = Q − Λ(Y)
            # carries no optimality information — no certificate
            vprint(
                f"[t={time.time()-t_start:7.2f}s] level at rank {rank} ended "
                f"far from criticality (|grad| {result.gradfx_norm:.2e}) — "
                f"certificate skipped"
            )
            cert_final = CertResults(
                is_certified=False, theta=float("-inf"), x=np.zeros(pd.size),
                all_eigvecs=np.zeros((pd.size, cert_p.lobpcg_block_size)),
                num_iters=0,
            )

        if pres is not None:
            grad_norm_f64 = pres.grad_norm
            Y_explicit = pres.Y  # float64 host state
            f_current = pres.f
            result.x = as_state(pres.Y)
            result.f = pres.f

        if cert_final is None:
            eta = _clamp(
                f_current * cert_p.rel_eta, cert_p.min_eta, cert_p.max_eta)
            t_c = time.time()
            with timer("certify"):
                cert = _certify_with_retry(
                    problem, pd, Y_explicit, eta, cert_p, eigvec_bootstrap
                )
            vprint(
                f"[t={time.time()-t_start:7.2f}s] Certified: "
                f"{cert.is_certified} (eta={eta:.2e}, theta={cert.theta:.3e}, "
                f"cert took {time.time()-t_c:.2f}s)"
            )
            if np.isnan(cert.theta):
                raise RuntimeError("certification produced NaN theta")
        else:
            cert = cert_final

        if cert.is_certified:
            X = result.x
            sdp_cost = f_current
            t_certificate = time.time() - t_start
            break

        rank += 1
        if rank > max_rank:
            X = result.x
            break
        # negative-curvature direction in the solver's state space
        v = np.asarray(cert.x[:state_height], np.float64)
        v = v / max(np.linalg.norm(v), 1e-300)
        t_e = time.time()
        with timer("saddle_escape"):
            X = saddle_escape_tiles(
                kern, result.x, cert.theta, v,
                SADDLE_GRAD_TOL, PRECON_SADDLE_GRAD_TOL, verbose=verbose,
            )
        vprint(f"[t={time.time()-t_start:7.2f}s] saddle escape took "
               f"{time.time()-t_e:.2f}s")

    sdp_certified = bool(cert.is_certified) if cert is not None else False

    # ---- rank-d rounding + refinement (`CORA.cpp:200-233`) ----
    final_cert = cert
    if X.shape[1] > problem.dim:
        vprint(f"\nProjecting solution to rank {problem.dim} and refining")
        with timer("rounding"):
            X = as_state(project_solution(pd, X.cpu().numpy(),
                                          verbose=verbose)).contiguous()
        with timer("tnt_refine"):
            result = run_tnt(X)
        Y_final = result.x
        pres = _polish(Y_final, label="polish_final")
        if pres is not None:
            Y_final = pres.Y
            result.f = pres.f
            result.x = as_state(pres.Y)
        vprint(f"FINAL objective {result.f:.6f}")
        eta = _clamp(result.f * cert_p.rel_eta, cert_p.min_eta, cert_p.max_eta)
        with timer("certify"):
            final_cert = _certify_with_retry(
                problem, pd, Y_final, eta, cert_p, eigvec_bootstrap
            )
        X = result.x

    suboptimality = (
        result.f - sdp_cost if np.isfinite(sdp_cost) else float("nan")
    )
    vprint(
        f"\nSDP certified: {sdp_certified} | final rank-d estimate "
        f"certified: {final_cert.is_certified} | suboptimality bound: "
        f"{suboptimality:.6f}"
    )
    if verbose:
        print("\nPhase breakdown:\n" + timer.report())
    return CoraResult(
        result=result,
        certified=sdp_certified,
        theta=float(final_cert.theta),
        eta=float(eta),
        ranks_visited=ranks_visited,
        sdp_cost=float(sdp_cost),
        suboptimality=float(suboptimality),
        final_certified=bool(final_cert.is_certified),
        elapsed_to_certificate=float(t_certificate),
        grad_norm_f64=float(grad_norm_f64),
        phases=dict(timer.totals),
    )


def extract_solution(problem: Problem, config: SolverConfig,
                     res: CoraResult) -> np.ndarray:
    """Translation-explicit, gauge-aligned final estimate (host numpy)."""
    pd = problem.device_data(dtype=config.dtype, device="cpu")
    Y = res.result.x
    Y = Y.detach().cpu().numpy() if isinstance(Y, torch.Tensor) else np.asarray(Y)
    return np.asarray(align_estimate_to_origin(pd, Y))


def _certify_with_retry(problem, pd, Y, eta, cert_p, bootstrap):
    """NaN-θ retry loop (reference `CORA_problem.cpp:1076-1083`)."""
    cert = certify_solution(
        problem, pd, Y, eta,
        nx=cert_p.lobpcg_block_size,
        eigvec_bootstrap=bootstrap,
        max_lobpcg_iters=cert_p.max_lobpcg_iters,
        method="host",
    )
    retries = 0
    while np.isnan(cert.theta) and retries < 20:
        eta *= 2
        cert = certify_solution(
            problem, pd, Y, eta,
            nx=cert_p.lobpcg_block_size,
            eigvec_bootstrap=bootstrap,
            max_lobpcg_iters=cert_p.max_lobpcg_iters,
            method="host",
        )
        retries += 1
    return cert
