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
    (`CORA.cpp:200-233`);
  * translation-implicit mode: the TNT state is [rotations | spheres]
    only, the operator is the marginalized Q̃ (`models/formulations.py`)
    and trimming, polish and certification act on the recovered
    translation-explicit state (`CORA.cpp:30-40,161-164`,
    `CORA_problem.cpp:1085-1100`);
  * optional checkpoints between levels (`solve/checkpoint.py`) and a log
    of every TNT iterate (`config.log_iterates`).

Two paths, chosen by the JAX package's rule (`cora_tpu/solve/
staircase.py:239-288`): an explicit float32 solve with the
RegularizedCholesky preconditioner and no iterate log, on a graph that the
chain plan covers and at ranks up to the kernels' bound
(`chain.rank_bound`, checked against `max_rank` up front), runs on the
chain kernels (`CudaTNT` on the card, their
plain versions on the CPU); any other solve — the implicit formulation,
`log_iterates`, multi-robot graphs with inter-robot ranges, loop closures,
other preconditioners, float64 — runs the canonical path (`tnt_solve`,
`saddle_escape`) on the canonical ops, announced under `verbose`; its TNT
levels run as the device loop of `solve/tnt.py`, captured as CUDA graphs
on the card (eager with `use_kernels="never"` and on a mesh), as do the
certificate's LOBPCG and the polish's CG on both paths. On a CUDA
device a kernel that fails to build or launch, or a loop that fails to
capture, raises: nothing falls back to another path. Both paths certify
with `method="auto"`. A sharded solve (`mesh=`, `cora_tpu_torch.parallel`) runs the canonical path
on the sharded Q·Y, as the JAX package's `mesh=` does.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cora_tpu_torch.graph.data import torch_dtype
from cora_tpu_torch.graph.problem import Problem
from cora_tpu_torch.ops import chain
from cora_tpu_torch.ops.riemannian import (
    project_to_manifold,
    random_initial_guess,
)
from cora_tpu_torch.precond import implicit_precond
from cora_tpu_torch.solve.certify import certify_solution
from cora_tpu_torch.solve.checkpoint import (
    StaircaseCheckpoint,
    maybe_resume,
    problem_fingerprint,
)
from cora_tpu_torch.solve.rounding import (
    align_estimate_to_origin,
    project_solution,
)
from cora_tpu_torch.solve.saddle import saddle_escape
from cora_tpu_torch.solve.tnt import device_loop, tnt_solve
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
from cora_tpu_torch.utils.device import check_device
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


def _lift_random(project, Y: torch.Tensor, generator: torch.Generator,
                 scale: float) -> torch.Tensor:
    """Lift Y to rank r+1 with a small random column, reprojected.

    A zero column would leave the lifted point on a rank-r invariant
    subspace of the dynamics; the random column breaks the symmetry so
    TNT can populate the new dimension. The column is drawn on the CPU
    from `generator`, so one seed lifts alike on every device."""
    col = torch.randn((Y.shape[0], 1), generator=generator,
                      dtype=torch.float64).to(Y)
    return project(torch.cat([Y, scale * col], dim=1)).contiguous()


def kernel_path_reason(config: SolverConfig, pd, mesh=None,
                       max_rank: int | None = None) -> str | None:
    """None if the chain kernels run this solve, else why the canonical
    path does (the JAX package's rule, `cora_tpu/solve/staircase.py:
    239-246`, with its `plan_supported` check, and its per-rank
    `kernel_supported` as the kernels' rank bound): a sharded solve
    (`mesh`) always runs the canonical path. `max_rank` (default
    `config.max_rank`) is the staircase's highest rank, which must be
    within `chain.rank_bound` (the card's shared memory) for every level,
    escape and ladder to run on the kernels."""
    if mesh is not None:
        return "mesh"
    if config.formulation == Formulation.IMPLICIT:
        return "formulation implicit"
    if config.preconditioner != Preconditioner.REGULARIZED_CHOLESKY:
        return f"preconditioner {config.preconditioner.value}"
    if config.log_iterates:
        return "log_iterates"
    if np.dtype(config.dtype) != np.float32:
        return f"dtype {np.dtype(config.dtype).name}"
    reason = chain.plan_supported(pd)
    if reason is not None:
        return reason
    top = config.max_rank if max_rank is None else max_rank
    bound = chain.rank_bound(pd.l, pd.size)
    if top > bound:
        return (f"max_rank {top} above the kernels' rank bound {bound} "
                f"({pd.l} landmarks in one block's shared memory)")
    return None


def solve_cora(
    problem: Problem,
    x0=None,
    max_rank: int | None = None,
    config: SolverConfig | None = None,
    verbose: bool | None = None,
    checkpoint_path: str | None = None,
    device="cuda",
    mesh=None,
) -> CoraResult:
    """Full certifiable solve of a range-aided SLAM problem on `device`.

    `x0`: a start (numpy or tensor) of the state's height (N, or the
    rotation and bearing rows in implicit mode; an explicit-height start
    is truncated there), projected onto the manifold; otherwise the
    odometry start (`Initialization.ODOMETRY`) or a random start, both from
    `config.seed`. `checkpoint_path`: resume from the checkpoint there if
    it exists, and write one at each ramp lift and after each failed
    certificate.

    `mesh`: a 1-D `DeviceMesh` (`cora_tpu_torch.parallel`) whose every
    rank calls this with the same arguments: the staircase (TNT, saddle
    escape, refinement) then runs on the sharded Q·Y
    (`Problem.sharded_operator`, one collective per product; the implicit
    formulation's marginalized products ride it too) with the state
    replicated; the preconditioner, the certificate and the polish run on
    every rank alike, and the wall-clock caps read a clock all ranks
    share, so every rank ends on the same bits. `device` must be the
    mesh's kind of device."""
    config = config or SolverConfig()
    # the device loops (TNT levels, the certificate's LOBPCG, the polish's
    # CG) run captured on the card, eagerly for `use_kernels="never"` (the
    # plain versions) and on a mesh, whose collectives stay outside graphs
    with device_loop(graphs=mesh is None and config.use_kernels != "never"):
        return _solve_cora(problem, x0, max_rank, config, verbose,
                           checkpoint_path, device, mesh)


def _solve_cora(problem, x0, max_rank, config, verbose, checkpoint_path,
                device, mesh) -> CoraResult:
    device = check_device(device)
    implicit = config.formulation == Formulation.IMPLICIT
    if max_rank is None:
        max_rank = config.max_rank
    if verbose is None:
        verbose = config.verbose

    def vprint(msg):
        if verbose:
            print(msg)

    t_start = time.time()
    pd = problem.device_data(dtype=config.dtype, device=device)
    # the certificate's σ search starts from the last level's σ; a σ left
    # by an earlier solve of this problem would start this solve's search
    # elsewhere, and two solves from one start would end on other bits
    problem._cert_sigma_cache = 0.0
    cert_p = config.cert
    state_height = pd.rot_range_size if implicit else pd.size
    rank = problem.dim + config.init_rank_jump
    reason = kernel_path_reason(config, pd, mesh, max_rank)
    solver_op = None  # the explicit Q·Y of the canonical ops
    clock = None  # the wall clock of the time caps (this process's)
    if reason is None:
        kern = get_kernel_backend(
            problem, config.tnt, max_cond=config.reg_chol_max_cond,
            dtype=config.dtype, device=device,
            use_kernels=config.use_kernels)

        def project(X):
            return chain.project_manifold(kern.plan, X)

        def run_tnt(X, **kw):
            return tnt_solve_tiles(kern, X, config.tnt, **kw)

        def escape(Y, theta, v):
            return saddle_escape_tiles(
                kern, Y, theta, v, SADDLE_GRAD_TOL, PRECON_SADDLE_GRAD_TOL,
                verbose=verbose)
    else:
        if config.use_kernels == "always":
            raise RuntimeError(f"use_kernels='always' but the chain kernels "
                               f"do not cover this solve: {reason}")
        vprint(f"[kernels] canonical path: {reason}")
        precon = problem.preconditioner_fn(
            config.preconditioner, dtype=config.dtype,
            max_cond=config.reg_chol_max_cond, device=device)
        if mesh is not None:
            from cora_tpu_torch.models.formulations import make_operator
            from cora_tpu_torch.parallel.distributed import mesh_clock

            if device.type != mesh.device_type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"({mesh.device_type})")
            shard_op = problem.sharded_operator(mesh, config.dtype,
                                                device=device)
            # implicit: the marginalized Q̃ over the sharded explicit
            # product, the banded L⁻¹ apply replicated
            solver_op = make_operator(
                problem, pd, config.formulation, dtype=config.dtype,
                full_product=shard_op) if implicit else shard_op
            clock = mesh_clock(mesh)
        elif implicit:
            solver_op = problem.operator(config.formulation,
                                         dtype=config.dtype, device=device)
        if implicit:
            # the marginalized Q̃; the preconditioner lifts → applies the
            # full one → truncates (reference `CORA_problem.cpp:869-903`)
            precon = implicit_precond(precon)

        def project(X):
            return project_to_manifold(pd, X)

        def run_tnt(X, **kw):
            return tnt_solve(pd, X, precon, config.tnt, op=solver_op,
                             log_iterates=config.log_iterates, clock=clock,
                             **kw)

        def escape(Y, theta, v):
            return saddle_escape(
                pd, Y, theta, v, precon, SADDLE_GRAD_TOL,
                PRECON_SADDLE_GRAD_TOL, verbose=verbose, op=solver_op)

    def host(Y) -> np.ndarray:
        return Y.detach().cpu().numpy() if isinstance(Y, torch.Tensor) \
            else np.asarray(Y)

    def as_state(Y) -> torch.Tensor:
        return torch.as_tensor(host(Y)).to(device, pd.dtype())

    def to_explicit(Y):
        """The translation-explicit state (translations recovered in
        implicit mode)."""
        if implicit:
            return solver_op.implicit.translation_explicit_solution(Y)
        return Y

    ckpt = maybe_resume(problem, checkpoint_path)
    if ckpt is None and x0 is None and \
            config.initialization == Initialization.ODOMETRY:
        # reference odometry start (`paper_experiments.cpp:441-520`)
        from cora_tpu_torch.models.init import odometry_initialization

        x0 = odometry_initialization(problem, rank=rank, seed=config.seed)
    if ckpt is not None:
        X = as_state(ckpt.Y)
        rank = ckpt.rank
        vprint(f"Resumed from checkpoint at rank {rank}")
    elif x0 is None:
        X = random_initial_guess(
            pd, rank, torch.Generator().manual_seed(config.seed),
            height=state_height)
    else:
        X = as_state(x0)
        if X.shape[0] != state_height:
            if implicit and X.shape[0] == pd.size:
                X = X[:state_height]
            else:
                raise ValueError(
                    f"x0 has {X.shape[0]} rows, expected {state_height}")
        X = project(X)
        rank = X.shape[1]
    X = X.contiguous()

    ranks_visited = list(ckpt.ranks_visited) if ckpt is not None else []
    all_iterates = [] if config.log_iterates else None
    cert = None
    eigvec_bootstrap = ckpt.eigvec_bootstrap if ckpt is not None else None
    eta = cert_p.min_eta
    first_loop = eigvec_bootstrap is None
    result = None
    sdp_cost = float("nan")
    t_certificate = float("nan")

    def save_ckpt(Y, r):
        if checkpoint_path:
            StaircaseCheckpoint(
                Y=host(Y), rank=r, ranks_visited=ranks_visited,
                eigvec_bootstrap=(np.asarray(eigvec_bootstrap)
                                  if eigvec_bootstrap is not None else None),
                fingerprint=problem_fingerprint(problem),
            ).save(checkpoint_path)

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
                clock=clock,
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
        if all_iterates is not None and result.iterates:
            all_iterates.extend(result.iterates)
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
            save_ckpt(result.x, rank)
            # column scaled so E[colᵀQ col] ≈ lift_rel_energy · 2f
            scale = float(
                np.sqrt(
                    config.lift_rel_energy * 2.0 * max(result.f, 1e-12)
                    / max(trace_q, 1e-12)
                )
            )
            with timer("lift"):
                X = _lift_random(
                    project, result.x,
                    torch.Generator().manual_seed(config.seed * 1000 + rank),
                    scale,
                )
            vprint(f"[t={time.time()-t_start:7.2f}s] ramp level: lifted to "
                   f"rank {rank} (column scale {scale:.2e})")
            continue

        Y_explicit = to_explicit(result.x)
        # near-critical points of the rank-r relaxation collapse to the
        # SDP rank: trim numerically-dead columns (reference exploits the
        # same rank deficiency at `CORA_problem.cpp:1036-1049`)
        if result.gradfx_norm <= config.lift_grad_norm:
            Y_trim = _trim_rank(host(Y_explicit), problem.dim)
            if Y_trim.shape[1] < Y_explicit.shape[1]:
                vprint(
                    f"[t={time.time()-t_start:7.2f}s] trimmed solution rank "
                    f"{Y_explicit.shape[1]} → {Y_trim.shape[1]}"
                )
                Y_explicit = Y_trim
                result.x = as_state(Y_trim[:state_height])
                rank = Y_trim.shape[1]

        near_critical = result.gradfx_norm <= config.lift_grad_norm
        if first_loop:
            eigvec_bootstrap = host(Y_explicit)
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
            # fold the polished point back into the solver's state
            result.x = as_state(pres.Y[:state_height])
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
        save_ckpt(result.x, rank - 1)
        # negative-curvature direction in the solver's state space
        v = np.asarray(cert.x[:state_height], np.float64)
        v = v / max(np.linalg.norm(v), 1e-300)
        t_e = time.time()
        with timer("saddle_escape"):
            X = escape(result.x, cert.theta, v)
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
        if all_iterates is not None:
            all_iterates.extend(result.iterates or [])
            result.iterates = all_iterates
        Y_final = to_explicit(result.x)
        pres = _polish(Y_final, label="polish_final")
        if pres is not None:
            Y_final = pres.Y
            result.f = pres.f
            result.x = as_state(pres.Y[:state_height])
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
    if all_iterates is not None:
        result.iterates = all_iterates
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
    """Translation-explicit, gauge-aligned final estimate (host numpy).
    In implicit mode the translations are recovered first, on the device
    the result lies on."""
    pd = problem.device_data(dtype=config.dtype, device="cpu")
    Y = res.result.x
    if not isinstance(Y, torch.Tensor):
        Y = torch.as_tensor(np.asarray(Y))
    if config.formulation == Formulation.IMPLICIT:
        op = problem.operator(config.formulation, dtype=config.dtype,
                              device=Y.device)
        Y = op.implicit.translation_explicit_solution(
            Y.to(torch_dtype(config.dtype)))
    return np.asarray(align_estimate_to_origin(pd, Y.detach().cpu().numpy()))


def _certify_with_retry(problem, pd, Y, eta, cert_p, bootstrap):
    """NaN-θ retry loop (reference `CORA_problem.cpp:1076-1083`).

    method="auto": the PSD decision is the exact float64 banded Cholesky
    wherever the graph permits; only the escape eigenvector comes from the
    LOBPCG on the solve's device."""
    retries = 0
    while True:
        cert = certify_solution(
            problem, pd, Y, eta,
            nx=cert_p.lobpcg_block_size,
            eigvec_bootstrap=bootstrap,
            max_lobpcg_iters=cert_p.max_lobpcg_iters,
            method="auto",
            escape_eig_iters=cert_p.escape_eig_iters,
        )
        if not np.isnan(cert.theta) or retries >= 20:
            return cert
        eta *= 2
        retries += 1
