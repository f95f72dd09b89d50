"""Core enums, configs and result containers.

Parity with the reference's `include/CORA/CORA_types.h` (Formulation,
Preconditioner, Initialization, CertResults) plus the solver/cert
parameter sets that the reference hardcodes in `src/CORA.cpp:95-116`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

import numpy as np


class Formulation(enum.Enum):
    # optimize over rotations, unit spheres AND translations
    EXPLICIT = "explicit"
    # analytically marginalize translations out (reference `CORA_types.h:51-56`)
    IMPLICIT = "implicit"


class Preconditioner(enum.Enum):
    NONE = "none"
    JACOBI = "jacobi"
    BLOCK_JACOBI = "block_jacobi"  # batched d×d diagonal blocks
    BLOCK_CHOLESKY = "block_cholesky"
    REGULARIZED_CHOLESKY = "regularized_cholesky"


class Initialization(enum.Enum):
    RANDOM = "random"
    ODOMETRY = "odometry"


@dataclasses.dataclass
class TNTParams:
    """Truncated-Newton trust-region parameters.

    Defaults mirror the values the reference hardcodes for CORA at
    `src/CORA.cpp:95-109` (Delta0=5, alpha2=3, 80 tCG iterations, 250
    outer iterations, 1e-6 gradient tolerances, theta=0.8).
    """

    delta0: float = 5.0
    alpha1: float = 0.25  # trust-region shrink factor
    alpha2: float = 3.0  # trust-region growth factor
    eta1: float = 0.05  # min rho for a successful step
    eta2: float = 0.9  # rho above which the step is "very successful"
    max_tcg_iterations: int = 80
    max_iterations: int = 250
    gradient_tolerance: float = 1e-6
    preconditioned_gradient_tolerance: float = 1e-6
    relative_decrease_tolerance: float = 1e-6
    stepsize_tolerance: float = 1e-6
    delta_tolerance: float = 1e-5
    kappa_fgr: float = 0.1  # tCG fractional gradient reduction
    theta: float = 0.8  # tCG superlinear convergence exponent
    max_computation_time: float = 20.0  # seconds, enforced host-side per rank


@dataclasses.dataclass
class CertParams:
    """Certification parameters (reference `src/CORA.cpp:112-116`)."""

    min_eta: float = 1e-7
    max_eta: float = 1e-1
    rel_eta: float = 5e-6
    lobpcg_block_size: int = 10
    max_lobpcg_iters: int = 500
    lobpcg_tol: float = 1e-6
    # eigensolver budget when the exact banded Cholesky already decided
    # NOT-PSD and the eigenvector only seeds the saddle escape
    escape_eig_iters: int = 160


@dataclasses.dataclass
class SolverConfig:
    """Top-level solve configuration (replaces `examples/config.json` +
    the env vars scattered through the reference)."""

    max_rank: int = 10
    init_rank_jump: int = 0
    formulation: Formulation = Formulation.EXPLICIT
    preconditioner: Preconditioner = Preconditioner.REGULARIZED_CHOLESKY
    initialization: Initialization = Initialization.RANDOM
    dtype: Any = np.float64  # device compute dtype (float32 on the main path)
    tnt: TNTParams = dataclasses.field(default_factory=TNTParams)
    cert: CertParams = dataclasses.field(default_factory=CertParams)
    reg_chol_max_cond: float = 1e6  # CORA_REG_CHOLESKY_MAX_COND analog
    # iteration cap for staircase levels before certification succeeds —
    # the analog of the reference's 20 s per-rank time cap
    # (`src/CORA.cpp:106`): uncertified low-rank levels don't deserve a
    # full 250-iteration polish, the saddle escape restarts progress anyway
    max_staircase_iterations: int | None = None
    # tCG budget at ramp (pre-critical) staircase levels; the finish
    # phase always uses the full `tnt.max_tcg_iterations`. Cheap inner
    # solves are the right trade far from a critical point, and float32
    # superlinear endgame accuracy is wasted work — the float64 polish
    # redoes the last mile anyway.
    ramp_tcg_iterations: int = 24
    # |grad| above which a budget-capped level is treated as a ramp level
    # (lift + continue) instead of entering the finish/certify phase
    # (see staircase docstring)
    lift_grad_norm: float = 1e3
    # adaptive ramp pacing: end a level's ramp phase when the relative
    # objective decrease over the last `ramp_stall_window` iterations
    # falls below `window · ramp_stall_tol` (0 disables; the hard
    # `max_staircase_iterations` budget still applies either way). Makes
    # the staircase path robust to seed/tcg-budget choices instead of
    # tuned to one chaotic optimum.
    ramp_stall_window: int = 10
    ramp_stall_tol: float = 1e-4
    # ramp lifts add a random column scaled so the objective regresses by
    # at most ~this fraction of its current value (strong symmetry
    # breaking far from the optimum, negligible perturbation near it)
    lift_rel_energy: float = 0.01
    # host float64 endgame polish before certification
    # (`cora_tpu_torch.solve.polish`; reference certifies float64 TNT output
    # converged to 1e-6, `src/CORA.cpp:98-109`)
    polish: bool = True
    # None → 1e-6·‖Q‖₂ (the reference's 1e-6 gradient tolerance,
    # `src/CORA.cpp:100-101`, made scale-invariant)
    polish_grad_tol: float | None = None
    # hard wall-clock cap per polish call (seconds); on expiry the
    # best-so-far point is certified and `grad_norm_f64` records the
    # honest stationarity achieved
    polish_time_budget: float = 2.5
    # hand-written CUDA kernels for the TNT hot loop
    # (`cora_tpu_torch.ops.tnt_kernels`): "auto" runs them when the solve's
    # device is CUDA and their plain PyTorch versions on the CPU, "always"
    # requires them (raises on the CPU), "never" runs the plain versions
    # on any device (tests and on-card comparisons only)
    use_kernels: str = "auto"
    seed: int = 0
    verbose: bool = False
    log_iterates: bool = False


@dataclasses.dataclass
class CertResults:
    """Certification outcome (reference `CORA_types.h:58-64`)."""

    is_certified: bool
    theta: float
    x: np.ndarray  # min-eigenvector estimate
    all_eigvecs: np.ndarray  # LOBPCG block, bootstraps the next rank level
    num_iters: int


@dataclasses.dataclass
class TNTResult:
    """Outer-solver result (mirrors the `TNTResult` fields the reference
    consumes in `tests/test_cora.cpp:15-37`)."""

    f: float
    x: Any
    gradfx_norm: float
    preconditioned_gradfx_norm: float
    num_iterations: int
    inner_iterations: np.ndarray
    objective_values: np.ndarray
    gradient_norms: np.ndarray
    preconditioned_gradient_norms: np.ndarray
    update_step_norms: np.ndarray
    elapsed_time: float
    status: str = ""
    iterates: list | None = None


@dataclasses.dataclass
class CoraResult:
    """Full staircase solve result.

    `certified` refers to the SDP relaxation: the staircase found a
    rank-r critical point whose dual certificate S = Q − Λ is PSD, i.e.
    the *global optimum of the SDP*. The returned estimate is that
    solution rounded to rank d and refined; when the SDP optimum has
    rank > d the rounded estimate is not itself a global optimum but
    carries the explicit suboptimality bound
    ``suboptimality = f(estimate) − f(SDP)`` (CORA's "certifiably
    correct" semantics)."""

    result: TNTResult
    certified: bool
    theta: float
    eta: float
    ranks_visited: list
    sdp_cost: float = float("nan")  # objective of the certified SDP solution
    suboptimality: float = float("nan")  # f(final) − f(SDP), ≥ 0
    final_certified: bool = False  # rank-d estimate itself certified
    elapsed_to_certificate: float = float("nan")  # seconds to SDP certificate
    # float64 Riemannian gradient norm at the certified point (NaN when
    # the polish pass is disabled) — the certificate S ⪰ 0 proves
    # optimality only together with stationarity, so this is part of the
    # certificate's evidence
    grad_norm_f64: float = float("nan")
    phases: dict | None = None  # wall-clock per solve phase (PhaseTimer)
    iterates: list | None = None
