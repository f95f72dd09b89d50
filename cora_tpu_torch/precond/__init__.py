"""Preconditioners for the tCG inner loop of the canonical solver.

The reference supports {None, Jacobi, BlockCholesky, RegularizedCholesky}
(`CORA_types.h:77`, `src/CORA_problem.cpp:512-623`); the JAX package adds
block-Jacobi (`cora_tpu/precond/__init__.py`). The port has all five:

  * ``none`` / ``jacobi``  — the identity and diag(Q)⁻¹;
  * ``block_jacobi``       — inverses of the d×d rotation blocks of Q plus
                             its scalar rows;
  * ``block_cholesky`` / ``regularized_cholesky`` — the banded Cholesky +
    Woodbury factor of a host-assembled matrix, applied on the device by
    a log-depth doubling scan (`cora_tpu_torch.precond.banded`).

Each is a `PrecondOp`: an apply function ``fn(pd, fac, V)`` and its factor
tensors, callable as ``P(V)`` on the ambient space; the solver composes it
with the tangent projection (reference `src/CORA.cpp:87-92`).
`implicit_precond` wraps one for the implicit formulation's reduced state.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from cora_tpu_torch.graph.data import ProblemData
from cora_tpu_torch.types import Preconditioner


class PrecondOp:
    """A preconditioner as (apply function, factor tensors, problem data):
    ``P(V) = fn(pd, fac, V)``."""

    def __init__(self, fn: Callable, fac: Any, pd: ProblemData):
        self.fn = fn
        self.fac = fac
        self.pd = pd

    def __call__(self, V):
        return self.fn(self.pd, self.fac, V)


def _identity_fn(pd, fac, V):
    return V


def _diag_fn(pd, fac, V):
    return fac * V


def _block_jacobi_fn(pd, fac, V):
    r = V.shape[1]
    Vrot = V[:pd.rot_size].reshape(pd.n, pd.d, r)
    return torch.cat([(fac["inv_blocks"] @ Vrot).reshape(pd.rot_size, r),
                      fac["inv_scalar"] * V[pd.rot_size:]])


def _implicit_fn(inner):
    """`inner` on the reduced [rot | sphere] state: lift with zero
    translations, apply, truncate."""
    def fn(pd, fac, V):
        lifted = torch.cat(
            [V, V.new_zeros((pd.num_translations, V.shape[1]))])
        return inner(pd, fac, lifted)[: pd.rot_range_size]

    return fn


def implicit_precond(full: PrecondOp) -> PrecondOp:
    """The implicit formulation's preconditioner: the full `PrecondOp` on
    the reduced state lifted with zero translations, truncated back
    (reference `CORA_problem.cpp:869-903`)."""
    return PrecondOp(_implicit_fn(full.fn), full.fac, full.pd)


def make_preconditioner(problem, pd: ProblemData, kind: Preconditioner,
                        reg_chol_max_cond: float = 1e6) -> PrecondOp:
    """The preconditioner `kind` for `problem`, on `pd`'s device and dtype."""
    if kind == Preconditioner.NONE:
        return identity_preconditioner(pd)
    if kind == Preconditioner.JACOBI:
        return jacobi_preconditioner(pd)
    if kind == Preconditioner.BLOCK_JACOBI:
        return block_jacobi_preconditioner(pd)
    if kind == Preconditioner.BLOCK_CHOLESKY:
        from cora_tpu_torch.precond.banded import block_cholesky_preconditioner

        return block_cholesky_preconditioner(problem, pd)
    if kind == Preconditioner.REGULARIZED_CHOLESKY:
        from cora_tpu_torch.precond.banded import (
            banded_cholesky_preconditioner,
        )

        return banded_cholesky_preconditioner(problem, pd,
                                              max_cond=reg_chol_max_cond)
    raise ValueError(f"unknown preconditioner {kind}")


def identity_preconditioner(pd: ProblemData | None = None) -> PrecondOp:
    return PrecondOp(_identity_fn, None, pd)


def jacobi_preconditioner(pd: ProblemData) -> PrecondOp:
    """P = diag(Q)⁻¹ (reference `CORA_problem.cpp:616-618`)."""
    from cora_tpu_torch.ops.quadratic import jacobi_diagonal

    diag = jacobi_diagonal(pd)
    inv_diag = torch.where(diag > 0, 1.0 / diag, torch.ones_like(diag))
    return PrecondOp(_diag_fn, inv_diag[:, None], pd)


def block_jacobi_preconditioner(pd: ProblemData,
                                eps: float = 1e-3) -> PrecondOp:
    """Inverses of the d×d rotation-block diagonal of Q (degree · I +
    Σ_e τ_e t_e t_eᵀ over the edges leaving the pose), plus its scalar
    rows, each regularised by `eps`."""
    from cora_tpu_torch.ops.quadratic import jacobi_diagonal

    d, n, dt, dev = pd.d, pd.n, pd.dtype(), pd.device
    eye = torch.eye(d, dtype=dt, device=dev)
    terms = []
    if pd.num_rot_edges:
        k = pd.rot_kappa[:, None, None] * eye
        terms += [k, k]
    if pd.num_pose_meas:
        terms.append(pd.pm_tau[:, None, None]
                     * (pd.pm_t[:, :, None] * pd.pm_t[:, None, :]))
    blocks = pd.incidence.rot(torch.cat(terms)) if terms else \
        torch.zeros((n, d, d), dtype=dt, device=dev)
    inv_blocks = torch.linalg.inv(blocks + eps * eye)
    scalar = jacobi_diagonal(pd)[pd.rot_size:]
    inv_scalar = torch.where(scalar > 0, 1.0 / (scalar + eps),
                             torch.ones_like(scalar))[:, None]
    return PrecondOp(_block_jacobi_fn,
                     {"inv_blocks": inv_blocks, "inv_scalar": inv_scalar}, pd)
