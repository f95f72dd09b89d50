"""Riemannian calculus on the full product manifold, in stacked-state form.

Combines the blockwise manifold ops (`cora_tpu_torch.ops.manifolds`) with
the factored Q operator (`cora_tpu_torch.ops.quadratic`) into what the
canonical trust-region solver needs (reference
`src/CORA_problem.cpp:742-938`, functors of `src/CORA.cpp:52-125`; JAX
package `cora_tpu/ops/riemannian.py`). Every function takes an explicit
`ProblemData`; the state's device and dtype are the tensors' own.
"""

from __future__ import annotations

import torch

from cora_tpu_torch.graph.data import ProblemData
from cora_tpu_torch.ops import manifolds as mf
from cora_tpu_torch.ops.quadratic import (
    data_matrix_product,
    join_state,
    split_state,
)


def tangent_space_projection(pd: ProblemData, Y: torch.Tensor,
                             V: torch.Tensor) -> torch.Tensor:
    """Blockwise projection onto T_Y (reference `CORA_problem.cpp:782-820`)."""
    Yrot, Ysph, _ = split_state(pd, Y)
    Vrot, Vsph, Vtr = split_state(pd, V)
    return join_state(pd, mf.stiefel_tangent_project(Yrot, Vrot),
                      mf.oblique_tangent_project(Ysph, Vsph), Vtr)


def riemannian_gradient(pd: ProblemData, Y: torch.Tensor, nablaF=None,
                        op=None) -> torch.Tensor:
    """grad f(Y) = Proj_{T_Y}(∇F), ∇F = QY (or `op(Y)`) unless given."""
    if nablaF is None:
        nablaF = op(Y) if op is not None else data_matrix_product(pd, Y)
    return tangent_space_projection(pd, Y, nablaF)


def riemannian_hvp(pd: ProblemData, Y: torch.Tensor, nablaF: torch.Tensor,
                   dotY: torch.Tensor, op=None) -> torch.Tensor:
    """Hess f(Y)[Ẏ] = Proj_{T_Y}(Q Ẏ − blockwise Weingarten corrections)
    (reference `CORA_problem.cpp:822-867`). `op` is the quadratic-form
    operator (explicit Q when None; the marginalized Q̃ in implicit mode);
    the blockwise terms work on either state height."""
    H = op(dotY) if op is not None else data_matrix_product(pd, dotY)
    Yrot, Ysph, _ = split_state(pd, Y)
    Grot, Gsph, _ = split_state(pd, nablaF)
    Hrot, Hsph, Htr = split_state(pd, H)
    drot, dsph, _ = split_state(pd, dotY)
    Hrot = mf.stiefel_tangent_project(
        Yrot, Hrot - mf.stiefel_hess_correction(Yrot, Grot, drot))
    inner = (Gsph * Ysph).sum(-1, keepdim=True)
    Hsph = mf.oblique_tangent_project(Ysph, Hsph - inner * dsph)
    return join_state(pd, Hrot, Hsph, Htr)


def project_to_manifold(pd: ProblemData, A: torch.Tensor) -> torch.Tensor:
    """Blockwise metric projection (reference `CORA_problem.cpp:905-934`);
    `A` is (N, r) or a batch (..., N, r) of states."""
    Arot, Asph, Atr = split_state(pd, A)
    return join_state(pd, mf.stiefel_project(Arot), mf.oblique_project(Asph),
                      Atr)


def retract(pd: ProblemData, Y: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Projection-based retraction (reference `CORA_problem.cpp:936-938`)."""
    return project_to_manifold(pd, Y + V)


def random_initial_guess(pd: ProblemData, rank: int,
                         generator: torch.Generator, dtype=None,
                         device=None, height=None) -> torch.Tensor:
    """Random point on the manifold (reference `CORA_problem.cpp:1023-1028`):
    uniform in [−1, 1], Stiefel blocks projected by a float64 SVD (polar
    U Vᵀ, defined even for a singular block), bearing rows normalised.
    Draws on the CPU from `generator`, so a seed gives the same start on
    every device. (The JAX package draws its start with jax.random,
    whose stream torch cannot reproduce: parity tests pass x0 in.)
    `height` overrides the state height (rot_range_size in implicit mode)."""
    A = torch.rand((height or pd.size, rank), generator=generator,
                   dtype=torch.float64) * 2.0 - 1.0
    nd = pd.rot_size
    U, _, Vh = torch.linalg.svd(A[:nd].view(pd.n, pd.d, rank),
                                full_matrices=False)
    A[:nd] = (U @ Vh).reshape(nd, rank)
    if pd.m:
        sph = A[nd:nd + pd.m]
        A[nd:nd + pd.m] = sph / torch.clamp(
            sph.norm(dim=1, keepdim=True), min=1e-30)
    return A.to(device or pd.device, dtype or pd.dtype())
