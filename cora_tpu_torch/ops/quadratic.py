"""The data-matrix operator ``Y ↦ QY`` on any graph.

The reference computes it as a generic sparse SpMM
(`src/CORA_problem.cpp:742-757`). As in the JAX package
(`cora_tpu/ops/quadratic.py`), Q stays in factored edge form and QY comes
straight from the measurement model. With Y split into rotation rows Yrot
(n,d,r), unit-bearing rows Ysph (m,r) and translation rows Ytr (n+l,r):

  pose edge e=(i,j):   u_e = t_j − t_i − t_eᵀ Y_i
    (QY)_rot[i] += κ_e (Y_i − R_e Y_j) − t_e ⊗ (τ_e u_e)
    (QY)_rot[j] += κ_e (Y_j − R_eᵀ Y_i)
    (QY)_tr[j]  += τ_e u_e ;  (QY)_tr[i] −= τ_e u_e
  range edge e=(i,j):  v_e = r_e y_e + t_j − t_i
    (QY)_sph[e]  = ω_e r_e v_e
    (QY)_tr[j]  += ω_e v_e ;  (QY)_tr[i] −= ω_e v_e

The per-edge terms (`edge_terms`, which the sharded products of
`cora_tpu_torch.parallel.sharding` share) are summed onto rows by the
fixed-order segment sums of `ProblemData.incidence` (a gather and a `sum`),
so the product is the same bits on every run, on the CPU and on the card
alike. Edge lists may be in any order: loop closures, inter-robot ranges,
several robots.
"""

from __future__ import annotations

import torch

from cora_tpu_torch.graph.data import ProblemData
from cora_tpu_torch.ops.linalg import bmm, bmm_T


def split_state(pd: ProblemData, Y: torch.Tensor):
    """(..., N, r) → views (Yrot (..., n, d, r), Ysph (..., m, r),
    Ytr (..., n+l, r))."""
    nd = pd.rot_size
    return (Y[..., :nd, :].unflatten(-2, (pd.n, pd.d)),
            Y[..., nd:nd + pd.m, :], Y[..., nd + pd.m:, :])


def join_state(pd: ProblemData, Yrot, Ysph, Ytr) -> torch.Tensor:
    return torch.cat([Yrot.flatten(-3, -2), Ysph, Ytr], dim=-2)


def edge_terms(e, Yrot, Ytr, ys):
    """The per-edge terms of QY over the edge lists of `e` (a
    `ProblemData`, or one shard's edges with the same field names), with
    `ys` the bearing rows of its range edges: (rot_terms, tr_terms, sph).
    The rotation terms belong to the blocks at [rot_i | rot_j | pm_ti], the
    translation terms to the translations at [pm_tj | pm_ti | rng_tj |
    rng_ti], and `sph` (None without range edges) to the bearing rows."""
    rot_terms, tr_terms, sph = [], [], None
    if len(e.rot_i):
        Yi, Yj = Yrot[e.rot_i], Yrot[e.rot_j]
        k = e.rot_kappa[:, None, None]
        rot_terms += [k * (Yi - bmm(e.rot_R, Yj)),
                      k * (Yj - bmm_T(e.rot_R, Yi))]
    if len(e.pm_ti):
        u = (Ytr[e.pm_tj] - Ytr[e.pm_ti]
             - (e.pm_t[:, :, None] * Yrot[e.pm_ti]).sum(1))
        w = e.pm_tau[:, None] * u
        rot_terms.append(-e.pm_t[:, :, None] * w[:, None, :])
        tr_terms += [w, -w]
    if len(e.rng_ti):
        rr = e.rng_r[:, None]
        wr = e.rng_omega[:, None] * (rr * ys + Ytr[e.rng_tj] - Ytr[e.rng_ti])
        sph = rr * wr
        tr_terms += [wr, -wr]
    return rot_terms, tr_terms, sph


def data_matrix_product(pd: ProblemData, Y: torch.Tensor) -> torch.Tensor:
    """Explicit-formulation product QY for Y of shape (N, r)."""
    inc = pd.incidence
    Yrot, Ysph, Ytr = split_state(pd, Y)
    rot_terms, tr_terms, out_sph = edge_terms(pd, Yrot, Ytr, Ysph)
    out_rot = inc.rot(torch.cat(rot_terms)) if rot_terms else \
        torch.zeros_like(Yrot)
    out_tr = inc.tr(torch.cat(tr_terms)) if tr_terms else \
        torch.zeros_like(Ytr)
    return join_state(pd, out_rot, Ysph if out_sph is None else out_sph,
                      out_tr)


def evaluate_objective(pd: ProblemData, Y: torch.Tensor) -> torch.Tensor:
    """f(Y) = ½ tr(Yᵀ Q Y) (reference `CORA_problem.cpp:759-762`)."""
    return 0.5 * (Y * data_matrix_product(pd, Y)).sum()


def euclidean_gradient(pd: ProblemData, Y: torch.Tensor) -> torch.Tensor:
    """∇F(Y) = QY (reference `CORA_problem.cpp:764-770`)."""
    return data_matrix_product(pd, Y)


def jacobi_diagonal(pd: ProblemData) -> torch.Tensor:
    """diag(Q) as an (N,) vector from the factored form (reference
    `CORA_problem.cpp:616-618`): κ per incident rotation edge and τ t_e²
    on the rotation rows, ω r² on the bearing rows, the Laplacian degrees
    on the translation rows."""
    inc = pd.incidence
    dt, dev = pd.dtype(), pd.device
    ones = torch.ones((1, pd.d), dtype=dt, device=dev)
    rot_terms = []
    tr_terms = []
    if pd.num_rot_edges:
        k = pd.rot_kappa[:, None] * ones
        rot_terms += [k, k]
    if pd.num_pose_meas:
        rot_terms.append(pd.pm_tau[:, None] * pd.pm_t ** 2)
        tr_terms += [pd.pm_tau, pd.pm_tau]
    if pd.m:
        tr_terms += [pd.rng_omega, pd.rng_omega]
    diag_rot = inc.rot(torch.cat(rot_terms)) if rot_terms else \
        torch.zeros((pd.n, pd.d), dtype=dt, device=dev)
    diag_tr = inc.tr(torch.cat(tr_terms)) if tr_terms else \
        torch.zeros(pd.num_translations, dtype=dt, device=dev)
    return torch.cat([diag_rot.reshape(-1), pd.rng_omega * pd.rng_r ** 2,
                      diag_tr])
