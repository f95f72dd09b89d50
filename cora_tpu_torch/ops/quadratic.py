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

The per-edge terms are summed onto rows by the fixed-order segment sums of
`ProblemData.incidence` (a gather and a `sum`), so the product is the same
bits on every run, on the CPU and on the card alike. Edge lists may be in
any order: loop closures, inter-robot ranges, several robots.
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


def data_matrix_product(pd: ProblemData, Y: torch.Tensor) -> torch.Tensor:
    """Explicit-formulation product QY for Y of shape (N, r)."""
    inc = pd.incidence
    Yrot, Ysph, Ytr = split_state(pd, Y)
    rot_terms = []
    tr_terms = []
    if pd.num_rot_edges:
        Yi, Yj = Yrot[pd.rot_i], Yrot[pd.rot_j]
        k = pd.rot_kappa[:, None, None]
        rot_terms += [k * (Yi - bmm(pd.rot_R, Yj)),
                      k * (Yj - bmm_T(pd.rot_R, Yi))]
    if pd.num_pose_meas:
        u = (Ytr[pd.pm_tj] - Ytr[pd.pm_ti]
             - (pd.pm_t[:, :, None] * Yrot[pd.pm_ti]).sum(1))
        w = pd.pm_tau[:, None] * u
        rot_terms.append(-pd.pm_t[:, :, None] * w[:, None, :])
        tr_terms += [w, -w]
    if pd.m:
        rr = pd.rng_r[:, None]
        wr = pd.rng_omega[:, None] * (rr * Ysph + Ytr[pd.rng_tj]
                                      - Ytr[pd.rng_ti])
        out_sph = rr * wr
        tr_terms += [wr, -wr]
    else:
        out_sph = Ysph
    out_rot = inc.rot(torch.cat(rot_terms)) if rot_terms else \
        torch.zeros_like(Yrot)
    out_tr = inc.tr(torch.cat(tr_terms)) if tr_terms else \
        torch.zeros_like(Ytr)
    return join_state(pd, out_rot, out_sph, out_tr)


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
