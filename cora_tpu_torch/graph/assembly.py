"""Host-side (scipy) assembly of the data matrix Q and its submatrices.

This is the *golden* assembly path, validated byte-for-byte against the
reference's MATLAB-exported MatrixMarket fixtures. The device solver
never materializes Q — it uses the factored edge-list form built in
`cora_tpu_torch.graph.data` — but this path backs:

  * the golden-fixture tests (reference `tests/test_utils.cpp:110-178`);
  * host-factored preconditioners (banded Cholesky + Woodbury);
  * small-problem dense certification.

Block structure (reference `CORA_problem.h:147-183`):

            dn                 m                  n + l
  ┌───────────────────┬─────────────────┬───────────────────────┐
  │  Lrho + T'·Ωt·T   │        0        │      T'·Ωt·At         │  dn
  │       sym         │    Ωr·D·D       │      D·Ωr·Ar          │  m
  │       sym         │       sym       │   At'·Ωt·At + Ar'·Ωr·Ar │ n+l
  └───────────────────┴─────────────────┴───────────────────────┘

Measurement-row ordering in T / At / Ωt is
[rel-pose | pose priors | pose-landmark | landmark priors]
(reference `CORA_problem.cpp:188-295`: priors enter as edges from the
origin pose `O0`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from cora_tpu_torch.graph.problem import ORIGIN_SYMBOL, Problem


@dataclasses.dataclass
class Submatrices:
    """Mirrors the reference's `CoraDataSubmatrices` (`CORA_problem.h:32-45`)."""

    range_incidence_matrix: sp.csr_matrix  # Ar: (m, n+l)
    range_dist_matrix: sp.csr_matrix  # D: (m, m) diagonal
    range_precision_matrix: sp.csr_matrix  # Ωr: (m, m) diagonal
    rel_pose_incidence_matrix: sp.csr_matrix  # At: (E, n+l)
    rel_pose_translation_data_matrix: sp.csr_matrix  # T: (E, dn)
    rel_pose_translation_precision_matrix: sp.csr_matrix  # Ωt: (E, E) diagonal
    rel_pose_rotation_precision_matrix: sp.csr_matrix  # Ωρ: (E_pp, E_pp) diagonal
    rotation_conn_laplacian: sp.csr_matrix  # Lρ: (dn, dn)


def build_submatrices(problem: Problem) -> Submatrices:
    d = problem.dim
    n = problem.num_poses
    l = problem.num_landmarks
    m = problem.num_range_measurements
    n_trans = n + l
    trans_offset = problem.rot_and_range_matrix_size

    # ----- range submatrices (reference `fillRangeSubmatrices`) -----
    rng_rows, rng_cols, rng_vals = [], [], []
    dist = np.zeros(m)
    omega_r = np.zeros(m)
    for e, meas in enumerate(problem.range_measurements):
        dist[e] = meas.r
        omega_r[e] = meas.precision()
        i = problem.translation_idx(meas.first_id) - trans_offset
        j = problem.translation_idx(meas.second_id) - trans_offset
        rng_rows += [e, e]
        rng_cols += [i, j]
        rng_vals += [-1.0, 1.0]
    Ar = sp.csr_matrix((rng_vals, (rng_rows, rng_cols)), shape=(m, n_trans))
    D = sp.diags(dist, format="csr", shape=(m, m))
    Omega_r = sp.diags(omega_r, format="csr", shape=(m, m))

    # ----- pose-measurement submatrices (reference `fillRelPoseSubmatrices`)
    # row order: [rel-pose | pose priors | pose-landmark | landmark priors]
    rows = []  # (ti, tj, tvec, tau) per measurement row; ti indexes translations,
    # and the T block sits at the *from*-pose's rotation block ti (ti < n).
    for meas in problem.rel_pose_measurements:
        rows.append(
            (
                problem.translation_idx(meas.first_id) - trans_offset,
                problem.translation_idx(meas.second_id) - trans_offset,
                meas.t,
                meas.trans_precision(),
            )
        )
    for prior in problem.pose_priors:
        rows.append(
            (
                problem.translation_idx(ORIGIN_SYMBOL) - trans_offset,
                problem.translation_idx(prior.id) - trans_offset,
                prior.t,
                prior.trans_precision(),
            )
        )
    for meas in problem.rel_pose_landmark_measurements:
        rows.append(
            (
                problem.translation_idx(meas.first_id) - trans_offset,
                problem.translation_idx(meas.second_id) - trans_offset,
                meas.t,
                meas.trans_precision(),
            )
        )
    for prior in problem.landmark_priors:
        rows.append(
            (
                problem.translation_idx(ORIGIN_SYMBOL) - trans_offset,
                problem.translation_idx(prior.id) - trans_offset,
                prior.p,
                prior.trans_precision(),
            )
        )

    E = len(rows)
    at_rows, at_cols, at_vals = [], [], []
    t_rows, t_cols, t_vals = [], [], []
    tau = np.zeros(E)
    for e, (ti, tj, tvec, tau_e) in enumerate(rows):
        tau[e] = tau_e
        at_rows += [e, e]
        at_cols += [ti, tj]
        at_vals += [-1.0, 1.0]
        for k in range(d):
            t_rows.append(e)
            t_cols.append(ti * d + k)
            t_vals.append(-tvec[k])
    At = sp.csr_matrix((at_vals, (at_rows, at_cols)), shape=(E, n_trans))
    T = sp.csr_matrix((t_vals, (t_rows, t_cols)), shape=(E, n * d))
    Omega_t = sp.diags(tau, format="csr", shape=(E, E))

    # rotation precisions: only rel-pose + pose priors carry one
    rot_edges = [
        (problem.rotation_idx(meas.first_id), problem.rotation_idx(meas.second_id),
         meas.R, meas.rot_precision())
        for meas in problem.rel_pose_measurements
    ] + [
        (problem.rotation_idx(ORIGIN_SYMBOL), problem.rotation_idx(prior.id),
         prior.R, prior.rot_precision())
        for prior in problem.pose_priors
    ]
    E_pp = problem.num_pose_pose_measurements
    Omega_rho = sp.diags(
        np.array([k for (_, _, _, k) in rot_edges[:E_pp]]),
        format="csr",
        shape=(E_pp, E_pp),
    )

    # ----- rotation connection Laplacian (reference `fillRotConnLaplacian`)
    lr, lc, lv = [], [], []
    for (i, j, R, kappa) in rot_edges:
        for k in range(d):
            lr.append(d * i + k); lc.append(d * i + k); lv.append(kappa)
            lr.append(d * j + k); lc.append(d * j + k); lv.append(kappa)
        for r_ in range(d):
            for c_ in range(d):
                lr.append(i * d + r_); lc.append(j * d + c_); lv.append(-kappa * R[r_, c_])
                lr.append(j * d + r_); lc.append(i * d + c_); lv.append(-kappa * R[c_, r_])
    Lrho = sp.csr_matrix((lv, (lr, lc)), shape=(n * d, n * d))

    return Submatrices(
        range_incidence_matrix=Ar,
        range_dist_matrix=D,
        range_precision_matrix=Omega_r,
        rel_pose_incidence_matrix=At,
        rel_pose_translation_data_matrix=T,
        rel_pose_translation_precision_matrix=Omega_t,
        rel_pose_rotation_precision_matrix=Omega_rho,
        rotation_conn_laplacian=Lrho,
    )


def build_data_matrix(sub: Submatrices) -> sp.csr_matrix:
    """Assemble the full symmetric Q (reference `fillDataMatrix`)."""
    Lrho = sub.rotation_conn_laplacian
    T = sub.rel_pose_translation_data_matrix
    Omega_t = sub.rel_pose_translation_precision_matrix
    At = sub.rel_pose_incidence_matrix
    Ar = sub.range_incidence_matrix
    D = sub.range_dist_matrix
    Omega_r = sub.range_precision_matrix

    dn = Lrho.shape[0]
    m = D.shape[0]
    n_trans = At.shape[1]

    Q11 = Lrho + T.T @ Omega_t @ T
    Q13 = T.T @ Omega_t @ At
    OmegaRD = Omega_r @ D
    Q22 = OmegaRD @ D
    Q23 = OmegaRD @ Ar
    Q33 = At.T @ Omega_t @ At + Ar.T @ Omega_r @ Ar

    Z12 = sp.csr_matrix((dn, m))
    Q = sp.bmat(
        [[Q11, Z12, Q13], [Z12.T, Q22, Q23], [Q13.T, Q23.T, Q33]], format="csr"
    )
    return Q
