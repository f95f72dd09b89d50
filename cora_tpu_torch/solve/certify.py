"""Optimality certification: Lagrange multipliers and the PSD decision.

Parity with the reference (`src/CORA_problem.cpp:1030-1166`,
`src/CORA_utils.cpp:17-186`):

  1. Λ blocks — Stiefel: sym((QY)_i Y_iᵀ) per pose; Oblique: row inner
     products ⟨Y_e, (QY)_e⟩ (`CORA_problem.cpp:1105-1131`).
  2. Certificate S = Q − Λ; S + ηI ⪰ 0 ⟺ the rank-restricted solution is
     a global optimum of the SDP relaxation.
  3. Small problems (N ≤ 100): dense eigendecomposition
     (`CORA_utils.cpp:63-74`).
  4. Otherwise the host float64 cascade: the exact banded Cholesky of
     S + ηI decides wherever the chain band is exact (every reference
     dataset); when it says NOT PD, the escape eigenpair comes from
     shift-invert Lanczos (`cora_tpu_torch.solve.verification`). Where
     the band is inexact, the sparse LDLᵀ/Lanczos cascade decides.
  5. NaN-θ retry with doubled η happens in the caller
     (`CORA_problem.cpp:1076-1083` → `cora_tpu_torch.solve.staircase`).

Everything here is host numpy/scipy in float64 (the Λ of the dense path
is formed in the dtype of the state and the problem data, as the JAX
package forms it).
"""

from __future__ import annotations

import numpy as np
import torch

from cora_tpu_torch.types import CertResults

DENSE_CUTOFF = 100  # reference `CORA_utils.cpp:63`


def _to_numpy(Y) -> np.ndarray:
    if isinstance(Y, torch.Tensor):
        return Y.detach().cpu().numpy()
    return np.asarray(Y)


def _edge_arrays(pd) -> dict:
    return {k: getattr(pd, k).detach().cpu().numpy() for k in (
        "rot_i", "rot_j", "rot_R", "rot_kappa", "pm_ti", "pm_tj", "pm_t",
        "pm_tau", "rng_ti", "rng_tj", "rng_r", "rng_omega")}


def data_matrix_product_np(pd, Y: np.ndarray) -> np.ndarray:
    """Q·Y on the host from the edge lists, general graphs, in the dtype
    that the state and the problem data promote to."""
    a = _edge_arrays(pd)
    dt = np.result_type(a["rng_r"].dtype, a["pm_t"].dtype, Y.dtype)
    Y = Y.astype(dt, copy=False)
    d, n, m = pd.d, pd.n, pd.m
    r = Y.shape[1]
    nd = n * d
    Yrot = Y[:nd].reshape(n, d, r)
    Ysph = Y[nd:nd + m]
    Ytr = Y[nd + m:]
    out_rot = np.zeros_like(Yrot)
    out_tr = np.zeros_like(Ytr)
    if pd.num_rot_edges:
        Yi, Yj = Yrot[a["rot_i"]], Yrot[a["rot_j"]]
        k = a["rot_kappa"].astype(dt)[:, None, None]
        R = a["rot_R"].astype(dt)
        np.add.at(out_rot, a["rot_i"], k * (Yi - R @ Yj))
        np.add.at(out_rot, a["rot_j"], k * (Yj - np.swapaxes(R, 1, 2) @ Yi))
    if pd.num_pose_meas:
        t = a["pm_t"].astype(dt)
        u = (Ytr[a["pm_tj"]] - Ytr[a["pm_ti"]]
             - np.sum(t[:, :, None] * Yrot[a["pm_ti"]], axis=1))
        wv = a["pm_tau"].astype(dt)[:, None] * u
        np.add.at(out_rot, a["pm_ti"], -t[:, :, None] * wv[:, None, :])
        np.add.at(out_tr, a["pm_tj"], wv)
        np.add.at(out_tr, a["pm_ti"], -wv)
    if m:
        rr = a["rng_r"].astype(dt)[:, None]
        v = rr * Ysph + Ytr[a["rng_tj"]] - Ytr[a["rng_ti"]]
        wr = a["rng_omega"].astype(dt)[:, None] * v
        out_sph = rr * wr
        np.add.at(out_tr, a["rng_tj"], wr)
        np.add.at(out_tr, a["rng_ti"], -wr)
    else:
        out_sph = Ysph
    return np.concatenate([out_rot.reshape(nd, r), out_sph, out_tr], axis=0)


def compute_lambda_blocks(pd, Y):
    """Lagrange-multiplier blocks (reference `compute_Lambda_blocks`)."""
    Y = _to_numpy(Y)
    QY = data_matrix_product_np(pd, Y)
    Y = Y.astype(QY.dtype, copy=False)
    d, n, m = pd.d, pd.n, pd.m
    r = Y.shape[1]
    Yrot = Y[:n * d].reshape(n, d, r)
    Grot = QY[:n * d].reshape(n, d, r)
    P = Grot @ np.swapaxes(Yrot, 1, 2)  # (QY)_i Y_iᵀ per pose
    Lam_rot = 0.5 * (P + np.swapaxes(P, 1, 2))
    lam_sph = np.sum(Y[n * d:n * d + m] * QY[n * d:n * d + m], axis=-1)
    return Lam_rot, lam_sph


def materialize_certificate(problem, pd, Y) -> np.ndarray:
    """Dense S = Q − Λ on the host (small problems)."""
    Q = problem.data_matrix().toarray()
    Lam_rot, lam_sph = compute_lambda_blocks(pd, Y)
    S = Q.copy()
    d = pd.d
    for i in range(pd.n):
        S[i * d:(i + 1) * d, i * d:(i + 1) * d] -= Lam_rot[i]
    for e in range(pd.m):
        S[pd.rot_size + e, pd.rot_size + e] -= lam_sph[e]
    return S


def certify_solution(
    problem,
    pd,
    Y,
    eta: float,
    nx: int = 10,
    eigvec_bootstrap=None,
    max_lobpcg_iters: int = 500,
    method: str = "host",
    eig_tol: float = 1e-5,
) -> CertResults:
    """Certify Y as a global optimum (reference `certify_solution`).

    `method="host"` is the only method of this port: the PSD decision is
    the exact float64 banded Cholesky of S + ηI wherever the graph's band
    is exact, and on a NOT-PD verdict the escape eigenpair comes from the
    host shift-invert Lanczos. The device LOBPCG (`method="auto"` and
    `"device"` in the JAX package) is not ported yet."""
    if method != "host":
        raise NotImplementedError(f"certify method {method!r}: only 'host'")
    Y = _to_numpy(Y)
    N = pd.size
    r = Y.shape[1]
    num_eigvecs = min(max(nx, r + 2), N)

    if N <= DENSE_CUTOFF:
        S = materialize_certificate(problem, pd, Y)
        w, V = np.linalg.eigh(S)
        theta = float(w[0])
        return CertResults(
            is_certified=bool(theta >= -eta),
            theta=theta,
            x=V[:, 0],
            all_eigvecs=V[:, :num_eigvecs],
            num_iters=0,
        )

    from cora_tpu_torch.precond.banded import factor_banded
    from cora_tpu_torch.solve.verification import (
        certificate_matrix_host,
        verify_psd_host,
    )

    eta = float(eta)
    pd_host = problem.device_data(dtype=np.float64, device="cpu")
    S_host = certificate_matrix_host(
        pd_host, problem.data_matrix(), np.asarray(Y, np.float64))
    band_exact = True
    if pd.n:
        try:
            factor_banded(problem, pd_host, S_host, eta, require_exact=True)
            return CertResults(
                is_certified=True,
                theta=0.0,
                x=np.zeros(N),
                all_eigvecs=np.zeros((N, num_eigvecs)),
                num_iters=0,
            )
        except np.linalg.LinAlgError:
            pass  # definitively NOT PD: the Lanczos stage finds the eigvec
        except ValueError:
            band_exact = False  # the LDLᵀ/Lanczos cascade decides
    else:
        band_exact = False

    v0 = None
    if eigvec_bootstrap is not None:
        boot = _to_numpy(eigvec_bootstrap)
        v0 = boot[:, 0] if boot.ndim == 2 else boot
        if v0.shape[0] != N:
            v0 = None
    hv = verify_psd_host(
        S_host, eta, nev=num_eigvecs, v0=v0, tol=eig_tol,
        maxiter=max_lobpcg_iters,
    )
    if band_exact:
        # the exact banded factorization already decided NOT PD; the host
        # eigenpair only supplies the escape direction, and only when it
        # agrees that S + ηI is not PD
        if hv.is_psd:
            return CertResults(
                is_certified=False, theta=float("-inf"), x=np.zeros(N),
                all_eigvecs=np.zeros((N, num_eigvecs)),
                num_iters=hv.num_eig_iters,
            )
        certified = False
    else:
        certified = bool(hv.is_psd)
    return CertResults(
        is_certified=certified,
        theta=hv.theta,
        x=hv.x,
        all_eigvecs=hv.eigvecs,
        num_iters=hv.num_eig_iters,
    )
