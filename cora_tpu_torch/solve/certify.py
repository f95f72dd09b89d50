"""Optimality certification: Lagrange multipliers, the PSD decision and
the escape eigenvector.

Parity with the reference (`src/CORA_problem.cpp:1030-1166`,
`src/CORA_utils.cpp:17-186`) and with the JAX package's
`cora_tpu/solve/certify.py`:

  1. Λ blocks — Stiefel: sym((QY)_i Y_iᵀ) per pose; Oblique: row inner
     products ⟨Y_e, (QY)_e⟩ (`CORA_problem.cpp:1105-1131`).
  2. Certificate S = Q − Λ; S + ηI ⪰ 0 ⟺ the rank-restricted solution is
     a global optimum of the SDP relaxation.
  3. Small problems (N ≤ 100): dense eigendecomposition
     (`CORA_utils.cpp:63-74`).
  4. `method="host"`: the host float64 cascade — the exact banded Cholesky
     of S + ηI decides wherever the band is exact; on NOT PD the escape
     eigenpair comes from shift-invert Lanczos
     (`cora_tpu_torch.solve.verification`).
  5. `method="auto"` (what the staircase uses): the same exact float64
     banded decision; on NOT PD the escape eigenvector comes from the
     two-stage LOBPCG on the solve's device, preconditioned by the banded
     factor of S + σI (σ escalated until it factors) — the ILDL analog of
     `CORA_utils.cpp:128-176`. Where the band is inexact the whole test
     goes to the host cascade. `method="device"` lets the LOBPCG decide
     too, on a converged verdict only.
  6. NaN-θ retry with doubled η happens in the caller
     (`CORA_problem.cpp:1076-1083` → `cora_tpu_torch.solve.staircase`).

S is never formed on the device: S·V = Q·V − Λ·V with Q in factored edge
form and Λ as batched d×d blocks plus a diagonal.
"""

from __future__ import annotations

import numpy as np
import torch

from cora_tpu_torch.ops import lobpcg as _lobpcg
from cora_tpu_torch.ops.lobpcg import LobpcgLoop, lobpcg_min
from cora_tpu_torch.ops.quadratic import (
    data_matrix_product,
    jacobi_diagonal,
    join_state,
    split_state,
)
from cora_tpu_torch.types import CertResults
from cora_tpu_torch.utils import graphs as loops
from cora_tpu_torch.utils.timing import named_scope

DENSE_CUTOFF = 100  # reference `CORA_utils.cpp:63`


def _to_numpy(Y) -> np.ndarray:
    if isinstance(Y, torch.Tensor):
        return Y.detach().cpu().numpy()
    return np.asarray(Y)


def compute_lambda_blocks(pd, Y: torch.Tensor, QY=None):
    """Lagrange-multiplier blocks (reference `compute_Lambda_blocks`):
    (Λ_rot (n, d, d), λ_sph (m,))."""
    if QY is None:
        QY = data_matrix_product(pd, Y)
    Yrot, Ysph, _ = split_state(pd, Y)
    Grot, Gsph, _ = split_state(pd, QY)
    P = Grot @ Yrot.transpose(-1, -2)  # (QY)_i Y_iᵀ per pose
    return 0.5 * (P + P.transpose(-1, -2)), (Ysph * Gsph).sum(-1)


def apply_lambda(pd, Lam_rot, lam_sph, V: torch.Tensor) -> torch.Tensor:
    Vrot, Vsph, Vtr = split_state(pd, V)
    return join_state(pd, Lam_rot @ Vrot, lam_sph[:, None] * Vsph,
                      torch.zeros_like(Vtr))


def make_certificate_operator(pd, Y: torch.Tensor):
    """(S, (Λ_rot, λ_sph)) with S(V) = QV − ΛV, Λ at Y."""
    Lam_rot, lam_sph = compute_lambda_blocks(pd, Y)

    def S(V):
        return data_matrix_product(pd, V) - apply_lambda(pd, Lam_rot,
                                                         lam_sph, V)

    return S, (Lam_rot, lam_sph)


def materialize_certificate(problem, pd, Y) -> np.ndarray:
    """Dense S = Q − Λ on the host (small problems). Λ is formed in the
    dtype that the state and the problem data promote to, as the JAX
    package forms it."""
    Y = torch.as_tensor(_to_numpy(Y))
    pdc = pd.to("cpu", torch.promote_types(pd.dtype(), Y.dtype))
    Lam_rot, lam_sph = compute_lambda_blocks(pdc, Y.to(pdc.dtype()))
    Lam_rot, lam_sph = Lam_rot.numpy(), lam_sph.numpy()
    S = problem.data_matrix().toarray()
    d = pd.d
    for i in range(pd.n):
        S[i * d:(i + 1) * d, i * d:(i + 1) * d] -= Lam_rot[i]
    for e in range(pd.m):
        S[pd.rot_size + e, pd.rot_size + e] -= lam_sph[e]
    return S


class _CertLoop:
    """The two LOBPCG stages of `_cert_eig_device` on M = S + ηI over kept
    buffers: Λ (`Lam_rot`, `lam_sph`), η and the stage-2 preconditioner's
    data (the banded factor's tensors, or the Jacobi diagonal) are copied
    in before each call, so one capture serves every certificate of a solve
    whose shapes match, as the JAX package compiles `_cert_eig_device` once
    with η and the factor as traced operands. Stage 2 starts from stage
    1's block buffer."""

    def __init__(self, pd, N, k, dtype, device, tol, bfac, blocks, graphs,
                 sync_debug):
        self.pd = pd
        self.Lam_rot = torch.zeros((pd.n, pd.d, pd.d), dtype=dtype,
                                   device=device)
        self.lam_sph = torch.zeros(pd.m, dtype=dtype, device=device)
        self.eta = torch.zeros((), dtype=dtype, device=device)
        if bfac is None:
            self.bfac = None
            self.inv_diag = torch.zeros((N, 1), dtype=dtype, device=device)

            def precon(V):
                return self.inv_diag * V
        else:
            from cora_tpu_torch.precond.banded import banded_apply

            self.bfac = {key: v.clone() if isinstance(v, torch.Tensor)
                         else v for key, v in bfac.items()}

            def precon(V):
                return banded_apply(pd, self.bfac, V)
        self.precon = precon
        args = (N, k, dtype, device, tol, 1)
        self.stage1 = LobpcgLoop(self.M_op, *args, None, True, blocks[0],
                                 graphs, sync_debug, read_last=False)
        self.stage2 = LobpcgLoop(self.M_op, *args, precon, True, blocks[1],
                                 graphs, sync_debug, X0=self.stage1.c["X"],
                                 report=self._report,
                                 report_size=5 + N * k)

    def M_op(self, V):
        return (data_matrix_product(self.pd, V)
                - apply_lambda(self.pd, self.Lam_rot, self.lam_sph, V)
                + self.eta * V)

    def _report(self, c, stop):
        """Stage 2's report: (stop, both stages' iterations, their
        eigensolver flag, θ = the leading Rayleigh quotient on S, the
        leading pair's residual on M) and the block, so the block that
        stops brings back everything `_cert_eig_device` returns."""
        X, s1 = c["X"], self.stage1.c
        MX = self.M_op(X[:, :1])
        x = X[:, 0]
        theta = x @ (MX[:, 0] - self.eta * x)
        resnorm = torch.linalg.vector_norm(MX - (theta + self.eta) * X[:, :1])
        dt = X.dtype
        head = torch.stack([stop.to(dt), (s1["it"] + c["it"]).to(dt),
                            (s1["bad"] | c["bad"]).to(dt), theta, resnorm])
        return torch.cat([head, X.reshape(-1)])

    def load(self, Lam_rot, lam_sph, eta: float, X0, bfac):
        """Copy this certificate's Λ, η, start block and preconditioner
        data into the buffers (outside any graph)."""
        pd = self.pd
        self.Lam_rot.copy_(Lam_rot)
        self.lam_sph.copy_(lam_sph)
        self.eta.fill_(eta)
        self.stage1.X0.copy_(X0)
        if bfac is not None:
            for key, v in bfac.items():
                if isinstance(v, torch.Tensor):
                    self.bfac[key].copy_(v)
            return
        lam_diag = torch.cat([
            torch.diagonal(Lam_rot, dim1=-2, dim2=-1).reshape(-1), lam_sph,
            lam_sph.new_zeros(pd.num_translations)])
        diagM = jacobi_diagonal(pd) - lam_diag + eta
        self.inv_diag.copy_(torch.where(
            diagM.abs() > 1e-8, 1.0 / diagM.abs(),
            torch.ones_like(diagM))[:, None])


def _factor_signature(bfac):
    """What a kept `_CertLoop`'s preconditioner buffers must match."""
    if bfac is None:
        return None
    return tuple(sorted(
        (key, tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor)
        else (key, v) for key, v in bfac.items()))


def _cert_eig_device(pd, Lam_rot, lam_sph, X0, eta, it1, it2, tol,
                     bfac=None):
    """Minimum eigenpair of S = Q − Λ by the two-stage LOBPCG cascade of
    `fast_verification` (`CORA_utils.cpp:90-176`) on M = S + ηI: stage 1
    unpreconditioned with a 1 % budget and an early stop on clearly
    negative curvature (θ_M < η/2 ⟺ θ_S < −η/2), stage 2 preconditioned
    with the rest. The stage-2 preconditioner is the banded factor of
    S + σI (`bfac`) when one exists, a clamped Jacobi diagonal otherwise.

    Both stages run as one device loop each (`ops.lobpcg.LobpcgLoop`),
    captured on a CUDA device and kept between calls (`_CertLoop`); the
    host reads one report per block, and stage 2's last brings back what
    the JAX program returns (the block covering stage 1's cap is not
    read). Returns (θ, x, block, iterations, ‖residual‖), x and the block
    on the host."""

    N, k = X0.shape
    dt, dev = X0.dtype, X0.device
    opts = loops.options()
    graphs = dev.type == "cuda" and opts.graphs
    # no block longer than its stage's cap: stage 1's (1 % of the budget)
    # is shorter than a block
    blocks = (min(_lobpcg.loop_block(graphs), max(it1, 1)),
              _lobpcg.loop_block(graphs))

    def make():
        return _CertLoop(pd, N, k, dt, dev, tol, bfac, blocks, graphs,
                         opts.sync_debug)

    if graphs:
        key = (id(pd), N, k, dt, dev, tol, blocks, _factor_signature(bfac),
               opts.sync_debug)
        cl = loops.keep("certificate", key, make)
        if cl.pd is not pd:
            cl = loops.keep("certificate", key, make, fresh=True)
    else:
        cl = make()
    cl.load(Lam_rot, lam_sph, eta, X0, bfac)
    M_op = cl.M_op
    with named_scope("certify/lobpcg1"):
        _, X1, _, _ = lobpcg_min(M_op, cl.stage1.X0, it1, tol=tol, nev=1,
                                 early_stop_below=eta / 2.0, loop=cl.stage1)
    with named_scope("certify/lobpcg2"):
        lobpcg_min(M_op, X1, it2, tol=tol, nev=1, precon=cl.precon,
                   early_stop_below=eta / 2.0, loop=cl.stage2)
    out = cl.stage2.last  # the stopping block's report
    _, iters, bad, theta, resnorm = out[:5].tolist()
    _lobpcg.LOOP_STATS["iterations"] += int(iters)
    if bad:
        raise RuntimeError("small_eigh did not converge in the certificate's "
                           "LOBPCG")
    X_blk = out[5:].reshape(N, k)
    return theta, X_blk[:, 0], X_blk, int(iters), resnorm


def certify_solution(
    problem,
    pd,
    Y,
    eta: float,
    nx: int = 10,
    eigvec_bootstrap=None,
    max_lobpcg_iters: int = 500,
    tol: float = 1e-3,
    seed: int = 0,
    rank_deficient_exit: bool = False,
    method: str = "host",
    eig_tol: float = 1e-5,
    escape_eig_iters: int | None = None,
) -> CertResults:
    """Certify Y as a global optimum (reference `certify_solution`).

    `pd` is the solve's problem data: the device LOBPCG runs on its device
    and in its dtype (the escape eigenvector needs no float64); the PSD
    decision is always float64 on the host. The LOBPCG start block comes
    from `np.random.default_rng(seed)`, with the bootstrap block in its
    first columns, as in the JAX package.

    `rank_deficient_exit`: certify outright a first-order critical Y whose
    singular values span more than 1e6 (the reference's early exit,
    `CORA_problem.cpp:1036-1049`). Off by default, as in the JAX package
    (`cora_tpu/solve/certify.py:205-227`): at a rank-deficient saddle left
    by a failed escape it certifies a point that is not optimal."""
    if method not in ("host", "auto", "device"):
        raise ValueError(f"certify method {method!r}")
    Y = _to_numpy(Y)
    N = pd.size
    r = Y.shape[1]

    if rank_deficient_exit:
        from cora_tpu_torch.ops.riemannian import riemannian_gradient

        Yd = torch.as_tensor(Y).to(pd.device, pd.dtype())
        grad_norm = float(torch.linalg.vector_norm(
            riemannian_gradient(pd, Yd)))
        sv = np.linalg.svd(np.asarray(Y), compute_uv=False)
        if grad_norm <= 1e-3 * max(1.0, float(sv[0])) and (
                sv[-1] == 0 or sv[0] / sv[-1] > 1e6):
            return CertResults(is_certified=True, theta=0.0, x=np.zeros(N),
                               all_eigvecs=np.zeros((N, nx)), num_iters=0)

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

    from cora_tpu_torch.precond.banded import device_factor, factor_banded
    from cora_tpu_torch.solve.verification import (
        certificate_matrix_host,
        verify_psd_host,
    )

    def certified_by_band():
        return CertResults(is_certified=True, theta=0.0, x=np.zeros(N),
                           all_eigvecs=np.zeros((N, num_eigvecs)),
                           num_iters=0)

    eta = float(eta)
    Y64 = np.asarray(Y, np.float64)
    pd_host = problem.device_data(dtype=np.float64, device="cpu")
    S_host = certificate_matrix_host(pd_host, problem.data_matrix(), Y64)

    if method == "host":
        band_exact = True
        if pd.n:
            try:
                factor_banded(problem, pd_host, S_host, eta,
                              require_exact=True)
                return certified_by_band()
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
        hv = verify_psd_host(S_host, eta, nev=num_eigvecs, v0=v0, tol=eig_tol,
                             maxiter=max_lobpcg_iters)
        if band_exact:
            # the exact banded factorization already decided NOT PD; the
            # host eigenpair only supplies the escape direction, and only
            # when it agrees that S + ηI is not PD
            if hv.is_psd:
                return CertResults(
                    is_certified=False, theta=float("-inf"), x=np.zeros(N),
                    all_eigvecs=np.zeros((N, num_eigvecs)),
                    num_iters=hv.num_eig_iters)
            certified = False
        else:
            certified = bool(hv.is_psd)
        return CertResults(is_certified=certified, theta=hv.theta, x=hv.x,
                           all_eigvecs=hv.eigvecs,
                           num_iters=hv.num_eig_iters)

    # device LOBPCG: the exact float64 banded decision runs first, and the
    # uploads (Y, Λ, the factor of S + σI) are paid only on a NOT-PD verdict
    psd_known = False
    band_inexact = not pd.n
    bfac = None
    if pd.n:
        try:
            factor_banded(problem, pd_host, S_host, eta, require_exact=True)
            return certified_by_band()
        except np.linalg.LinAlgError:
            psd_known = True  # definitively NOT PSD; LOBPCG finds the eigvec
        except ValueError:
            band_inexact = True  # the eigensolver must make the decision
        # stage-2 preconditioner: the banded factor of S + σI, σ escalated
        # ×16 until it factors (the shift only weakens the preconditioner).
        # The last σ that worked, /16, seeds the next level's search.
        sigma = max(eta, 1e-6, getattr(problem, "_cert_sigma_cache", 0.0)
                    / 16.0)
        for _ in range(12):
            try:
                F_pre = factor_banded(problem, pd_host, S_host, sigma)
            except np.linalg.LinAlgError:
                sigma *= 16.0
                continue
            bfac = device_factor(pd, F_pre)
            problem._cert_sigma_cache = sigma
            break

    if method == "auto" and band_inexact:
        # no exact banded decision: the rigorous host cascade decides
        return certify_solution(
            problem, pd, Y64, eta, nx=nx, eigvec_bootstrap=eigvec_bootstrap,
            max_lobpcg_iters=max_lobpcg_iters, tol=tol, seed=seed,
            method="host", eig_tol=eig_tol)

    dt = pd.dtype()
    Yd = torch.tensor(Y64).to(pd.device, dt)
    Lam_rot, lam_sph = compute_lambda_blocks(pd, Yd)
    X0 = np.random.default_rng(seed).standard_normal((N, num_eigvecs))
    X0 = X0.astype(np.float32 if dt == torch.float32 else np.float64)
    if eigvec_bootstrap is not None:
        boot = _to_numpy(eigvec_bootstrap)
        if boot.ndim == 1:
            boot = boot[:, None]
        ncols = min(boot.shape[1], num_eigvecs)
        X0[:, :ncols] = boot[:, :ncols]
    X0 = torch.as_tensor(X0).to(pd.device)

    # with the decision made by the exact banded Cholesky, the eigenvector
    # only seeds the saddle escape: a reduced budget serves
    eig_budget = max_lobpcg_iters
    if method == "auto" and psd_known and escape_eig_iters is not None:
        eig_budget = min(max_lobpcg_iters, escape_eig_iters)
    it1 = max(int(0.01 * eig_budget), 3)
    theta, x, X_blk, iters, resnorm = _cert_eig_device(
        pd, Lam_rot, lam_sph, X0, eta, it1, eig_budget - it1, tol, bfac=bfac)
    x = x.cpu().numpy()
    X_blk = X_blk.cpu().numpy()

    if psd_known:
        certified = False
        if theta > -eta / 2.0:
            # the exact decision says λ_min(S) < −η but the LOBPCG block
            # settled near θ ≈ 0 (the wrong end of the spectrum): a
            # zero-curvature escape would stall the staircase, so take the
            # host shift-invert Lanczos pair — if it, too, finds S + ηI
            # not PD
            hv = verify_psd_host(S_host, eta, nev=num_eigvecs,
                                 v0=x.astype(np.float64),
                                 maxiter=max_lobpcg_iters)
            if not hv.is_psd and np.isfinite(hv.theta):
                theta = float(hv.theta)
                x = hv.x.astype(x.dtype)
                X_blk = hv.eigvecs.astype(X_blk.dtype)
                iters += int(hv.num_eig_iters)
    else:
        # no exact factorization: certify only on a *converged*
        # non-negative verdict
        converged = resnorm <= tol * max(abs(theta), 1.0)
        certified = bool(theta >= -eta and converged)

    return CertResults(is_certified=certified, theta=theta, x=x,
                       all_eigvecs=X_blk, num_iters=iters)
