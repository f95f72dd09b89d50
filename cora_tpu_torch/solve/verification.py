"""Host float64 PSD verification: exact sparse decision + shift-invert
eigenpair — the CHOLMOD + ILDL-preconditioned-LOBPCG analog.

Role split (mirrors the reference's CPU design,
`src/CORA_utils.cpp:17-186`): the staircase and every hot-loop linear-
algebra op run on the device in float32, but certification is a one-shot
*decision* per rank level whose tolerances (η ~ 1e-3, θ ~ 1e-5) sit at
or below float32 resolution. The reference runs this decision through
CHOLMOD (`quick_return_if_not_posdef`, `CORA_utils.cpp:28-56`) and an
ILDL-preconditioned LOBPCG (`CORA_utils.cpp:128-176`) — both host-side
double-precision sparse codes. This module does the same with
SuperLU:

  Stage 1 (decision): symmetric-mode sparse LU of M = S + ηI with no
    off-diagonal pivoting (`diag_pivot_thresh=0`). For a symmetric
    matrix this is an LDLᵀ-like factorization; all-positive U diagonal
    ⟺ M positive definite ⟺ the solution is certified.
  Stage 2 (eigenpair): when M is not PD the staircase needs the minimum
    eigenpair of S for the saddle escape. Find a shift c (doubling from
    η) such that S + cI is PD, then run shift-invert Lanczos with
    σ = −c: since σ lies strictly below the spectrum, the eigenvalues
    nearest σ are exactly the algebraically-smallest ones, and the
    factorization from the PD search is reused as OPinv. Converges in a
    handful of iterations where an unpreconditioned/Jacobi LOBPCG
    stalls for hundreds.

Everything here operates on the host scipy.sparse certificate matrix in
float64; the Λ blocks are recomputed from Y in float64 so the verdict is
not polluted by the float32 staircase state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


@dataclasses.dataclass
class HostVerification:
    """Outcome of the host verification cascade."""

    is_psd: bool  # S + ηI positive definite (certified)
    theta: float  # min eigenvalue of S (0.0 when decided PSD by stage 1)
    x: np.ndarray  # min eigenvector ((N,); zeros when decided by stage 1)
    eigvecs: np.ndarray  # (N, k) eigenvector block for the next bootstrap
    num_factor: int  # sparse factorizations performed
    num_eig_iters: int  # Lanczos mat-vec count (0 on the PSD fast path)
    converged: bool  # eigenpair converged (always True on the PSD path)


def lambda_blocks_host(pd, Q: sp.spmatrix, Y: np.ndarray):
    """Lagrange-multiplier blocks in float64 on host (reference
    `compute_Lambda_blocks`, `src/CORA_problem.cpp:1105-1131`)."""
    Y = np.asarray(Y, np.float64)
    G = Q @ Y  # (N, r) sparse·dense in float64
    d, n, m = pd.d, pd.n, pd.m
    rot = slice(0, n * d)
    sph = slice(n * d, n * d + m)
    Grot = G[rot].reshape(n, d, -1)
    Yrot = Y[rot].reshape(n, d, -1)
    P = np.einsum("nir,njr->nij", Grot, Yrot)
    Lam_rot = 0.5 * (P + np.swapaxes(P, 1, 2))
    lam_sph = np.einsum("mr,mr->m", Y[sph], G[sph])
    return Lam_rot, lam_sph


def certificate_matrix_host(pd, Q: sp.spmatrix, Y: np.ndarray) -> sp.csc_matrix:
    """S = Q − Λ assembled on host in float64."""
    Lam_rot, lam_sph = lambda_blocks_host(pd, Q, Y)
    d, n, m = pd.d, pd.n, pd.m
    N = pd.size
    blk = np.arange(n)[:, None, None] * d
    rows_rot = (blk + np.arange(d)[None, :, None] + np.zeros((1, 1, d), np.int64)).reshape(-1)
    cols_rot = (blk + np.zeros((1, d, 1), np.int64) + np.arange(d)[None, None, :]).reshape(-1)
    off = n * d
    rows = np.concatenate([rows_rot, off + np.arange(m)])
    cols = np.concatenate([cols_rot, off + np.arange(m)])
    vals = np.concatenate([Lam_rot.reshape(-1), lam_sph])
    Lam = sp.csr_matrix((vals, (rows, cols)), shape=(N, N))
    return (Q - Lam).tocsc()


def _symmetric_splu(M: sp.csc_matrix):
    """Sparse LU in symmetric mode with diagonal pivoting only — an LDLᵀ
    surrogate whose U diagonal decides definiteness."""
    return spla.splu(
        M.tocsc(),
        permc_spec="MMD_AT_PLUS_A",
        diag_pivot_thresh=0.0,
        options=dict(SymmetricMode=True),
    )


def try_psd_factor(M: sp.csc_matrix):
    """Attempt the PSD decision. Returns (is_pd, lu_or_None).

    The inertia argument (all-positive U diagonal ⟺ PD) is only valid if
    SuperLU performed *no off-diagonal pivoting* — with
    `diag_pivot_thresh=0` it still row-pivots when a diagonal pivot is
    exactly/near zero. Detect that by checking the row permutation equals
    the column permutation; if they differ the factorization is a genuine
    LU and its U diagonal says nothing about definiteness, so the verdict
    falls through to the Lanczos stage (never falsely certify)."""
    try:
        lu = _symmetric_splu(M)
    except RuntimeError:  # "Factor is exactly singular"
        return False, None
    if not np.array_equal(lu.perm_r, lu.perm_c):
        return False, None  # off-diagonal pivots: inertia unknown, not "PD"
    if np.all(lu.U.diagonal() > 0.0):
        return True, lu
    return False, None


def verify_psd_host(
    S: sp.spmatrix,
    eta: float,
    nev: int = 10,
    v0: np.ndarray | None = None,
    tol: float = 1e-8,
    max_shift_doublings: int = 60,
    maxiter: int = 300,
) -> HostVerification:
    """Full cascade: PSD decision on S + ηI, else min eigenpairs of S.

    Mirrors `fast_verification` (`src/CORA_utils.cpp:17-186`) with the
    direct factorization as stage 1 and shift-invert Lanczos replacing
    the ILDL-preconditioned LOBPCG as stage 2.
    """
    N = S.shape[0]
    S = S.tocsc()
    eye = sp.identity(N, format="csc")

    n_factor = 1
    is_pd, _ = try_psd_factor(S + eta * eye)
    if is_pd:
        return HostVerification(
            is_psd=True, theta=0.0, x=np.zeros(N),
            eigvecs=np.zeros((N, nev)), num_factor=n_factor,
            num_eig_iters=0, converged=True,
        )

    # stage 2: find shift c with S + cI PD (θ_min > −c), reuse as OPinv.
    # Exponential search with factor 10: each probe costs a sparse
    # factorization, and shift-invert Lanczos only needs σ = −c *below*
    # the spectrum, not near it — overshooting is cheap, probing is not.
    c = max(2.0 * eta, 1e-8)
    lu = None
    for _ in range(max_shift_doublings):
        c *= 10.0
        n_factor += 1
        ok, lu = try_psd_factor(S + c * eye)
        if ok:
            break
    if lu is None:
        raise np.linalg.LinAlgError(
            "could not find a positive-definite shift of the certificate"
        )

    k = int(min(max(nev, 1), N - 1))
    n_ops = [0]

    def _opinv(x):
        n_ops[0] += 1
        return lu.solve(x)

    opinv = spla.LinearOperator((N, N), matvec=_opinv, dtype=np.float64)
    if v0 is not None:
        v0 = np.asarray(v0, np.float64).reshape(N)
        nrm = np.linalg.norm(v0)
        v0 = v0 / nrm if nrm > 0 else None
    if v0 is None:
        # deterministic start: the returned eigvecs bootstrap the
        # saddle escape, so an ARPACK random start would make the whole
        # staircase trajectory vary run to run
        v0 = np.random.default_rng(0).standard_normal(N)
        v0 /= np.linalg.norm(v0)
    try:
        w, V = spla.eigsh(
            S.astype(np.float64), k=k, sigma=-c, which="LM",
            OPinv=opinv, v0=v0, tol=tol, maxiter=maxiter,
        )
        converged = True
    except spla.ArpackNoConvergence as e:
        # a partial eigenpair set need not contain the true minimum
        # eigenvalue, so θ may overestimate — never certify from this
        # branch (converged=False ⇒ is_psd=False); the partial eigvecs
        # still seed the saddle-escape bootstrap (reference
        # `fast_verification` also only certifies from the Cholesky stage)
        w, V = e.eigenvalues, e.eigenvectors
        converged = False
        if w.size == 0:
            w, V = np.array([np.nan]), np.zeros((N, 1))
    order = np.argsort(w)
    w, V = w[order], V[:, order]
    theta = float(w[0])
    return HostVerification(
        is_psd=bool(converged and theta >= -eta),
        theta=theta,
        x=V[:, 0],
        eigvecs=V,
        num_factor=n_factor,
        num_eig_iters=n_ops[0],  # shift-invert OPx applications
        converged=converged,
    )
