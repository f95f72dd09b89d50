"""Blocked LOBPCG for the minimum eigenpairs of a symmetric linear operator.

Replaces the reference's vendored `Optimization::LinearAlgebra::LOBPCG`
(call sites `src/CORA_utils.cpp:90-176`), as the JAX package's
`cora_tpu/ops/lobpcg.py` does, with the same iteration: the operator acts
on the whole 3k-column search basis at once, the Rayleigh–Ritz step is a
3k×3k `eigh`, and a tall-skinny QR keeps the basis orthonormal. A Python
loop runs the iterations on the operator's device; the only host read per
iteration is the stopping test.

The early-stop threshold is the reference's stop function: stop as soon
as the leading Ritz value drops below it (`CORA_utils.cpp:90-99`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def lobpcg_min(
    operator: Callable,
    X0: torch.Tensor,
    max_iters: int,
    tol: float = 1e-6,
    nev: int = 1,
    precon: Optional[Callable] = None,
    early_stop_below: Optional[float] = None,
):
    """The `nev` algebraically smallest eigenpairs of `operator`.

    Args:
      operator: symmetric linear map V (N, c) → (N, c).
      X0: (N, k) initial block, k ≥ nev.
      max_iters: iteration cap.
      tol: relative residual tolerance for convergence of the nev pairs.
      precon: optional SPD preconditioner V ↦ TV.
      early_stop_below: stop once the leading Ritz value is below this.

    Returns (theta (k,), X (N, k), iterations, converged pairs). As in the
    JAX package, the convergence count is taken on the block before each
    update, so the loop ends one update after the test first passes.
    """
    k = X0.shape[1]

    def rayleigh_ritz(Z):
        SZ = operator(Z)
        A = Z.T @ SZ
        theta, C = torch.linalg.eigh(0.5 * (A + A.T))
        return theta, C, SZ

    X = torch.linalg.qr(X0).Q
    theta, C, SX = rayleigh_ritz(X)
    X, SX = X @ C, SX @ C
    P = torch.zeros_like(X)
    theta = theta[:k]
    it, n_conv, done = 0, 0, False
    while it < max_iters and not done:
        R = SX - X * theta[None, :]
        resnorm = torch.linalg.vector_norm(R, dim=0)
        scale = torch.clamp(theta.abs(), min=1.0)
        conv = (resnorm[:nev] <= tol * scale[:nev]).sum()
        W = precon(R) if precon is not None else R
        Q = torch.linalg.qr(torch.cat([X, W, P], dim=1)).Q
        theta_all, C, SQ = rayleigh_ritz(Q)
        Cx = C[:, :k]
        X, SX = Q @ Cx, SQ @ Cx
        Cp = Cx.clone()
        Cp[:k] = 0.0  # search-direction memory: the (W, P) part
        P = Q @ Cp
        theta = theta_all[:k]
        stop = conv >= nev
        if early_stop_below is not None:
            stop = stop | (theta[0] < early_stop_below)
        n_conv, done = int(conv), bool(stop)
        it += 1
    return theta, X, it, n_conv
