"""Saddle escape along a negative-curvature direction, on the canonical ops.

Parity with `saddleEscape` (reference `src/CORA.cpp:245-350`) and with the
JAX package's XLA path (`cora_tpu/solve/saddle.py`): after the rank goes
r → r+1, the uncertified solution Y is lifted by a zero column and a step
is taken along Ẏ = e_{r+1} vᵀ, v the negative-curvature eigenvector of
the certificate. The ±α ladder (both signs, since an eigenvector's sign is
arbitrary; α from max(100·tol/|θ|, 1) halving 24 times) is evaluated
in one batched pass, as the JAX package evaluates it in one program, with
one host read; the largest step that decreases the objective with
both gradient norms above the stopping tolerances wins; else the best
strict decrease; else the lifted saddle itself.

The preconditioned norm here is ‖Proj(P g)‖, the XLA path's; the chain
kernels' ladder uses √⟨g, P g⟩ as the JAX kernel does, so each path keeps
its own twin's measure.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cora_tpu_torch.ops.quadratic import data_matrix_product
from cora_tpu_torch.ops.riemannian import retract, tangent_space_projection

N_ALPHAS = 24  # α ladder: alpha0 / 2^k, k = 0..N_ALPHAS-1


def _trial_ladder(pd, Y_aug, Ydot, signed, precon, op):
    """(f, ‖grad‖, ‖Proj(P grad)‖) at retract(Y_aug, α·Ẏ) for every signed
    α in one batched pass (`cora_tpu/solve/saddle.py:41-71`): the trial
    states go through Q and the preconditioner side by side as columns,
    both acting on each column alone. Returns (3, A) on the device."""
    N, r = Y_aug.shape
    A = signed.shape[0]
    Yb = retract(pd, Y_aug, signed[:, None, None] * Ydot)  # (A, N, r)

    def columns(fn, V):
        out = fn(V.permute(1, 0, 2).reshape(N, A * r))
        return out.reshape(-1, A, r).permute(1, 0, 2)

    QYb = columns(op, Yb)
    grad = tangent_space_projection(pd, Yb, QYb)
    pgrad = tangent_space_projection(pd, Yb, columns(precon, grad))
    return torch.stack([0.5 * (Yb * QYb).sum((1, 2)),
                        torch.linalg.vector_norm(grad, dim=(1, 2)),
                        torch.linalg.vector_norm(pgrad, dim=(1, 2))])


def saddle_escape(pd, Y: torch.Tensor, theta: float, v, precon,
                  gradient_tolerance: float = 1e-4,
                  preconditioned_gradient_tolerance: float = 1e-4,
                  alpha_min: float = 1e-6,
                  verbose: bool = False, op=None) -> torch.Tensor:
    """Escape the rank-r saddle Y into rank r+1; returns the (N, r+1)
    state. `op` is the quadratic-form operator (explicit Q when None). The
    largest step is α₀ = max(16·`alpha_min`, 100·tol/|θ|, 1), as in the
    JAX package. The saddle's f and the 48 trials' scalars come back in
    one host read."""
    if op is None:
        op = functools.partial(data_matrix_product, pd)
    N, _ = Y.shape
    Y_aug = torch.cat([Y, Y.new_zeros((N, 1))], dim=1)
    Ydot = torch.zeros_like(Y_aug)
    Ydot[:, -1] = torch.as_tensor(np.asarray(v).reshape(N)).to(Ydot)

    alpha0 = max(16 * alpha_min, 100 * gradient_tolerance / abs(theta), 1.0)
    alphas = torch.tensor(alpha0 * 0.5 ** np.arange(N_ALPHAS),
                          dtype=Y.dtype)
    signed = torch.stack([alphas, -alphas], dim=1).reshape(-1)
    trials = _trial_ladder(pd, Y_aug, Ydot, signed.to(Y.device), precon, op)
    f_saddle = 0.5 * (Y_aug * op(Y_aug)).sum()
    host = torch.cat([f_saddle.view(1), trials.reshape(-1)]).cpu().numpy()
    f_saddle, (f, gn, pgn) = host[0], host[1:].reshape(3, -1)

    ok = ((f < f_saddle) & (gn > gradient_tolerance)
          & (pgn > preconditioned_gradient_tolerance))
    if ok.any():
        best = int(np.argmax(ok))  # the largest acceptable step
    elif f.min() < f_saddle:
        best = int(np.argmin(f))  # the best strict decrease
    else:
        if verbose:
            print("WARNING: saddle-escape line search failed to escape the "
                  "saddle point")
        return Y_aug
    return retract(pd, Y_aug, float(signed[best]) * Ydot)
