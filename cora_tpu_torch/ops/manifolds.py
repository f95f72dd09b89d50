"""Batched manifold geometry for the product manifold
``Stiefel(d,r)^n × Oblique(r)^m × R^{(n+l)×r}``.

The reference implements these as per-block loops with Eigen JacobiSVD
(`src/StiefelProduct.cpp`, `src/ObliqueManifold.cpp`); the JAX package
batches them over blocks (`cora_tpu/ops/manifolds.py`), and so does this
module, on tensors of any leading batch shape:

  * Stiefel blocks live in the state as (n, d, r) row-blocks Y_i with
    Y_i Y_iᵀ = I_d (the transpose of the reference's p×kn layout).
  * The projection U Vᵀ is the polar factor (A Aᵀ)^{-1/2} A: an exact
    closed form for d = 2, with a trace-relative shift of singular blocks,
    and QDWH on A itself for d = 3.
  * Oblique (unit-sphere) rows are plain row normalisations.
"""

from __future__ import annotations

import math

import torch


def _sym(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + M.transpose(-1, -2))


def _tiny(x: torch.Tensor) -> float:
    return torch.finfo(x.dtype).tiny


def _solve_3x3_spd(Z, B, tiny):
    """Z⁻¹B for SPD 3×3 blocks via closed-form Cholesky and two unrolled
    triangular solves (stable for the badly scaled Z = I + cW of QDWH,
    where an adjugate inverse loses the determinant to cancellation)."""
    z00, z01, z02 = Z[..., 0, 0, None], Z[..., 0, 1, None], Z[..., 0, 2, None]
    z11, z12, z22 = Z[..., 1, 1, None], Z[..., 1, 2, None], Z[..., 2, 2, None]
    l11 = torch.sqrt(torch.clamp(z00, min=tiny))
    l21 = z01 / l11
    l31 = z02 / l11
    l22 = torch.sqrt(torch.clamp(z11 - l21 * l21, min=tiny))
    l32 = (z12 - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp(z22 - l31 * l31 - l32 * l32, min=tiny))
    y1 = B[..., 0, :] / l11
    y2 = (B[..., 1, :] - l21 * y1) / l22
    y3 = (B[..., 2, :] - l31 * y1 - l32 * y2) / l33
    s3 = y3 / l33
    s2 = (y2 - l32 * s3) / l22
    s1 = (y1 - l21 * s2 - l31 * s3) / l11
    return torch.stack([s1, s2, s3], -2)


def qdwh_weights(l0: float, iters: int = 8):
    """The QDWH (a, b, c) weight schedule for a σ_min/σ_max lower bound l0.
    Data-independent (the bound evolves by the same rational map as the
    singular values), so it is computed once in Python floats; shared with
    the chain plan of the kernels (`cora_tpu_torch.ops.chain`)."""
    ws = []
    l = l0
    for _ in range(iters):
        l2 = min(max(l * l, 1e-300), 1.0)
        dd = (4.0 * (1.0 - l2) / (l2 * l2)) ** (1.0 / 3.0)
        sq = math.sqrt(1.0 + dd)
        a = sq + 0.5 * math.sqrt(
            max(8.0 - 4.0 * dd + 8.0 * (2.0 - l2) / (l2 * sq), 0.0))
        b = 0.25 * (a - 1.0) ** 2
        c = a + b - 1.0
        ws.append((a, b, c))
        l = min(l * (a + b * l2) / (1.0 + c * l2), 1.0)
    return ws


def qdwh_l0(dtype: torch.dtype) -> float:
    """The σ_min/σ_max bound QDWH assumes: far enough from 0 that I + cW
    stays far from overflow in `dtype`."""
    return 1e-4 if dtype == torch.float32 else 1e-8


def _polar_qdwh(A: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Left polar factor of wide (…, 3, r) blocks by QDWH, the dynamically
    weighted Halley iteration (Nakatsukasa–Bai–Gygi 2010). It works on A
    itself, never on the squared Gram, so it keeps the small singular
    values of the anisotropic blocks that large-α escape trials produce;
    exactly singular blocks converge to the partial isometry."""
    tiny = _tiny(A)
    sigma_max = torch.sqrt(torch.clamp((A * A).sum((-2, -1), keepdim=True),
                                       min=tiny))
    X = A / sigma_max
    eye = torch.eye(A.shape[-2], dtype=A.dtype, device=A.device)
    for a, b, c in qdwh_weights(qdwh_l0(A.dtype), iters):
        W = X @ X.transpose(-1, -2)
        X = (b / c) * X + (a - b / c) * _solve_3x3_spd(eye + c * W, X, tiny)
    return X


def _inv_sqrt_psd(M: torch.Tensor) -> torch.Tensor:
    """M^{-1/2} of SPD 1×1 or 2×2 blocks in closed form. For d = 2, with
    s = √det M: M^{1/2} = (M + sI)/√(tr + 2s), so M^{-1/2} = (M + sI)⁻¹
    √(tr + 2s), exact for any SPD block. A singular block (det below 1e-6
    of tr²) is shifted by 1e-3·tr first, so its inverse root stays
    bounded; healthy blocks (M ≈ I at a retraction) are untouched."""
    d = M.shape[-1]
    tiny = _tiny(M)
    if d == 1:
        return 1.0 / torch.sqrt(torch.clamp(M, min=tiny))
    if d != 2:
        raise ValueError(f"closed-form M^(-1/2) for d <= 2, got d = {d}")
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 1, 1]
    tr0 = a + c
    det0 = a * c - b * b
    shift = torch.where(det0 < 1e-6 * torch.clamp(tr0 * tr0, min=tiny),
                        1e-3 * tr0, torch.zeros_like(tr0))
    a = a + shift
    c = c + shift
    s = torch.sqrt(torch.clamp(a * c - b * b, min=tiny))
    t = torch.sqrt(torch.clamp(a + c + 2.0 * s, min=tiny))
    f = t / torch.clamp((a + s) * (c + s) - b * b, min=tiny)
    return torch.stack([torch.stack([f * (c + s), -f * b], -1),
                        torch.stack([-f * b, f * (a + s)], -1)], -2)


# ---------------------------------------------------------------------------
# Stiefel product: blocks (n, d, r), rows orthonormal
# ---------------------------------------------------------------------------

def stiefel_project(A: torch.Tensor) -> torch.Tensor:
    """Project (…, d, r) blocks onto St(d, r): A ↦ (A Aᵀ)^{-1/2} A
    (reference SVD projection, `src/StiefelProduct.cpp:8-36`)."""
    if A.shape[-2] == 3:
        return _polar_qdwh(A)
    return _inv_sqrt_psd(A @ A.transpose(-1, -2)) @ A


def stiefel_tangent_project(Y: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Proj_{T_Y St}: V ↦ V − sym(Y Vᵀ) Y per block
    (reference `StiefelProduct.h:79-81`)."""
    return V - _sym(Y @ V.transpose(-1, -2)) @ Y


def stiefel_hess_correction(Y: torch.Tensor, nablaF: torch.Tensor,
                            dotY: torch.Tensor) -> torch.Tensor:
    """sym(Y ∇Fᵀ) · Ẏ per block — the Weingarten term of the Riemannian
    Hessian (reference `CORA_problem.cpp:839-851`)."""
    return _sym(Y @ nablaF.transpose(-1, -2)) @ dotY


def stiefel_random(generator: torch.Generator, n: int, d: int, r: int,
                   dtype=torch.float64, device=None) -> torch.Tensor:
    """n Gaussian (d, r) blocks projected onto St(d, r)
    (`StiefelProduct.cpp:57-69`), drawn from `generator` on its device
    (the JAX package draws from a jax.random key)."""
    A = torch.randn((n, d, r), generator=generator, dtype=dtype,
                    device=generator.device)
    return stiefel_project(A).to(device or generator.device)


# ---------------------------------------------------------------------------
# Oblique manifold: rows (m, r), each unit-norm
# ---------------------------------------------------------------------------

def oblique_project(A: torch.Tensor) -> torch.Tensor:
    """Row-normalise (reference `src/ObliqueManifold.cpp:6-14`)."""
    return A / torch.clamp(torch.linalg.vector_norm(A, dim=-1, keepdim=True),
                           min=_tiny(A))


def oblique_tangent_project(Y: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """V ↦ V − ⟨y_i, v_i⟩ y_i per row (reference `ObliqueManifold.cpp:16-27`)."""
    return V - (Y * V).sum(-1, keepdim=True) * Y


def oblique_random(generator: torch.Generator, m: int, r: int,
                   dtype=torch.float64, device=None) -> torch.Tensor:
    """m Gaussian rows normalised onto the unit sphere, drawn from
    `generator` on its device."""
    A = torch.randn((m, r), generator=generator, dtype=dtype,
                    device=generator.device)
    return oblique_project(A).to(device or generator.device)


# ---------------------------------------------------------------------------
# SO(d) rounding helper (reference `CORA_utils.cpp:188-202`)
# ---------------------------------------------------------------------------

def project_to_SOd(M: torch.Tensor) -> torch.Tensor:
    """Batched projection of (…, d, d) blocks onto SO(d) via SVD, the last
    column of U flipped where det(U Vᵀ) < 0."""
    U, _, Vh = torch.linalg.svd(M)
    det = torch.linalg.det(U) * torch.linalg.det(Vh)
    flip = torch.ones_like(U[..., :1, :])
    flip[..., -1] = torch.where(det < 0, -1.0, 1.0)[..., None]
    return (U * flip) @ Vh
