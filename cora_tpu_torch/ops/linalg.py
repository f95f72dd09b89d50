"""Small batched products of the general-graph ops.

The JAX package unrolls contractions over tiny dimensions (d ≤ 3 rotation
blocks, rank r ≤ 10) into multiply-adds so the TPU never rounds them to
bfloat16 on its matrix unit (`cora_tpu/ops/linalg.py`). On the GPU
`torch.matmul` is exact float32 or float64 as long as TF32 stays off,
which the staircase checks (`cora_tpu_torch.solve.staircase`), so these are
thin wrappers that keep the JAX package's names.
"""

from __future__ import annotations

import torch


def bmm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched matmul (..., a, k) @ (..., k, c)."""
    return A @ B


def bmm_T(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched (..., k, a)ᵀ @ (..., k, c) = Aᵀ B."""
    return A.transpose(-1, -2) @ B



def contract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full inner product ⟨a, b⟩ as an elementwise multiply and a sum."""
    return (a * b).sum()


def rowdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise inner products over the last axis."""
    return (a * b).sum(-1)
