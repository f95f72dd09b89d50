"""The device check of the port's entry points."""

from __future__ import annotations

import torch


def check_device(device) -> torch.device:
    """`device` as a torch.device; for a CUDA device, raise when there is
    no card or when float32 matmuls may run in reduced precision (which
    breaks the polar/QDWH retraction of the float32 solve)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 must be "
                           "False for the float32 solve")
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("torch.get_float32_matmul_precision() must be "
                           "'highest' for the float32 solve")
    return device
