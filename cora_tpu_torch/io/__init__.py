"""PyFG input (the pure-Python parser)."""

from cora_tpu_torch.io.pyfg import parse_pyfg  # noqa: F401
