"""PyFG input (native tokenizer or pure Python), solution export, MatrixMarket
and visualization."""

from cora_tpu_torch.io.pyfg import parse_pyfg  # noqa: F401
