"""cora_tpu_torch — certifiably-correct range-aided SLAM in PyTorch and CUDA.

The PyTorch port of the JAX package `cora_tpu`, which stays beside it as
the reference. The staircase's main path (explicit formulation,
RegularizedCholesky preconditioner, chain graphs, float32 state with a
float64 polish and certificate) runs on an NVIDIA Hopper card through four
hand-written CUDA kernels (`ops/tnt_kernels.py`, `ops/csrc/`); every kernel
has a plain PyTorch version that the CPU runs.

Layout (the same module names as `cora_tpu` where the role is the same):
  symbol / measurements / types   — symbols, measurement structs, configs
  graph/                          — factor-graph container, Q assembly,
                                    edge-list tensors
  models/                         — synthetic problems
  precond/                        — host banded factor of Q + λI
  ops/                            — chain plan, plain chain ops, kernels
  solve/                          — TNT driver, certification, polish,
                                    rounding, staircase
  utils/                          — evaluation, timing

Depends on torch, numpy and scipy only; the JAX package is not a dependency.
"""

from cora_tpu_torch.symbol import Symbol, SymbolPair, key  # noqa: F401
from cora_tpu_torch.measurements import (  # noqa: F401
    LandmarkPrior,
    PosePrior,
    RangeMeasurement,
    RelativePoseLandmarkMeasurement,
    RelativePoseMeasurement,
)
from cora_tpu_torch.types import (  # noqa: F401
    CertResults,
    Formulation,
    Initialization,
    Preconditioner,
    SolverConfig,
    TNTParams,
)
from cora_tpu_torch.graph.problem import Problem  # noqa: F401
from cora_tpu_torch.solve.staircase import solve_cora  # noqa: F401

__version__ = "0.1.0"
