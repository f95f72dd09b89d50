"""cora_tpu_torch — certifiably-correct range-aided SLAM in PyTorch and CUDA.

The PyTorch port of the JAX package `cora_tpu`, which stays beside it as
the reference. The staircase's main path (explicit formulation,
RegularizedCholesky preconditioner, chain graphs, float32 state with a
float64 polish and certificate) runs on an NVIDIA Hopper card through four
hand-written CUDA kernels (`ops/tnt_kernels.py`, `ops/csrc/`); every kernel
has a plain PyTorch version that the CPU runs. Every other solve (general
graphs, other preconditioners, float64, the implicit formulation, iterate
logs) runs the canonical plain-PyTorch path on the same card.

Layout (the same module names as `cora_tpu` where the role is the same):
  symbol / measurements / types   — symbols, measurement structs, configs
  graph/                          — factor-graph container, Q assembly,
                                    edge-list tensors
  io/                             — PyFG parser, TUM/g2o export,
                                    MatrixMarket, visualization
  native/                         — the C++ PyFG tokenizer (ctypes)
  models/                         — synthetic problems, odometry start,
                                    formulations (explicit, implicit)
  precond/                        — preconditioners, host banded factor
  ops/                            — canonical ops, chain plan, kernels
  solve/                          — TNT solvers, certification, polish,
                                    rounding, checkpoint, staircase
  parallel/                       — sharded Q·Y over torch.distributed
                                    (edge-sharded, block-row), process
                                    bootstrap, global mesh
  utils/                          — evaluation, timing, device check
  experiments                     — command-line entry point
                                    (`python -m cora_tpu_torch.experiments`)

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
from cora_tpu_torch.io.pyfg import parse_pyfg  # noqa: F401
from cora_tpu_torch.solve.staircase import solve_cora  # noqa: F401

__version__ = "0.1.0"
