"""Truncated-Newton trust-region (TNT) status codes and shared constants.

The solver itself runs as the `chunk` kernel (`cora_tpu_torch.ops.
tnt_kernels`) driven by `cora_tpu_torch.solve.tnt_kernel.tnt_solve_tiles`.
Parameter semantics follow the reference's hardcoded CORA settings
(`src/CORA.cpp:95-109`); the general-graph `tnt_solve` is not ported yet.
"""

from __future__ import annotations

import dataclasses

from cora_tpu_torch.types import TNTParams

# termination reason codes
RUNNING = 0
GRAD_TOL = 1
PRECON_GRAD_TOL = 2
REL_DECREASE = 3
STEPSIZE = 4
DELTA_TOL = 5
MAX_ITERS = 6
TIME_CAP = 7
RAMP_EXIT = 8  # ramp budget exhausted far from criticality (lift + climb)

STATUS_NAMES = {
    GRAD_TOL: "gradient_tolerance",
    PRECON_GRAD_TOL: "preconditioned_gradient_tolerance",
    REL_DECREASE: "relative_decrease",
    STEPSIZE: "stepsize",
    DELTA_TOL: "trust_region_collapse",
    MAX_ITERS: "max_iterations",
    TIME_CAP: "time_cap",
    RAMP_EXIT: "ramp_exit",
}

# upper bound on the outer iterations of one chunk; between chunks the
# host checks the per-rank wall-clock cap (reference
# `max_computation_time`, `src/CORA.cpp:106`)
CHUNK_ITERS = 128


class HashableParams:
    """Wraps TNTParams so a parameter set can key a cache."""

    def __init__(self, params: TNTParams):
        self._params = params
        self._key = tuple(dataclasses.asdict(params).items())

    def __getattr__(self, name):
        return getattr(self._params, name)

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, HashableParams) and self._key == other._key
