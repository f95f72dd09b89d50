"""Factor-graph container: variables, measurements, index assignment.

Parity with the construction half of the reference `Problem` class
(`include/CORA/CORA_problem.h:67-321`, `src/CORA_problem.cpp:24-113,
964-1021`):

  * variable adders with duplicate rejection;
  * priors auto-create an origin pose `O0` on first use
    (`CORA_problem.cpp:80-100`);
  * the canonical variable ordering
    ``[rotations (d·n rows) | range unit vectors (m rows) |
       pose translations (n rows) | landmark translations (l rows)]``
    with `rotation_idx` / `range_idx` / `translation_idx` lookups
    (`CORA_problem.cpp:964-1021`).

This class is pure host-side bookkeeping. Heavy math lives in:
  * `cora_tpu_torch.graph.assembly` — scipy submatrix/Q assembly (golden path,
    used by tests and the host-factored preconditioners);
  * `cora_tpu_torch.graph.data`     — flat torch tensors for the operators.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from cora_tpu_torch.measurements import (
    LandmarkPrior,
    PosePrior,
    RangeMeasurement,
    RelativePoseLandmarkMeasurement,
    RelativePoseMeasurement,
)
from cora_tpu_torch.symbol import Symbol, SymbolPair, pair_matches
from cora_tpu_torch.types import Formulation, Preconditioner

ORIGIN_SYMBOL = Symbol("O", 0)


@dataclasses.dataclass
class Problem:
    dim: int
    relaxation_rank: int
    formulation: Formulation = Formulation.EXPLICIT
    preconditioner: Preconditioner = Preconditioner.REGULARIZED_CHOLESKY

    def __post_init__(self):
        if self.dim not in (2, 3):
            raise ValueError("only 2D and 3D problems are supported")
        self.pose_symbol_idxs: dict[Symbol, int] = {}
        self.landmark_symbol_idxs: dict[Symbol, int] = {}
        self.rel_pose_measurements: list[RelativePoseMeasurement] = []
        self.rel_pose_landmark_measurements: list[RelativePoseLandmarkMeasurement] = []
        self.range_measurements: list[RangeMeasurement] = []
        self.pose_priors: list[PosePrior] = []
        self.landmark_priors: list[LandmarkPrior] = []
        self.has_priors = False
        # ground truth (from PyFG vertex records) for odom init / ATE; not
        # part of the estimation problem
        self.pose_gt: dict[Symbol, tuple[np.ndarray, np.ndarray]] = {}
        self.landmark_gt: dict[Symbol, np.ndarray] = {}
        self._range_pair_set: set[tuple] = set()
        self._rpm_pair_set: set[tuple] = set()

    # ------------------------------------------------------------------
    # variable / measurement adders (duplicate-rejecting)
    # ------------------------------------------------------------------
    def add_pose_variable(self, sym: Symbol) -> None:
        sym = Symbol(sym)
        if sym in self.pose_symbol_idxs:
            raise ValueError(f"pose variable {sym} already exists")
        self.pose_symbol_idxs[sym] = len(self.pose_symbol_idxs)
        self.invalidate()

    def add_landmark_variable(self, sym: Symbol) -> None:
        sym = Symbol(sym)
        if sym in self.landmark_symbol_idxs:
            raise ValueError(f"landmark variable {sym} already exists")
        self.landmark_symbol_idxs[sym] = len(self.landmark_symbol_idxs)
        self.invalidate()

    @staticmethod
    def _unordered(pair: SymbolPair) -> tuple:
        a, b = pair
        return (min(a, b), max(a, b))

    def add_range_measurement(self, m: RangeMeasurement) -> None:
        k = self._unordered(m.symbol_pair())
        if k in self._range_pair_set:
            raise ValueError(f"range measurement {m.first_id}->{m.second_id} already exists")
        self._range_pair_set.add(k)
        self.range_measurements.append(m)
        self.invalidate()

    def add_relative_pose_measurement(self, m: RelativePoseMeasurement) -> None:
        k = self._unordered(m.symbol_pair())
        if k in self._rpm_pair_set:
            raise ValueError(
                f"relative pose measurement {m.first_id}->{m.second_id} already exists"
            )
        self._rpm_pair_set.add(k)
        self.rel_pose_measurements.append(m)
        self.invalidate()

    def add_relative_pose_landmark_measurement(
        self, m: RelativePoseLandmarkMeasurement
    ) -> None:
        for existing in self.rel_pose_landmark_measurements:
            if existing.same_pair(m):
                raise ValueError("relative pose-landmark measurement already exists")
        self.rel_pose_landmark_measurements.append(m)
        self.invalidate()

    def _ensure_origin(self) -> None:
        if not self.has_priors:
            self.has_priors = True
            self.add_pose_variable(ORIGIN_SYMBOL)

    def add_pose_prior(self, p: PosePrior) -> None:
        for existing in self.pose_priors:
            if existing.id == p.id:
                raise ValueError("pose prior already exists")
        self._ensure_origin()
        self.pose_priors.append(p)
        self.invalidate()

    def add_landmark_prior(self, p: LandmarkPrior) -> None:
        for existing in self.landmark_priors:
            if existing.id == p.id:
                raise ValueError("landmark prior already exists")
        self._ensure_origin()
        self.landmark_priors.append(p)
        self.invalidate()

    def set_pose_gt(self, sym: Symbol, R: np.ndarray, t: np.ndarray) -> None:
        self.pose_gt[Symbol(sym)] = (np.asarray(R, float), np.asarray(t, float))

    def set_landmark_gt(self, sym: Symbol, p: np.ndarray) -> None:
        self.landmark_gt[Symbol(sym)] = np.asarray(p, float)

    # ------------------------------------------------------------------
    # sizes
    # ------------------------------------------------------------------
    @property
    def num_poses(self) -> int:
        return len(self.pose_symbol_idxs)

    @property
    def num_landmarks(self) -> int:
        return len(self.landmark_symbol_idxs)

    @property
    def num_range_measurements(self) -> int:
        return len(self.range_measurements)

    @property
    def num_pose_pose_measurements(self) -> int:
        return len(self.rel_pose_measurements)

    @property
    def num_pose_landmark_measurements(self) -> int:
        return len(self.rel_pose_landmark_measurements)

    @property
    def num_poses_dim(self) -> int:
        return self.num_poses * self.dim

    @property
    def num_translational_states(self) -> int:
        return self.num_poses + self.num_landmarks

    @property
    def rot_and_range_matrix_size(self) -> int:
        return self.num_poses_dim + self.num_range_measurements

    @property
    def data_matrix_size(self) -> int:
        """N = n(d+1) + l + m (reference `CORA_problem.cpp:940-942`)."""
        return (
            self.num_poses * (self.dim + 1)
            + self.num_landmarks
            + self.num_range_measurements
        )

    @property
    def expected_variable_size(self) -> int:
        if self.formulation == Formulation.EXPLICIT:
            return self.data_matrix_size
        return self.rot_and_range_matrix_size

    # ------------------------------------------------------------------
    # index lookups (reference `CORA_problem.cpp:964-1021`)
    # ------------------------------------------------------------------
    def rotation_idx(self, sym: Symbol) -> int:
        """Block index of the pose's rotation (rows [i*d, (i+1)*d))."""
        sym = Symbol(sym)
        if sym not in self.pose_symbol_idxs:
            raise KeyError(f"unknown pose symbol {sym}")
        return self.pose_symbol_idxs[sym]

    def range_idx(self, pair: SymbolPair) -> int:
        """Row of the range's unit-bearing variable in the stacked state."""
        offset = self.num_poses_dim
        for i, m in enumerate(self.range_measurements):
            if m.has_pair(pair):
                return i + offset
        raise KeyError(f"unknown range symbol pair {pair}")

    def translation_idx(self, sym: Symbol) -> int:
        """Row of the pose/landmark translation in the stacked state."""
        sym = Symbol(sym)
        offset = self.rot_and_range_matrix_size
        if sym in self.pose_symbol_idxs:
            return self.pose_symbol_idxs[sym] + offset
        if sym in self.landmark_symbol_idxs:
            return self.landmark_symbol_idxs[sym] + offset + self.num_poses
        raise KeyError(f"unknown translation symbol {sym}")

    def pose_symbols(self, chr: Optional[str] = None) -> list[Symbol]:
        """Pose symbols, sorted; optionally filtered by leading character."""
        syms = sorted(self.pose_symbol_idxs.keys())
        if chr is not None:
            syms = [s for s in syms if s.chr == chr]
        return syms

    def robot_chars(self) -> list[str]:
        return sorted({s.chr for s in self.pose_symbol_idxs})

    # ------------------------------------------------------------------
    # derived products (lazily cached)
    # ------------------------------------------------------------------
    def submatrices(self):
        from cora_tpu_torch.graph import assembly

        if getattr(self, "_submatrices", None) is None:
            self._submatrices = assembly.build_submatrices(self)
        return self._submatrices

    def data_matrix(self):
        from cora_tpu_torch.graph import assembly

        if getattr(self, "_data_matrix", None) is None:
            self._data_matrix = assembly.build_data_matrix(self.submatrices())
        return self._data_matrix

    def device_data(self, dtype=np.float64, device="cuda"):
        """Factored problem data as torch tensors of `dtype` on `device` (the
        card unless the caller asks for another; raises without one),
        cached per (dtype, device)."""
        from cora_tpu_torch.graph import data
        from cora_tpu_torch.utils.device import check_device

        device = check_device(device)
        key = (np.dtype(dtype).name, str(device))
        cache = getattr(self, "_device_data", None)
        if cache is None:
            cache = self._device_data = {}
        if key not in cache:
            cache[key] = data.build_problem_data(self, dtype=dtype,
                                                 device=device)
        return cache[key]

    def operator(self, formulation=Formulation.EXPLICIT, dtype=np.float64,
                 device="cuda"):
        """The quadratic-form operator of `formulation` on `device` in
        `dtype`, cached per key: Y ↦ QY (explicit) or the marginalized
        Y ↦ Q̃Y (implicit), with `.implicit` its `ImplicitOperators` (None
        for the explicit one)."""
        from cora_tpu_torch.models import formulations
        from cora_tpu_torch.utils.device import check_device

        device = check_device(device)
        key = (formulation, np.dtype(dtype).name, str(device))
        cache = getattr(self, "_op_cache", None)
        if cache is None:
            cache = self._op_cache = {}
        if key not in cache:
            cache[key] = formulations.make_operator(
                self, self.device_data(dtype, device), formulation,
                dtype=dtype)
        return cache[key]

    def sharded_operator(self, mesh, dtype=np.float64, blockrow=True,
                         device=None):
        """The sharded explicit Q·Y over the ranks of `mesh` (a 1-D
        `DeviceMesh`, `cora_tpu_torch.parallel`), cached per key; `device`
        defaults to this rank's device on the mesh.

        State stays replicated. The default is the block-row operator
        (`make_blockrow_operator`: each rank forms its block's rows, one
        all_gather per application); `blockrow=False` selects the
        edge-sharded one (a full-height partial product, one all_reduce).
        `.implicit` is None: the implicit formulation passes this operator
        to `make_operator(..., full_product=)`.

        The key holds the mesh's process group by identity: a mesh made
        after the group was destroyed may compare equal to the old one, but
        its group is a new object. The cached operator keeps its group
        alive, so that identity is not reused while the entry exists."""
        from cora_tpu_torch.parallel import sharding as shd
        from cora_tpu_torch.utils.device import check_device

        device = check_device(shd.mesh_device(mesh) if device is None
                              else device)
        key = (id(mesh.get_group()), mesh.size(), np.dtype(dtype).name,
               bool(blockrow), str(device))
        cache = getattr(self, "_sharded_op_cache", None)
        if cache is None:
            cache = self._sharded_op_cache = {}
        if key not in cache:
            pd = self.device_data(dtype, device)
            if blockrow:
                op = shd.make_blockrow_operator(pd, mesh)
            else:
                op = shd.make_sharded_operator(
                    shd.shard_problem_data(pd, mesh), mesh)
            op.implicit = None
            cache[key] = op
        return cache[key]

    def preconditioner_fn(self, kind, dtype=np.float64, max_cond: float = 1e6,
                          device="cuda"):
        """The `PrecondOp` of `kind` on `device` in `dtype`, cached: the
        banded kinds factor on the host once per key."""
        from cora_tpu_torch import precond
        from cora_tpu_torch.utils.device import check_device

        device = check_device(device)
        key = (kind, np.dtype(dtype).name, float(max_cond), str(device))
        cache = getattr(self, "_precon_cache", None)
        if cache is None:
            cache = self._precon_cache = {}
        if key not in cache:
            cache[key] = precond.make_preconditioner(
                self, self.device_data(dtype, device), kind,
                reg_chol_max_cond=max_cond)
        return cache[key]

    def invalidate(self) -> None:
        """Drop cached derived products after mutating the graph."""
        self._submatrices = None
        self._data_matrix = None
        self._device_data = None
        self._op_cache = None
        self._sharded_op_cache = None
        self._precon_cache = None
        self._polish_cache = None
        self._band_perm_cache = None
        self._chain_plan_cache = None
        self._kernel_cache = None
        self._cert_sigma_cache = 0.0
