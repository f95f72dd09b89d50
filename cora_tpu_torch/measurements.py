"""Measurement structs for the range-aided SLAM factor graph.

Parity with the reference's `include/CORA/Measurements.h:21-206`:
  * scalar precisions derived from covariance matrices exactly as the
    reference does — rotation precision `1.5 / tr(cov_rot)` in 3D or
    `1/sigma_theta^2` in 2D (`Measurements.h:79-93`), translation
    precision `d / tr(cov_t)` (`Measurements.h:109-112`), range precision
    `1/sigma^2` (`Measurements.h:151`);
  * unordered symbol-pair equality for duplicate detection.

These are plain host-side containers (numpy); device arrays are built from
them in `cora_tpu_torch.graph.data`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cora_tpu_torch.symbol import Symbol, SymbolPair, pair_matches


@dataclasses.dataclass
class RelativePoseMeasurement:
    """SE(d) odometry / loop-closure edge (reference `Measurements.h:49-113`)."""

    first_id: Symbol
    second_id: Symbol
    R: np.ndarray  # (d, d) measured relative rotation
    t: np.ndarray  # (d,) measured relative translation
    cov: np.ndarray  # (2d(d-1)/2+d?, ...) — (3,3) in 2D, (6,6) in 3D, trans-first

    def __post_init__(self):
        self.R = np.asarray(self.R, dtype=np.float64)
        self.t = np.asarray(self.t, dtype=np.float64).reshape(-1)
        self.cov = np.asarray(self.cov, dtype=np.float64)

    @property
    def dim(self) -> int:
        return self.R.shape[0]

    def rot_precision(self) -> float:
        if self.cov.shape[0] == 6:
            # information-divergence-minimizing precision: 3 / (2 tr(cov_rot))
            return 1.5 / (self.cov[3, 3] + self.cov[4, 4] + self.cov[5, 5])
        if self.cov.shape[0] == 3:
            return 1.0 / self.cov[2, 2]
        raise ValueError("rot precision only defined for 2D/3D covariances")

    def trans_precision(self) -> float:
        d = self.t.shape[0]
        return d / np.trace(self.cov[:d, :d])

    def homogeneous_matrix(self) -> np.ndarray:
        d = self.dim
        H = np.eye(d + 1)
        H[:d, :d] = self.R
        H[:d, d] = self.t
        return H

    def symbol_pair(self) -> SymbolPair:
        return (self.first_id, self.second_id)

    def same_pair(self, other: "RelativePoseMeasurement") -> bool:
        return pair_matches(self.symbol_pair(), other.symbol_pair())


@dataclasses.dataclass
class RelativePoseLandmarkMeasurement:
    """Pose→landmark translation observation (reference `Measurements.h:115-138`)."""

    first_id: Symbol  # observing pose
    second_id: Symbol  # observed landmark
    t: np.ndarray  # (d,) measured relative translation in pose frame
    cov: np.ndarray  # (d, d)

    def __post_init__(self):
        self.t = np.asarray(self.t, dtype=np.float64).reshape(-1)
        self.cov = np.asarray(self.cov, dtype=np.float64)

    def trans_precision(self) -> float:
        d = self.t.shape[0]
        return d / np.trace(self.cov[:d, :d])

    def symbol_pair(self) -> SymbolPair:
        return (self.first_id, self.second_id)

    def same_pair(self, other) -> bool:
        return pair_matches(self.symbol_pair(), other.symbol_pair())


@dataclasses.dataclass
class RangeMeasurement:
    """Range-only edge between two translational states (`Measurements.h:140-152`)."""

    first_id: Symbol
    second_id: Symbol
    r: float
    cov: float

    def precision(self) -> float:
        return 1.0 / self.cov

    def symbol_pair(self) -> SymbolPair:
        return (self.first_id, self.second_id)

    def same_pair(self, other) -> bool:
        return pair_matches(self.symbol_pair(), other.symbol_pair())

    def has_pair(self, pair: SymbolPair) -> bool:
        return pair_matches(self.symbol_pair(), pair)


@dataclasses.dataclass
class PosePrior:
    """Absolute pose prior, realized as an edge from the origin pose
    (reference `Measurements.h:154-185`, `CORA_problem.cpp:80-100`)."""

    id: Symbol
    R: np.ndarray
    t: np.ndarray
    cov: np.ndarray

    def __post_init__(self):
        self.R = np.asarray(self.R, dtype=np.float64)
        self.t = np.asarray(self.t, dtype=np.float64).reshape(-1)
        self.cov = np.asarray(self.cov, dtype=np.float64)

    def rot_precision(self) -> float:
        if self.cov.shape[0] == 6:
            return 1.5 / (self.cov[3, 3] + self.cov[4, 4] + self.cov[5, 5])
        if self.cov.shape[0] == 3:
            return 1.0 / self.cov[2, 2]
        raise ValueError("rot precision only defined for 2D/3D covariances")

    def trans_precision(self) -> float:
        d = self.t.shape[0]
        return d / np.trace(self.cov[:d, :d])


@dataclasses.dataclass
class LandmarkPrior:
    """Absolute landmark prior (reference `Measurements.h:187-200`)."""

    id: Symbol
    p: np.ndarray
    cov: np.ndarray

    def __post_init__(self):
        self.p = np.asarray(self.p, dtype=np.float64).reshape(-1)
        self.cov = np.asarray(self.cov, dtype=np.float64)

    def precision(self) -> float:
        d = self.p.shape[0]
        return d / np.trace(self.cov[:d, :d])

    trans_precision = precision
