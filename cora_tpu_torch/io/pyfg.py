"""PyFG text-format parser.

Line-based factor-graph format with 13 record types (reference
`src/pyfg_text_parser.cpp:48-61,122-135`):

  VERTEX_SE2 ts sym x y theta                    (2D pose; GT ignored)
  VERTEX_SE3:QUAT ts sym x y z qx qy qz qw       (3D pose; GT ignored)
  VERTEX_SE2:PRIOR ts sym x y theta cov(3x3 ut)  (2D pose prior)
  VERTEX_SE3:QUAT:PRIOR ts sym xyz quat cov(6x6 ut)
  VERTEX_XY sym x y                              (2D landmark; GT ignored)
  VERTEX_XYZ sym x y z                           (3D landmark; GT ignored)
  VERTEX_XY:PRIOR ts sym x y cov(2x2 ut)
  VERTEX_XYZ:PRIOR ts sym xyz cov(3x3 ut)
  EDGE_SE2 ts a b dx dy dtheta cov(3x3 ut)
  EDGE_SE3:QUAT ts a b dxyz quat cov(6x6 ut)
  EDGE_SE2_XY ts a b dx dy cov(2x2 ut)
  EDGE_SE3_XYZ ts a b dxyz cov(3x3 ut)
  EDGE_RANGE ts a b range cov

Covariances are upper-triangular row-major (reference
`pyfg_text_parser.cpp:385-401`); quaternions are xyzw. Ground-truth poses
and landmark positions embedded in vertex records are retained (unlike
the reference, which drops them) because the odometry initializer and ATE
evaluation need them — but they do not enter the estimation problem.

`parse_pyfg` uses the native C++ tokenizer (`cora_tpu_torch.native`) and
the pure-Python parser when no compiler builds it, as the JAX package's
`cora_tpu/io/pyfg.py:88-206` does.
"""

from __future__ import annotations

import numpy as np

from cora_tpu_torch.graph.problem import Problem
from cora_tpu_torch.measurements import (
    LandmarkPrior,
    PosePrior,
    RangeMeasurement,
    RelativePoseLandmarkMeasurement,
    RelativePoseMeasurement,
)
from cora_tpu_torch.symbol import Symbol
from cora_tpu_torch.types import Formulation, Preconditioner


def rot2d(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]])


def rot_from_quat(qx: float, qy: float, qz: float, qw: float) -> np.ndarray:
    """xyzw quaternion → 3×3 rotation (normalizing, like Eigen::Quaterniond)."""
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
            [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
            [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
        ]
    )


def _read_symmetric(vals: list[float], dim: int) -> np.ndarray:
    """Upper-triangular row-major values → full symmetric matrix."""
    M = np.zeros((dim, dim))
    k = 0
    for i in range(dim):
        for j in range(i, dim):
            M[i, j] = M[j, i] = vals[k]
            k += 1
    return M


_DIM_BY_TAG = {"VERTEX_SE2": 2, "VERTEX_XY": 2, "VERTEX_SE3:QUAT": 3, "VERTEX_XYZ": 3}


def sniff_dim(path: str) -> int:
    """Problem dimension from the first line (reference `pyfg_text_parser.cpp:41-97`)."""
    with open(path) as f:
        first = f.readline().split(None, 1)[0]
    if first not in _DIM_BY_TAG:
        raise ValueError(f"cannot determine dimension from first record {first!r}")
    return _DIM_BY_TAG[first]


def parse_pyfg(
    path: str,
    formulation: Formulation = Formulation.EXPLICIT,
    preconditioner: Preconditioner = Preconditioner.REGULARIZED_CHOLESKY,
) -> Problem:
    """Parse a PyFG file into a `Problem` (reference
    `parsePyfgTextToProblem`): natively when the tokenizer builds, else in
    Python (`parse_pyfg_python`)."""
    from cora_tpu_torch.native import NativeBuildError, pyfg_fast

    try:
        return pyfg_fast.parse_pyfg_native(path, formulation, preconditioner)
    except NativeBuildError:
        return parse_pyfg_python(path, formulation, preconditioner)


def parse_pyfg_python(
    path: str,
    formulation: Formulation = Formulation.EXPLICIT,
    preconditioner: Preconditioner = Preconditioner.REGULARIZED_CHOLESKY,
) -> Problem:
    """The pure-Python parser (the JAX package's `parse_pyfg_python`)."""
    dim = sniff_dim(path)
    problem = Problem(
        dim=dim,
        relaxation_rank=dim,
        formulation=formulation,
        preconditioner=preconditioner,
    )

    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            tag = tok[0]
            vals = tok  # strings; indices depend on tag

            if tag == "VERTEX_SE2":
                sym = Symbol(vals[2])
                problem.add_pose_variable(sym)
                x, y, th = map(float, vals[3:6])
                problem.set_pose_gt(sym, rot2d(th), np.array([x, y]))
            elif tag == "VERTEX_SE3:QUAT":
                sym = Symbol(vals[2])
                problem.add_pose_variable(sym)
                x, y, z, qx, qy, qz, qw = map(float, vals[3:10])
                problem.set_pose_gt(sym, rot_from_quat(qx, qy, qz, qw), np.array([x, y, z]))
            elif tag == "VERTEX_XY":
                sym = Symbol(vals[1])
                problem.add_landmark_variable(sym)
                problem.set_landmark_gt(sym, np.array([float(vals[2]), float(vals[3])]))
            elif tag == "VERTEX_XYZ":
                sym = Symbol(vals[1])
                problem.add_landmark_variable(sym)
                problem.set_landmark_gt(
                    sym, np.array([float(vals[2]), float(vals[3]), float(vals[4])])
                )
            elif tag == "VERTEX_SE2:PRIOR":
                sym = Symbol(vals[2])
                xy = np.array([float(vals[3]), float(vals[4])])
                R = rot2d(float(vals[5]))
                cov = _read_symmetric([float(v) for v in vals[6:12]], 3)
                problem.add_pose_prior(PosePrior(sym, R, xy, cov))
            elif tag == "VERTEX_SE3:QUAT:PRIOR":
                sym = Symbol(vals[2])
                xyz = np.array([float(v) for v in vals[3:6]])
                R = rot_from_quat(*(float(v) for v in vals[6:10]))
                cov = _read_symmetric([float(v) for v in vals[10:31]], 6)
                problem.add_pose_prior(PosePrior(sym, R, xyz, cov))
            elif tag == "VERTEX_XY:PRIOR":
                sym = Symbol(vals[2])
                xy = np.array([float(vals[3]), float(vals[4])])
                cov = _read_symmetric([float(v) for v in vals[5:8]], 2)
                problem.add_landmark_prior(LandmarkPrior(sym, xy, cov))
            elif tag == "VERTEX_XYZ:PRIOR":
                sym = Symbol(vals[2])
                xyz = np.array([float(v) for v in vals[3:6]])
                cov = _read_symmetric([float(v) for v in vals[6:12]], 3)
                problem.add_landmark_prior(LandmarkPrior(sym, xyz, cov))
            elif tag == "EDGE_SE2":
                a, b = Symbol(vals[2]), Symbol(vals[3])
                t = np.array([float(vals[4]), float(vals[5])])
                R = rot2d(float(vals[6]))
                cov = _read_symmetric([float(v) for v in vals[7:13]], 3)
                problem.add_relative_pose_measurement(
                    RelativePoseMeasurement(a, b, R, t, cov)
                )
            elif tag == "EDGE_SE3:QUAT":
                a, b = Symbol(vals[2]), Symbol(vals[3])
                t = np.array([float(v) for v in vals[4:7]])
                R = rot_from_quat(*(float(v) for v in vals[7:11]))
                cov = _read_symmetric([float(v) for v in vals[11:32]], 6)
                problem.add_relative_pose_measurement(
                    RelativePoseMeasurement(a, b, R, t, cov)
                )
            elif tag == "EDGE_SE2_XY":
                a, b = Symbol(vals[2]), Symbol(vals[3])
                t = np.array([float(vals[4]), float(vals[5])])
                cov = _read_symmetric([float(v) for v in vals[6:9]], 2)
                problem.add_relative_pose_landmark_measurement(
                    RelativePoseLandmarkMeasurement(a, b, t, cov)
                )
            elif tag == "EDGE_SE3_XYZ":
                a, b = Symbol(vals[2]), Symbol(vals[3])
                t = np.array([float(v) for v in vals[4:7]])
                cov = _read_symmetric([float(v) for v in vals[7:13]], 3)
                problem.add_relative_pose_landmark_measurement(
                    RelativePoseLandmarkMeasurement(a, b, t, cov)
                )
            elif tag == "EDGE_RANGE":
                a, b = Symbol(vals[2]), Symbol(vals[3])
                problem.add_range_measurement(
                    RangeMeasurement(a, b, float(vals[4]), float(vals[5]))
                )
            else:
                raise ValueError(f"unknown PyFG record type {tag!r}")

    return problem
