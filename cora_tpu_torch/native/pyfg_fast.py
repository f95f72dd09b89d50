"""ctypes binding for the native PyFG tokenizer (`_pyfg.cpp`).

The C++ side only tokenizes; all math (rotation construction, symmetric
covariance expansion) is done here with the same helpers as the Python
parser, so both paths agree exactly (the JAX package's
`cora_tpu/native/pyfg_fast.py`). `parse_pyfg_native` raises
`NativeBuildError` when the extension cannot be built.
"""

from __future__ import annotations

import ctypes

import numpy as np

from cora_tpu_torch.native import build_extension

_LIB = None

POSE, LANDMARK, POSE_PRIOR, LANDMARK_PRIOR, REL_POSE, REL_POSE_LANDMARK, RANGE = range(7)


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_extension("_pyfg")))
        lib.pyfg_parse.restype = ctypes.c_void_p
        lib.pyfg_parse.argtypes = [ctypes.c_char_p]
        lib.pyfg_dim.argtypes = [ctypes.c_void_p]
        lib.pyfg_dim.restype = ctypes.c_int
        lib.pyfg_error.argtypes = [ctypes.c_void_p]
        lib.pyfg_error.restype = ctypes.c_char_p
        lib.pyfg_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.pyfg_count.restype = ctypes.c_longlong
        lib.pyfg_width.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.pyfg_width.restype = ctypes.c_int
        lib.pyfg_syms_per_record.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.pyfg_syms_per_record.restype = ctypes.c_int
        lib.pyfg_get_syms.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.pyfg_get_vals.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_double)
        ]
        lib.pyfg_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def _family(lib, h, fam):
    n = int(lib.pyfg_count(h, fam))
    spr = int(lib.pyfg_syms_per_record(h, fam))
    w = int(lib.pyfg_width(h, fam))
    chrs = np.zeros(n * spr, dtype=np.uint8)
    idxs = np.zeros(n * spr, dtype=np.int64)
    vals = np.zeros(n * w, dtype=np.float64)
    if n:
        lib.pyfg_get_syms(
            h, fam,
            chrs.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            idxs.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        )
        lib.pyfg_get_vals(h, fam, vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return chrs.reshape(n, spr), idxs.reshape(n, spr), vals.reshape(n, w)


def parse_pyfg_native(path, formulation=None, preconditioner=None):
    """Parse a PyFG file into a `Problem` with the native tokenizer."""
    from cora_tpu_torch.graph.problem import Problem
    from cora_tpu_torch.io.pyfg import _read_symmetric, rot2d, rot_from_quat
    from cora_tpu_torch.measurements import (
        LandmarkPrior,
        PosePrior,
        RangeMeasurement,
        RelativePoseLandmarkMeasurement,
        RelativePoseMeasurement,
    )
    from cora_tpu_torch.symbol import Symbol
    from cora_tpu_torch.types import Formulation, Preconditioner

    lib = _lib()
    h = lib.pyfg_parse(path.encode())
    try:
        err = lib.pyfg_error(h)
        if err:
            msg = err.decode()
            if "could not open" in msg:
                raise FileNotFoundError(msg)
            raise ValueError(msg)
        dim = int(lib.pyfg_dim(h))

        problem = Problem(
            dim=dim,
            relaxation_rank=dim,
            formulation=formulation or Formulation.EXPLICIT,
            preconditioner=preconditioner or Preconditioner.REGULARIZED_CHOLESKY,
        )

        def sym(c, i):
            return Symbol(chr(int(c)), int(i))

        def rot(row):
            if dim == 2:
                return rot2d(row[0])
            return rot_from_quat(*row)

        # poses (+ ground truth)
        chrs, idxs, vals = _family(lib, h, POSE)
        for k in range(len(chrs)):
            s = sym(chrs[k, 0], idxs[k, 0])
            problem.add_pose_variable(s)
            problem.set_pose_gt(s, rot(vals[k, dim:]), vals[k, :dim])

        chrs, idxs, vals = _family(lib, h, LANDMARK)
        for k in range(len(chrs)):
            s = sym(chrs[k, 0], idxs[k, 0])
            problem.add_landmark_variable(s)
            problem.set_landmark_gt(s, vals[k])

        cov_n = 3 if dim == 2 else 6
        rot_w = 1 if dim == 2 else 4

        chrs, idxs, vals = _family(lib, h, POSE_PRIOR)
        for k in range(len(chrs)):
            t = vals[k, :dim]
            R = rot(vals[k, dim:dim + rot_w])
            cov = _read_symmetric(list(vals[k, dim + rot_w:]), cov_n)
            problem.add_pose_prior(PosePrior(sym(chrs[k, 0], idxs[k, 0]), R, t, cov))

        chrs, idxs, vals = _family(lib, h, LANDMARK_PRIOR)
        for k in range(len(chrs)):
            p_ = vals[k, :dim]
            cov = _read_symmetric(list(vals[k, dim:]), dim)
            problem.add_landmark_prior(
                LandmarkPrior(sym(chrs[k, 0], idxs[k, 0]), p_, cov)
            )

        chrs, idxs, vals = _family(lib, h, REL_POSE)
        for k in range(len(chrs)):
            t = vals[k, :dim]
            R = rot(vals[k, dim:dim + rot_w])
            cov = _read_symmetric(list(vals[k, dim + rot_w:]), cov_n)
            problem.add_relative_pose_measurement(
                RelativePoseMeasurement(
                    sym(chrs[k, 0], idxs[k, 0]), sym(chrs[k, 1], idxs[k, 1]), R, t, cov
                )
            )

        chrs, idxs, vals = _family(lib, h, REL_POSE_LANDMARK)
        for k in range(len(chrs)):
            t = vals[k, :dim]
            cov = _read_symmetric(list(vals[k, dim:]), dim)
            problem.add_relative_pose_landmark_measurement(
                RelativePoseLandmarkMeasurement(
                    sym(chrs[k, 0], idxs[k, 0]), sym(chrs[k, 1], idxs[k, 1]), t, cov
                )
            )

        chrs, idxs, vals = _family(lib, h, RANGE)
        for k in range(len(chrs)):
            problem.add_range_measurement(
                RangeMeasurement(
                    sym(chrs[k, 0], idxs[k, 0]), sym(chrs[k, 1], idxs[k, 1]),
                    float(vals[k, 0]), float(vals[k, 1]),
                )
            )
        return problem
    finally:
        lib.pyfg_free(h)
