"""The control: the reference computed in float32 and put in the program's
place (numpy, scipy).

Each output is taken one precision below the one the configuration states
for it. Float64 for the data matrix, the polish and the certificate: Q
assembled in float32, the certified point and the polished estimate rounded
to float32, and their costs ½tr(YᵀQY) evaluated in float32. Float32 for the
solver's state, into which the program stores the polished estimate and
hands it over: the control stores its float32 estimate in bfloat16, as the
program stores its float64 one in float32, and reports the cost it had
before. The limits have to fail it (`benchmark/calibrate.py` reads it).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import problem


def control_outputs(g, out: dict) -> dict:
    Q32 = problem.data_matrix(g, np.float32)

    def cost32(Y):
        Y = np.asarray(Y, np.float32)
        return float(np.float32(0.5) * np.sum(Y * (Q32 @ Y), dtype=np.float32))

    ctrl = dict(out, Q=Q32.astype(np.float64))
    if out["Y_cert"] is not None:
        Y32 = np.asarray(out["Y_cert"], np.float32)
        ctrl.update(Y_cert=Y32.astype(np.float64), sdp_cost=cost32(Y32))
    est32 = np.asarray(out["estimate"], np.float32)
    ctrl.update(estimate=bfloat16(est32).astype(np.float64),
                final_f=cost32(est32))
    return ctrl


def bfloat16(x) -> np.ndarray:
    """`x` rounded to bfloat16 (to nearest, ties to even), as float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)
