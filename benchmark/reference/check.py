"""The comparison that decides a run's `correct` (numpy, scipy).

For each solve the program hands over its data matrix Q, its verdict, the
rank-r point it certified with that point's cost, and the rank-d estimate
with its cost. The reference works each out again from the graph file and
the points alone and reads the gaps below: for the certified point and for
the estimate, the cost, the constraints, the stationarity and the
certificate. `verdict` holds their worst over a run to the cell's limits
(`benchmark/limits/<cell>.json`).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse.linalg as spla

from benchmark.reference import certificate, problem
from benchmark.reference.ate import ate_rmse
from benchmark.reference.pyfg import Graph

# compared numbers: the worst over a run's solves (the sum for `uncertified`)
NUMBERS = ("q_rel_err", "sdp_cost_rel_err", "cert_feas_err",
           "cert_neg_pivots", "final_cost_rel_err", "est_feas_err",
           "est_grad_rel", "uncertified")
# read and printed beside them, not compared: the control does not move
# them, or sound solves do not meet them (PERF.md)
READINGS = ("cert_grad_rel", "ate_m", "sdp_minus_final_rel",
            "est_neg_pivots", "final_uncertified")


def judge(g: Graph, Q_ref, cert_params: dict, out: dict) -> dict:
    """The numbers of one solve. `out`: `Q` (the program's, scipy sparse),
    `certified`, `sdp_cost`, `Y_cert` (float64, or None), `final_f`,
    `estimate` (the extracted solution, N × d). An output of the wrong
    shape reads inf.

    The estimate is held to what the staircase's rounding and refinement
    promise: a feasible point (`est_feas_err`) and a stationary one
    (`est_grad_rel`: the Riemannian gradient ‖S·Y‖ against ‖Q·Y‖). Its
    certificate (`est_neg_pivots`, CORA's test with η from its own cost) and
    the program's verdict on it are read, not compared: CORA certifies the
    relaxation, and a sound estimate may lie above its optimum."""
    inf = float("inf")
    Q = out["Q"]
    nums = {"uncertified": 0 if out["certified"] else 1,
            "final_uncertified": 0 if out.get("final_certified") else 1,
            "q_rel_err": float(spla.norm(Q - Q_ref) / spla.norm(Q_ref))
            if Q.shape == Q_ref.shape else inf}
    Y = out["Y_cert"]
    if out["certified"] and Y is not None:
        Y = np.asarray(Y, np.float64)
        if Y.shape[0] != g.size:
            nums.update(sdp_cost_rel_err=inf, cert_feas_err=inf,
                        cert_neg_pivots=g.size)
        else:
            f = problem.cost(g, Y)
            S = certificate.certificate_matrix(g, Q_ref, Y)
            nums.update(
                sdp_cost_rel_err=abs(out["sdp_cost"] - f) / abs(f),
                cert_feas_err=certificate.feasibility(g, Y),
                cert_grad_rel=float(np.linalg.norm(S @ Y)
                                    / np.linalg.norm(Q_ref @ Y)),
                cert_neg_pivots=certificate.nonpositive_pivots(
                    S, certificate.eta(f, cert_params)))
    est = np.asarray(out["estimate"], np.float64)
    if est.shape != (g.size, g.d):
        nums.update(final_cost_rel_err=inf, est_feas_err=inf,
                    est_grad_rel=inf, est_neg_pivots=g.size)
        return nums
    f_est = problem.cost(g, est)
    S = certificate.certificate_matrix(g, Q_ref, est)
    nums.update(
        final_cost_rel_err=abs(out["final_f"] - f_est) / abs(f_est),
        est_feas_err=certificate.feasibility(g, est),
        est_grad_rel=float(np.linalg.norm(S @ est)
                           / np.linalg.norm(Q_ref @ est)),
        est_neg_pivots=certificate.nonpositive_pivots(
            S, certificate.eta(f_est, cert_params)))
    _, tr = problem.layout(g)
    nums["ate_m"] = ate_rmse(est[tr:tr + g.n], g.gt_t)
    nums["sdp_minus_final_rel"] = (out["sdp_cost"] - f_est) / abs(f_est)
    return nums


def worst(per_solve: list) -> dict:
    """Each number's worst over the solves: the largest, or the count of
    uncertified solves; a number no solve produced is left out."""
    out = {}
    for name in NUMBERS + READINGS:
        vals = [s[name] for s in per_solve if name in s]
        if vals:
            out[name] = sum(vals) if name.endswith("uncertified") \
                else max(vals)
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every compared number within its limit, {name: {value, limit}}).
    A solve that was not certified has no certificate numbers; its
    `uncertified` fails it."""
    shown = {n: {"value": numbers[n], "limit": limits[n]}
             for n in NUMBERS if n in limits and n in numbers}
    ok = "uncertified" in shown and all(
        np.isfinite(v["value"]) and v["value"] <= v["limit"]
        for v in shown.values())
    return ok, shown
