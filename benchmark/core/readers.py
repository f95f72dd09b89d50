"""Helpers the metric readers share (`benchmark/metrics/<name>.py`)."""

from __future__ import annotations

import numpy as np


def completed(run) -> list:
    return [s for s in run.solves if not s.error]


def mean_over_timed(run, value):
    """The mean of `value(solve)` over the solves whose spans the per-layer
    metrics read; None where there is none."""
    vals = [value(s) for s in run.timed]
    return float(np.mean(vals)) if vals else None


def phase(s, *names) -> float:
    return sum(s.result.phases.get(n, 0.0) for n in names)


def tnt_roofline_pct(run, path: str):
    """100 × the least seconds of the `tnt_level` levels' iterations
    (`benchmark/work/tnt.py`) over the seconds of the `tnt_level` phase,
    summed over the timed solves of a cell on `path`."""
    from benchmark.work import tnt

    if run.cell.path != path or not run.peaks or not run.timed:
        return None
    bands = {}
    least = spent = 0.0
    for s in run.timed:
        g = run.graphs[s.entry]
        if s.entry not in bands:
            bands[s.entry] = tnt.band_entries(g, run.Q_refs[s.entry])[1:]
        for lv in s.levels:
            if lv["refine"]:
                continue
            work = tnt.level_work(g, *bands[s.entry], lv["rank"])
            least += tnt.least_seconds(work, run.peaks, lv["tcg"], lv["outer"])
        spent += phase(s, "tnt_level")
    return 100.0 * least / spent if spent > 0 else None
