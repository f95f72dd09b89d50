"""Faults planted in the timed path, which the comparison has to catch.

Each fault takes `patch(obj, name, value)` (pytest's `monkeypatch.setattr`,
or `planted`'s) and breaks the port where a later change might: the
comparison with the reference has to read `correct` false. The CPU tests
plant each (`benchmark/tests/`); `benchmark/calibrate.py --fault <name>`
reads one on the card at a cell's size.
"""

from __future__ import annotations

import contextlib
import dataclasses


def unchanged_rounding(patch):
    """The rounding to rank d returns the rank-r state unchanged."""
    from cora_tpu_torch.solve import staircase

    patch(staircase, "project_solution", lambda pd, Y, verbose=False: Y)


def half_the_measurements(patch):
    """The parsed problem keeps every second range measurement."""
    from cora_tpu_torch.io import pyfg

    parse = pyfg.parse_pyfg

    def half(path, *a, **kw):
        problem = parse(path, *a, **kw)
        problem.range_measurements = problem.range_measurements[::2]
        problem.invalidate()
        return problem
    patch(pyfg, "parse_pyfg", half)


def altered_answer(patch):
    """The extracted estimate moves one translation by 0.5 m."""
    from cora_tpu_torch.solve import staircase

    extract = staircase.extract_solution

    def moved(problem, cfg, res):
        est = extract(problem, cfg, res).copy()
        est[-1] += 0.5
        return est
    patch(staircase, "extract_solution", moved)


def unrefined_estimate(patch):
    """After the rounding, the refinement and the final polish take no
    iteration: the estimate is the rounded point, its cost reported
    honestly."""
    from cora_tpu_torch.solve import polish, staircase

    rounded = [False]
    solve, project = staircase.solve_cora, staircase.project_solution
    polish_solution = polish.polish_solution

    def solve_cora(*a, **kw):
        rounded[0] = False
        return solve(*a, **kw)

    def rounding(*a, **kw):
        rounded[0] = True
        return project(*a, **kw)

    def level(fn, at):
        def run(*a, **kw):
            if rounded[0]:
                a = list(a)
                a[at] = dataclasses.replace(a[at], max_iterations=0)
            return fn(*a, **kw)
        return run

    def polished(*a, **kw):
        if rounded[0]:
            kw["max_iterations"] = 0
        return polish_solution(*a, **kw)

    patch(staircase, "solve_cora", solve_cora)
    patch(staircase, "project_solution", rounding)
    patch(staircase, "tnt_solve_tiles", level(staircase.tnt_solve_tiles, 2))
    patch(staircase, "tnt_solve", level(staircase.tnt_solve, 3))
    patch(polish, "polish_solution", polished)


FAULTS = {f.__name__: f for f in (unchanged_rounding, half_the_measurements,
                                  altered_answer, unrefined_estimate)}


@contextlib.contextmanager
def planted(name: str):
    """The fault `name` in place for the block, undone after it."""
    undo = []

    def patch(obj, attr, value):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)
    try:
        FAULTS[name](patch)
        yield
    finally:
        for obj, attr, value in reversed(undo):
            setattr(obj, attr, value)
