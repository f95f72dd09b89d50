"""Mean saddle escapes per solve: `CoraResult.counters["escape.escapes"]`.
Nothing where the program keeps no such count."""

from benchmark.core.readers import mean_over_timed

KEY = "escape.escapes"


def counters(s) -> dict:
    return getattr(s.result, "counters", None) or {}


def read(run):
    if not any(KEY in counters(s) for s in run.timed):
        return None
    return mean_over_timed(run, lambda s: counters(s).get(KEY, 0))
