"""Mean staircase levels per solve: `len(CoraResult.ranks_visited)`."""

from benchmark.core.readers import mean_over_timed


def read(run):
    return mean_over_timed(run, lambda s: len(s.result.ranks_visited))
