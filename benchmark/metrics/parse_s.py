"""Mean seconds of `parse_pyfg` per solve, by the benchmark's clock."""

from benchmark.core.readers import mean_over_timed


def read(run):
    return mean_over_timed(run, lambda s: s.parse_s)
