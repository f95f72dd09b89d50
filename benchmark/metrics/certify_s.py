"""Mean seconds per solve in certification (`phases["certify"]`)."""

from benchmark.core.readers import mean_over_timed, phase


def read(run):
    return mean_over_timed(run, lambda s: phase(s, "certify"))
