"""Mean seconds per solve in the float64 polish (`phases["polish_f64"]` +
`phases["polish_final"]`)."""

from benchmark.core.readers import mean_over_timed, phase


def read(run):
    return mean_over_timed(run, lambda s: phase(s, "polish_f64",
                                                "polish_final"))
