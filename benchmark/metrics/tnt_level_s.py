"""Mean seconds per solve in the TNT levels before the certificate
(`CoraResult.phases["tnt_level"]`)."""

from benchmark.core.readers import mean_over_timed, phase


def read(run):
    return mean_over_timed(run, lambda s: phase(s, "tnt_level"))
