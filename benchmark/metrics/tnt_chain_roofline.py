"""The chain kernels' TNT levels against the H100's roofline, in %: the
least time of their tCG and outer iterations over `phases["tnt_level"]`."""

from benchmark.core.readers import tnt_roofline_pct


def read(run):
    return tnt_roofline_pct(run, "chain")
