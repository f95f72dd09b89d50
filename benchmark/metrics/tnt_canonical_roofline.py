"""The canonical ops' TNT levels against the H100's roofline, in %: the
same count as `tnt_chain_roofline` over `phases["tnt_level"]`."""

from benchmark.core.readers import tnt_roofline_pct


def read(run):
    return tnt_roofline_pct(run, "canonical")
