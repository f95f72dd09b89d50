"""Mean seconds to the SDP certificate (`CoraResult.elapsed_to_certificate`)
over the window's certified solves (host clock)."""

import numpy as np

from benchmark.core.readers import completed


def read(run):
    t = [s.result.elapsed_to_certificate for s in completed(run)
         if s.result.certified]
    return float(np.mean(t)) if t else None
