"""Seconds per certified estimate: the window's wall seconds over the
solves completed in it (host clock)."""

from benchmark.core.readers import completed


def read(run):
    done = completed(run)
    return run.window_s / len(done) if done else None
