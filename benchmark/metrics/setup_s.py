"""Seconds from the process's start until the window opens: imports, the
kernel builds (a checkout's first run), writing the graph, the warm-up
solve (host clock)."""


def read(run):
    return run.setup_s
