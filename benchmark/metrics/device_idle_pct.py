"""The share of the traced solve in which no operation ran on the device,
in %: 100 × (1 − busy ÷ the solve's span), from `torch.profiler`."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
