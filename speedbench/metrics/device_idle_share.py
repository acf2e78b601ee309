"""The share of the traced window in which no operation ran on the
device: 1 - (the union of the kernels' intervals) / (the window)."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0 or t["n_kernels"] == 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
