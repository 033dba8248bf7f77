"""The device's idle share of the traced window: 1 - busy / window."""


def read(ctx):
    if ctx["window_s"] <= 0 or not ctx["kernels"]:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
