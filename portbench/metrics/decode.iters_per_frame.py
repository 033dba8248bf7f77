"""Iterations a frame needed: the window's iter_sum over its frames (the
program's own counters)."""


def read(ctx):
    c = ctx["counters"]
    frames = int(c[:, 0].sum())
    return float(c[:, 4].sum()) / frames if frames else None
