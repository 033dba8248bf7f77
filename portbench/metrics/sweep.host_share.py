"""The sweep loop's own host time as a share of the window: the program's
`sweep.loop_ns` counter (its plan, generator, account and checkpoint
spans; not the step, the counter fetch or the caller's progress) over the
window's seconds. None for a program without the counter."""


def read(ctx):
    ns = ctx["launches"].get("sweep.loop_ns")
    if not ns or ctx["window_s"] <= 0:
        return None
    return 100.0 * ns * 1e-9 / ctx["window_s"]
