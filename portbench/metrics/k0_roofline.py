"""K0's share of its roofline: the resident QSPA bound of each window step
at the frame-iterations it needed (its iter_sum) over K0's device seconds."""

from portbench import bounds, trace


def read(ctx):
    secs, n = trace.kernel(ctx, "qspa_resident_kernel")
    if not n or secs <= 0:
        return None
    frames = ctx["S"] * ctx["B"]
    per_step = [bounds.resident_qspa_bound(ctx["shape"], frames, int(c[4].sum()))["bound_ms"]
                for c in ctx["counters"]]
    # one K0 launch a step; scaled if the trace counts another number
    total = sum(per_step) * n / len(per_step)
    return 100.0 * total * 1e-3 / secs
