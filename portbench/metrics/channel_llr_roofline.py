"""channel_llr's share of its roofline: the step's channel bound (all-zero
codewords, S x B frames) times its launches, over its device seconds."""

from portbench import bounds, trace


def read(ctx):
    secs, n = trace.kernel(ctx, "channel_llr_kernel")
    if not n or secs <= 0:
        return None
    b = bounds.channel_bound(ctx["shape"], ctx["S"], ctx["B"])["bound_ms"] * 1e-3
    return 100.0 * b * n / secs
