"""K5's share of its roofline: the T-EMS check-node bound at [M, dc, q,
S B] and the decoder's n_r times its launches, over its device seconds."""

from portbench import bounds, trace


def read(ctx):
    secs, n = trace.kernel(ctx, "cn_tems_kernel")
    if not n or secs <= 0:
        return None
    b = bounds.tems_cn_bound(ctx["shape"], ctx["S"] * ctx["B"],
                             ctx["decoder"].get("tems_nr", 0))["bound_ms"] * 1e-3
    return 100.0 * b * n / secs
