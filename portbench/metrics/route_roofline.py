"""decode_bl's routing (route_down and route_up) as one share of its
roofline: each half's bound at the step's frames times its launches, over
their device seconds."""

from portbench import bounds, trace


def read(ctx):
    sd, nd = trace.kernel(ctx, "route_down_kernel")
    su, nu = trace.kernel(ctx, "route_up_kernel")
    if not (nd or nu) or sd + su <= 0:
        return None
    rb = bounds.route_bounds(ctx["shape"], ctx["S"] * ctx["B"])
    total = rb["route_down"]["bound_ms"] * nd + rb["route_up"]["bound_ms"] * nu
    return 100.0 * total * 1e-3 / (sd + su)
