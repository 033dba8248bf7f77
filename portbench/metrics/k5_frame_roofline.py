"""K5's share of its roofline, charged the frames it computed: the T-EMS
check-node bound of one frame at [M, dc, q] and the decoder's n_r times
the program's `cn_tems.frame_iterations` counter (the frames of each
launch, the listed ones where decode_bl hands K5 its frames not yet done),
over K5's device seconds. k5_roofline charges every launch all S B frames.
None where the counter is absent (a program without it) or K5 did not
run."""

from portbench import bounds, trace


def read(ctx):
    secs, n = trace.kernel(ctx, "cn_tems_kernel")
    frames = ctx["launches"].get("cn_tems.frame_iterations")
    if not n or not frames or secs <= 0:
        return None
    b = bounds.tems_cn_bound(ctx["shape"], 1, ctx["decoder"].get("tems_nr", 0))["bound_ms"]
    return 100.0 * b * 1e-3 * frames / secs
