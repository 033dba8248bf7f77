"""K0-cl's share of its roofline: the resident QSPA bound of each window
step at the frame-iterations it needed (its iter_sum) over the device
seconds of K0-cl's cluster kernel. None where the cluster kernel did not
run (K0's path, or a code only the scratch kernel holds)."""

from portbench import bounds, trace


def read(ctx):
    secs, n = trace.kernel(ctx, "qspa_cluster_kernel")
    if not n or secs <= 0:
        return None
    frames = ctx["S"] * ctx["B"]
    per_step = [bounds.resident_qspa_bound(ctx["shape"], frames, int(c[4].sum()))["bound_ms"]
                for c in ctx["counters"]]
    # one K0-cl launch a step; scaled if the trace counts another number
    total = sum(per_step) * n / len(per_step)
    return 100.0 * total * 1e-3 / secs
