"""The device's idle time put down to the sim step: the idle gaps whose
innermost host op is one of the program's `step.` spans (the noise, the
channel, the decode call, the counters), over the window's seconds.
idle_gaps keeps only the trace's 10 largest labels, so a `step.` label
below the tenth is missed. None for a program without the spans (no
`sweep.loop_ns` counter) or a run without a trace."""

PREFIX = "step."


def read(ctx):
    if "sweep.loop_ns" not in ctx["launches"] or not ctx.get("idle_gaps") \
            or ctx["window_s"] <= 0:
        return None
    idle = sum(s for name, s in ctx["idle_gaps"] if name.startswith(PREFIX))
    return 100.0 * idle / ctx["window_s"]
