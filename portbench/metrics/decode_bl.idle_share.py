"""The device's idle time put down to decode_bl's loop: the idle gaps whose
innermost host op is one of the program's `decode_bl.` spans (its entry,
the host's done.all() sync, the routing, the check-node call, the
decision), over the window's seconds. idle_gaps keeps only the trace's 10
largest labels, so a `decode_bl.` label below the tenth is missed. None
where decode_bl's loop counted no iteration (a program without the
counter, or a path that bypasses the loop) or a run without a trace."""

PREFIX = "decode_bl."


def read(ctx):
    if not ctx["launches"].get("decode_bl.loop_iterations") or not ctx.get("idle_gaps") \
            or ctx["window_s"] <= 0:
        return None
    idle = sum(s for name, s in ctx["idle_gaps"] if name.startswith(PREFIX))
    return 100.0 * idle / ctx["window_s"]
