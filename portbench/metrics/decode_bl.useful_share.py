"""decode_bl's useful share: the frame-iterations the frames needed (the
window's iter_sum) over those it computed (every frame of the step at each
of its loop iterations, counted by the K5 launches)."""


def read(ctx):
    launches = ctx["launches"].get("cn_tems", 0)
    if not launches:
        return None
    return 100.0 * float(ctx["counters"][:, 4].sum()) / (ctx["S"] * ctx["B"] * launches)
