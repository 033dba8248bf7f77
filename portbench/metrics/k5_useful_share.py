"""K5's useful share: the frame-iterations the frames needed (the window's
iter_sum) over those the T-EMS check node computed (the program's
`cn_tems.frame_iterations` counter: the frames of each launch, the listed
ones where decode_bl retires done frames). None where the counter is
absent (a program without it) or did not move (a path without K5)."""


def read(ctx):
    frame_iterations = ctx["launches"].get("cn_tems.frame_iterations")
    if not frame_iterations:
        return None
    return 100.0 * float(ctx["counters"][:, 4].sum()) / frame_iterations
