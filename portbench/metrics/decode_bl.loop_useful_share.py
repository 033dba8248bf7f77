"""decode_bl's useful share, counted: the frame-iterations the frames
needed (the window's iter_sum) over those decode_bl's loop ran (the
program's `decode_bl.frame_iterations` counter: the decode's frames times
its loop's iterations), on any decode_bl path. None where the loop ran
none (a program without the counter, or a whole-decode kernel's path)."""


def read(ctx):
    frame_iterations = ctx["launches"].get("decode_bl.frame_iterations")
    if not frame_iterations:
        return None
    return 100.0 * float(ctx["counters"][:, 4].sum()) / frame_iterations
