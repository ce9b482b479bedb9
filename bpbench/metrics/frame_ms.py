"""``frame_ms``: the window's length over the frames completed in it, all
the time over all the frames (a frame: the calls and the host read of
the pair count and the overflow flag)."""


def read(run):
    return run.window.elapsed_s / run.window.frames * 1e3
