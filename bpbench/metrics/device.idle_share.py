"""``device.idle_share``: the share of the traced frames' window in which
no device operation runs (the profiler's own host cost included)."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
