"""``update_roofline``: the least bytes the update's contract moves over
the card's bandwidth, as a percent of the device time of the harness's
``update.update`` span.  The contract reads both frames' bounds once
(last frame's, which the tracked scene keeps, and this frame's), reads
the tracked tree once and writes the new tree once, at each traced
frame's cell count; the signatures and the churn are the implementation's
and count nothing."""

from bpbench import roofline

SPAN = "update.update"


def update_bytes(config: dict, cells: int) -> int:
    """Both frames' f32 bounds read once, the tree of ``cells`` entries
    read once and written once."""
    n, dim = config["objects"], config["dim"]
    return (2 * n * 2 * dim * roofline.COORD_BYTES
            + 2 * roofline.tree_bytes(config, cells))


def read(run):
    t = run.trace
    if t is None or not t.span_ops.get(SPAN):
        return None
    nbytes = sum(update_bytes(run.config, c) for c in t.tree_cells)
    return roofline.share(nbytes, t.span_s[SPAN], run.device_kind)
