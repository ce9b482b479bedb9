"""``build_roofline``: the least bytes ``layer.build``'s contract
moves (bounds and ids read once, the sorted tree's keys and ids written
once, at each traced frame's cell count) over the card's bandwidth, as a
percent of the span's device time."""

from bpbench import roofline

SPAN = "layer.build"


def read(run):
    t = run.trace
    if t is None or not t.span_ops.get(SPAN):
        return None
    nbytes = sum(roofline.build_bytes(run.config, c) for c in t.tree_cells)
    return roofline.share(nbytes, t.span_s[SPAN], run.device_kind)
