"""``merge_roofline``: the least bytes ``layer.merge``'s contract moves
(both live trees read once and the merged tree written once: twice the
tree of each traced frame's merged count) over the card's bandwidth, as
a percent of the span's device time."""

from bpbench import roofline

SPAN = "layer.merge"


def read(run):
    t = run.trace
    if t is None or not t.span_ops.get(SPAN):
        return None
    nbytes = sum(2 * roofline.tree_bytes(run.config, c)
                 for c in t.tree_cells)
    return roofline.share(nbytes, t.span_s[SPAN], run.device_kind)
