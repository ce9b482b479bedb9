"""``scan_roofline``: the least bytes ``layer.scan``'s contract
moves (the tree read once, the pairs written once at 8 bytes a pair, at
each traced frame's counts) over the card's bandwidth, as a percent of
the span's device time."""

from bpbench import roofline

SPAN = "layer.scan"


def read(run):
    t = run.trace
    if t is None or not t.span_ops.get(SPAN):
        return None
    nbytes = sum(roofline.scan_bytes(run.config, c, p)
                 for c, p in zip(t.tree_cells, t.pairs))
    return roofline.share(nbytes, t.span_s[SPAN], run.device_kind)
