"""``update.ops_per_frame``: device operations a traced frame launches
inside the ``update.update`` span."""

SPAN = "update.update"


def read(run):
    t = run.trace
    if t is None or not t.span_ops.get(SPAN):
        return None
    return t.span_ops[SPAN] / t.frames
