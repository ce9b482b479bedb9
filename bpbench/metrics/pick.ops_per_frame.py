"""``pick.ops_per_frame``: device operations a traced frame launches
inside the ``query.pick_ray`` span."""

SPAN = "query.pick_ray"


def read(run):
    t = run.trace
    if t is None or not t.span_ops.get(SPAN):
        return None
    return t.span_ops[SPAN] / t.frames
