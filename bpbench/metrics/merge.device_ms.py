"""``merge.device_ms``: device time a traced frame spends in operations
launched inside the ``layer.merge`` span, in ms."""

SPAN = "layer.merge"


def read(run):
    t = run.trace
    if t is None or not t.span_ops.get(SPAN):
        return None
    return t.span_s[SPAN] / t.frames * 1e3
