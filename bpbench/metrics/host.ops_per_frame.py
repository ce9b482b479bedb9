"""``host.ops_per_frame``: device operations (kernels, copies, fills) a
traced frame launches, the read back included: a reading, not a list of
expected kernels."""


def read(run):
    t = run.trace
    if t is None or t.ops == 0:
        return None
    return t.ops / t.frames
