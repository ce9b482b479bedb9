"""``merge.host_ms``: host time a traced frame spends inside
``layer.merge``, less the time it blocks in synchronising CUDA runtime
calls there, in ms; from the pass with the program's spans on
(``bpbench/stages.py``)."""

from bpbench import stages

LAYER = "layer.merge"


def read(run):
    st = stages.of(run)
    if st is None or not st.traced(LAYER):
        return None
    return st.per_frame_ms(st.host_s[LAYER])
