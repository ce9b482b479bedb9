"""``scan.idle_ms``: device-idle time that overlaps the host's time
inside ``layer.scan``, per traced frame, in ms; from the pass with the
program's spans on (``bpbench/stages.py``)."""

from bpbench import stages

LAYER = "layer.scan"


def read(run):
    st = stages.of(run)
    if st is None or st.ops == 0 or not st.traced(LAYER):
        return None
    return st.per_frame_ms(st.idle_s[LAYER])
