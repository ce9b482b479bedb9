"""``update.idle_ms``: device-idle time that overlaps the host's time
inside the update, per traced frame, in ms; from the pass with the
program's spans on (``bpbench/stages.py``).  As ``update.host_ms``, read
under the harness's ``update.update``, the layer ``stages.py`` gives the
port's ``layer.update`` span, once the port has opened that span."""

from bpbench import stages

SPAN = "layer.update"
LAYER = "update.update"


def read(run):
    st = stages.of(run)
    row = None if st is None else st.rows.get(SPAN)
    if row is None or not row.calls or st.ops == 0:
        return None
    return st.per_frame_ms(st.idle_s[LAYER])
