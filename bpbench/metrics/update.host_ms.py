"""``update.host_ms``: host time a traced frame spends inside the update,
less the time it blocks in synchronising CUDA runtime calls there, in
ms; from the pass with the program's spans on (``bpbench/stages.py``).
The port's span is ``layer.update``; the harness's call span around it
is ``update.update``, so ``stages.py`` gives the layer that name, and the
time is read under ``update.update`` once the port has opened
``layer.update`` in the pass."""

from bpbench import stages

SPAN = "layer.update"
LAYER = "update.update"


def read(run):
    st = stages.of(run)
    row = None if st is None else st.rows.get(SPAN)
    if row is None or not row.calls:
        return None
    return st.per_frame_ms(st.host_s[LAYER])
