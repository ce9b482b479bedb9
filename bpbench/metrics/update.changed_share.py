"""``update.changed_share``: the objects whose cell signature the update
found changed, over the objects, in percent, summed over the traced
frames: how much of the world the frame's churn touches; from the
program's counter ``update.changed`` (``bpbench/stages.py``).  Nothing
to read where the program keeps no such counter.

``stages.py`` plays the traced frames twice, with the program's tracing
off and then on, so the first frame it counts advances the persistent
layer from the last frame of the first pass back to the first: that one
diff spans several steps of the ring, and the share reads above the
frames' own churn by its excess over the mean (one frame in 36 to 100
traced frames)."""

from bpbench import stages


def read(run):
    st = stages.of(run)
    if st is None or "update.changed" not in st.counters:
        return None
    return (100.0 * st.counters["update.changed"]
            / (run.config["objects"] * st.frames))
