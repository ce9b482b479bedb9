"""``scan.kept_share``: the pairs the scans kept over the emission slots
they filled (``prep_runs``' total), in percent, summed over the traced
frames: the scan's useful work over its attempts; from the program's
counters ``scan.pairs`` and ``scan.emitted`` (``bpbench/stages.py``)."""

from bpbench import stages


def read(run):
    st = stages.of(run)
    if st is None or not st.counters.get("scan.emitted"):
        return None
    return 100.0 * st.counters["scan.pairs"] / st.counters["scan.emitted"]
