"""``scan.spilled_share``: the live keys that the canonical pair sort (k8)
sorted through global memory, its buckets being too large for shared
memory, over the emission slots the scans filled (``prep_runs``' total),
in percent, summed over the traced frames; from the program's counters
``scan.sort_spilled`` and ``scan.emitted`` (``bpbench/stages.py``).
Nothing to read where no scan sorted its pairs canonically."""

from bpbench import stages


def read(run):
    st = stages.of(run)
    if (st is None or "scan.sort_spilled" not in st.counters
            or not st.counters.get("scan.emitted")):
        return None
    return (100.0 * st.counters["scan.sort_spilled"]
            / st.counters["scan.emitted"])
