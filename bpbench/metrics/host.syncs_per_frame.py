"""``host.syncs_per_frame``: synchronising CUDA runtime calls
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``, ``cudaMemcpy``) a traced frame makes inside the
program's spans, the harness's read back left out; from the pass with
the program's spans on (``bpbench/stages.py``)."""

from bpbench import stages


def read(run):
    st = stages.of(run)
    if st is None or st.ops == 0 or not any(
            st.rows[n].calls for n in st.program if n in st.rows):
        return None
    return st.syncs() / st.frames
