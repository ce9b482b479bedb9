"""``frame_ms_p95``: the 95th percentile of every window frame's time,
from its first call to its read back on the host."""

import numpy as np


def read(run):
    return float(np.percentile(run.window.frame_s, 95)) * 1e3
