"""``host.frame_ms_p95``: ``frame_ms_p95`` read where the host's drift
from run to run swings it too far to bound (the 95th percentile of every
window frame's time, from its first call to its read back)."""

import numpy as np


def read(run):
    return float(np.percentile(run.window.frame_s, 95)) * 1e3
