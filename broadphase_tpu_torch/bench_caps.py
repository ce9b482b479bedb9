"""The 1M bench's scene and capacities, for ``chip_smoke.py`` and the tests.

The port's own copy of the capacity functions of
``broadphase_tpu/bench_caps.py`` and of the scene generator
``bench.py::_scene`` (same numbers; ``tests/test_torch_jaxfree.py`` holds
them against the originals).  numpy only.
"""

from __future__ import annotations

import numpy as np

# Raw emission slots per object (~15.7 at the 1M density-1/1000 scene).
EMIT_SLACK = 16

# Unique pairs per object (8.53 at the 1M scene) + 5.5% headroom.
PAIR_SLACK = 9


def tree_capacity(n: int) -> int:
    """Tree cells for n objects: 3.7 per object, rounded up to 1024."""
    return ((max(1, (37 * n) // 10) // 1024) + 1) * 1024


def pair_capacity(n: int, slack: int = PAIR_SLACK) -> int:
    return ((slack * n) // 1024) * 1024


def emit_capacity(n: int, slack: int = EMIT_SLACK) -> int:
    return ((slack * n) // 1024) * 1024


def update_caps(n: int, churn_frac: float) -> tuple:
    """(churn_cap, obj_cap) for an update frame in which ``churn_frac`` of
    the n objects change cells: 8.25 cell slots per changed object on each
    side (every mover may fill its whole 2x2x2 block), and ~30% headroom on
    the changed-object count."""
    objs = max(64, int(n * churn_frac))
    churn_cap = ((8 * objs + objs // 4) // 1024 + 1) * 1024
    obj_cap = ((objs + (3 * objs) // 10) // 1024 + 1) * 1024
    return churn_cap, obj_cap


def bench_scene(dim: int, n: int, seed: int = 0, density: float = 1e-3,
                size_range=(1.0, 10.0)):
    """(system_min, system_max, bounds_min, bounds_max, ids) of the bench's
    boxes scene: cubic system box of volume n / density, uniform sizes and
    placement, ids 0..n-1."""
    rng = np.random.default_rng(seed)
    extent = (n / density) ** (1.0 / dim)
    lo, hi = 0.0, float(extent)
    size = rng.uniform(size_range[0], size_range[1],
                       size=(n, dim)).astype(np.float32)
    bmin = (rng.uniform(lo, hi, size=(n, dim)).astype(np.float32)
            * ((hi - size_range[1]) / hi)).astype(np.float32)
    bmax = bmin + size
    ids = np.arange(n, dtype=np.uint32)
    smin = np.full(dim, lo, np.float32)
    smax = np.full(dim, hi, np.float32)
    return smin, smax, bmin, bmax, ids
