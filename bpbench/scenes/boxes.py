"""The upstream ``gen_boxes`` scene (broadphase-rs
``utils/src/gen_test_data.rs``): a cubic system box of side
``(objects / density) ** (1 / dim) + avg_size``, box sizes
U(size_min, size_max) on each axis and each box's minimum corner uniform
in [0, side - size) on that axis; ids 0..n-1."""

import numpy as np
import torch

from ..traffic import Scene


def make(config, gen, device) -> Scene:
    p = config["scene"]
    n, dim = config["objects"], config["dim"]
    lo, hi = p["size_min"], p["size_max"]
    side = float(np.float32((n / p["density"]) ** (1.0 / dim)
                            + (lo + hi) / 2))
    size = torch.rand((n, dim), generator=gen, device=device) * (hi - lo) + lo
    bmin = torch.rand((n, dim), generator=gen, device=device) * (side - size)
    return Scene(system_min=[0.0] * dim, system_max=[side] * dim,
                 bounds_min=bmin, bounds_max=bmin + size, device=device)
