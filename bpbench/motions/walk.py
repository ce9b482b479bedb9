"""Every object moves every frame: a random walk of U(-step, step) on
each axis, its size kept, clamped so that it stays inside the system
box."""

import torch


def ring(scene, params, frames, gen):
    bmin0 = scene.bounds_min
    size = scene.bounds_max - bmin0
    lo = scene.system_min_t
    hi = scene.system_max_t - size
    bmin = torch.empty((frames,) + bmin0.shape, dtype=torch.float32,
                       device=bmin0.device)
    bmin[0] = bmin0
    step = params["step"]
    for k in range(1, frames):
        d = (torch.rand(bmin0.shape, generator=gen, device=bmin0.device)
             * 2 - 1) * step
        bmin[k] = torch.minimum(torch.maximum(bmin[k - 1] + d, lo), hi)
    return {"bounds_min": bmin, "bounds_max": bmin + size}
