"""A persistent scene's frame: a fixed share of the objects, drawn anew
each frame, jumps U(-jump, jump) on each axis, and every object drifts by
``drift`` on each axis; sizes kept, clamped inside the system box."""

import torch


def ring(scene, params, frames, gen):
    bmin0 = scene.bounds_min
    n, dev = bmin0.shape[0], bmin0.device
    size = scene.bounds_max - bmin0
    lo = scene.system_min_t
    hi = scene.system_max_t - size
    movers = round(params["fraction"] * n)
    bmin = torch.empty((frames,) + bmin0.shape, dtype=torch.float32,
                       device=dev)
    bmin[0] = bmin0
    for k in range(1, frames):
        d = torch.full_like(bmin0, params["drift"])
        pick = torch.rand(n, generator=gen, device=dev).argsort()[:movers]
        d[pick] += (torch.rand((movers, bmin0.shape[1]), generator=gen,
                               device=dev) * 2 - 1) * params["jump"]
        bmin[k] = torch.minimum(torch.maximum(bmin[k - 1] + d, lo), hi)
    return {"bounds_min": bmin, "bounds_max": bmin + size}
