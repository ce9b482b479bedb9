"""A level's frame: the static objects (the scene's first
``static_objects``) stay where they are in every frame; each dynamic
object walks U(-step, step) on each axis, its size kept, clamped so that
it stays inside the system box, as ``walk`` moves every object."""

import torch


def ring(scene, params, frames, gen):
    bmin0 = scene.bounds_min
    s = scene.static_objects
    size = scene.bounds_max - bmin0
    lo = scene.system_min_t
    hi = scene.system_max_t - size[s:]
    bmin = bmin0[None].repeat(frames, 1, 1)
    step = params["step"]
    for k in range(1, frames):
        d = (torch.rand(bmin0[s:].shape, generator=gen, device=bmin0.device)
             * 2 - 1) * step
        bmin[k, s:] = torch.minimum(torch.maximum(bmin[k - 1, s:] + d, lo),
                                    hi)
    return {"bounds_min": bmin, "bounds_max": bmin + size}
