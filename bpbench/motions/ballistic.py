"""Balls fly straight at a constant velocity, of a speed U(0, speed_max)
a frame in a uniform direction, and reflect off the walls of the system
box."""

import torch


def ring(scene, params, frames, gen):
    pos0, r = scene.positions, scene.radius[:, None]
    n, dim = pos0.shape
    dev = pos0.device
    direction = torch.randn((n, dim), generator=gen, device=dev)
    direction = direction / direction.norm(dim=1, keepdim=True)
    vel = direction * (torch.rand((n, 1), generator=gen, device=dev)
                       * params["speed_max"])
    lo = scene.system_min_t + r
    hi = scene.system_max_t - r
    pos = torch.empty((frames, n, dim), dtype=torch.float32, device=dev)
    pos[0] = pos0
    for k in range(1, frames):
        p = pos[k - 1] + vel
        low, high = p < lo, p > hi
        p = torch.where(low, 2 * lo - p, torch.where(high, 2 * hi - p, p))
        vel = torch.where(low | high, -vel, vel)
        pos[k] = p
    return {"bounds_min": pos - r, "bounds_max": pos + r, "positions": pos}
