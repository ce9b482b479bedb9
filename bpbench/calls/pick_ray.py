"""``query.pick_ray``: the ball nearest along the ray the upstream
ball-pit example casts every frame, from ``ray.origin`` along a direction
that sweeps ``ray.span`` radians from ``ray.start`` over ``ray.period``
frames (``(sin a * ray.x_scale, cos a)``), with the example's exact
ray-circle distance as the narrow phase.  The system box, origin and
direction are host values, as an engine holds them; the narrow phase's
arguments are on the device."""

import numpy as np
import torch

from broadphase_tpu_torch import query

SPAN = "query.pick_ray"


def ray_circle(ids, mask, pos, radius, origin, dirn):
    """Exact ray-circle distance of each slot's ball, inf on a miss: the
    upstream example's narrow phase (main.rs), each sum written out so
    that every device adds in one order."""
    i = torch.where(mask, ids, 0)
    c = pos[i] - origin
    t = c[:, 0] * dirn[0] + c[:, 1] * dirn[1]
    d2 = c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] - t * t
    r = radius[i]
    r2 = r * r
    root = torch.sqrt(torch.clamp(r2 - d2, min=0.0))
    hit = (d2 <= r2) & (t + root >= 0)
    return torch.where(hit, t - root, torch.inf)


def directions(ray: dict):
    """(directions, unit directions): (period, 2) f32 each, the sweep's
    direction at each frame of its period."""
    f32 = np.float32
    period = ray["period"]
    frac = np.arange(period, dtype=f32) / f32(period)
    a = f32(ray["start"]) + f32(ray["span"]) * frac
    d = np.stack([np.sin(a) * f32(ray["x_scale"]), np.cos(a)], axis=1)
    d = d.astype(f32)
    norm = np.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    return d, (d / norm[:, None]).astype(f32)


def prepare(cell) -> None:
    ray = cell.traffic["ray"]
    cell.ray_dirs, cell.ray_units = directions(ray)
    cell.ray_origin = np.asarray(ray["origin"], np.float32)
    dev = cell.scene.ids.device
    cell.ray_origin_t = torch.as_tensor(cell.ray_origin, device=dev)
    cell.ray_units_t = torch.as_tensor(cell.ray_units, device=dev)


def run(cell, frame, out) -> None:
    ray = cell.traffic["ray"]
    j = frame.number % ray["period"]
    out["tree"], out["pick"] = query.pick_ray(
        cell.spec, out["tree"], cell.scene.system_min,
        cell.scene.system_max, cell.ray_origin, cell.ray_dirs[j],
        ray["max_distance"], ray_circle,
        (frame.positions, cell.scene.radius, cell.ray_origin_t,
         cell.ray_units_t[j]))
