"""Balls of the upstream ball-pit example (broadphase-rs
``examples/main.rs``): radii U(radius_min, radius_max), centres uniform
in [place_min, place_max] on each axis of a system box [0, extent];
each ball's bounds are its centre +- its radius."""

import torch

from ..traffic import Scene


def make(config, gen, device) -> Scene:
    p = config["scene"]
    n, dim = config["objects"], config["dim"]
    radius = torch.rand(n, generator=gen, device=device) \
        * (p["radius_max"] - p["radius_min"]) + p["radius_min"]
    pos = torch.rand((n, dim), generator=gen, device=device) \
        * (p["place_max"] - p["place_min"]) + p["place_min"]
    r = radius[:, None]
    return Scene(system_min=[0.0] * dim, system_max=[p["extent"]] * dim,
                 bounds_min=pos - r, bounds_max=pos + r, device=device,
                 positions=pos, radius=radius)
