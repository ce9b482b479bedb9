"""The one general generator: a configuration's scene and a traffic mix's
ring of frames, made on the device from ``--seed``.

A configuration (``configs/<name>.json``) names its scene kind
(``scenes/<kind>.py``) and sizes; a traffic mix (``traffic/<name>.json``)
names its motion (``motions/<kind>.py``) with its parameters, the length
of the ring and the calls a frame makes (``calls/<name>.py``).  The ring
is played forward and back (0, 1, ..., R-1, R-2, ..., 1, 0, 1, ...), so
that every step between two frames is one step of the motion, starting at
frame 1: frame 0 is the scene a persistent layer starts from.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent


class Scene:
    """A scene on its device: the system box (host f32 arrays and device
    tensors), (n, dim) f32 bounds, int64 ids (0..n-1, which a scene kind
    may replace with ids of its own below 2^32 - 1), and for balls their
    centres and radii."""

    def __init__(self, system_min, system_max, bounds_min, bounds_max,
                 device, positions=None, radius=None):
        self.system_min = np.asarray(system_min, np.float32)
        self.system_max = np.asarray(system_max, np.float32)
        self.system_min_t = torch.as_tensor(self.system_min, device=device)
        self.system_max_t = torch.as_tensor(self.system_max, device=device)
        self.bounds_min, self.bounds_max = bounds_min, bounds_max
        self.ids = torch.arange(bounds_min.shape[0], dtype=torch.int64,
                                device=device)
        self.positions, self.radius = positions, radius


class Frame(NamedTuple):
    number: int                  # frames since the scene, from 1
    bounds_min: torch.Tensor     # (n, dim) f32, views into the ring
    bounds_max: torch.Tensor
    positions: Optional[torch.Tensor]


def load_json(kind: str, name: str) -> dict:
    return json.loads((ROOT / kind / f"{name}.json").read_text())


def plugin(kind: str, name: str):
    """Module ``bpbench.<kind>.<name>``."""
    return importlib.import_module(f"{__package__}.{kind}.{name}")


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def make_scene(config: dict, gen, device) -> Scene:
    return plugin("scenes", config["scene"]["kind"]).make(config, gen,
                                                          device)


def make_ring(scene: Scene, traffic: dict, gen) -> dict:
    motion = traffic["motion"]
    return plugin("motions", motion["kind"]).ring(scene, motion,
                                                  traffic["ring"], gen)


def slot_of(number: int, frames: int) -> int:
    """The ring frame that frame ``number`` plays (forward, then back)."""
    if frames == 1:
        return 0
    i = number % (2 * frames - 2)
    return i if i < frames else 2 * frames - 2 - i


def frame(ring: dict, number: int) -> Frame:
    k = slot_of(number, ring["bounds_min"].shape[0])
    pos = ring.get("positions")
    return Frame(number, ring["bounds_min"][k], ring["bounds_max"][k],
                 None if pos is None else pos[k])
