"""BR_SCENE serialization: the reference's scene format, byte for byte.

The port's own copy of the reader and writer of
``broadphase_tpu/utils/scene.py`` (numpy only): a file written by either
reads back the same in the other, and the same scene dumps to the same
bytes.  ``layer.layer_to_scene_layer`` and ``layer.layer_from_scene_layer``
carry a layer to and from a :class:`SceneLayer`.

Format (reference ``data/src/lib.rs``): bincode-1.x default encoding —
little-endian fixed-width integers, ``u64`` length prefixes on ``Vec``,
1-byte ``Option`` tags, fixed arrays raw.

    header:  signature [u8;8] = b"BR_SCENE", version (u16,u16) = (1,2)
    body (SceneV1_2, data/src/lib.rs:41-49):
      system_bounds: Bounds<Point3<f32>>            -> 6 x f32
      object_bounds: Vec<(Bounds<Point3<f32>>, u32)> -> u64 n + n*(6*f32+u32)
      layer: Layer<Index64_3D, u32>                 -> min_depth u32 +
             tree (Vec<(u64 key, u32 id)>, bool sorted)   (src/layer.rs:40-67;
             temp buffers are serde(skip))
      collisions: Vec<(u32, u32)>
      hits: Vec<u32>
      nearest: Option<(u32, f32)>

Index64_3D is a serde newtype over u64 (``src/index.rs:67-69``) -> 8 bytes.
Scene fixes ID=u32, Index=Index64_3D (``data/src/lib.rs:16-17``).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional, Tuple

import numpy as np

SIGNATURE = b"BR_SCENE"
VERSION = (1, 2)


@dataclasses.dataclass
class SceneLayer:
    """Serialized Layer state (persistent fields only)."""

    min_depth: int = 0
    keys: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.uint64))
    ids: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.uint32))
    sorted: bool = True


@dataclasses.dataclass
class Scene:
    """SceneV1_2 (reference ``data/src/lib.rs:41-49``)."""

    system_min: np.ndarray          # (3,) f32
    system_max: np.ndarray          # (3,) f32
    bounds_min: np.ndarray          # (n, 3) f32
    bounds_max: np.ndarray          # (n, 3) f32
    ids: np.ndarray                 # (n,) u32
    layer: SceneLayer = dataclasses.field(default_factory=SceneLayer)
    collisions: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), np.uint32))
    hits: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.uint32))
    nearest: Optional[Tuple[int, float]] = None


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def take(self, n: int) -> bytes:
        b = self.data[self.off:self.off + n]
        if len(b) != n:
            raise ValueError("unexpected EOF in BR_SCENE stream")
        self.off += n
        return b

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def u8(self) -> int:
        return self.take(1)[0]

    def f32(self) -> float:
        return struct.unpack("<f", self.take(4))[0]

    def array(self, dtype, count: int) -> np.ndarray:
        dt = np.dtype(dtype).newbyteorder("<")
        return np.frombuffer(self.take(dt.itemsize * count),
                             dtype=dt).astype(dtype)


def loads(data: bytes) -> Scene:
    r = _Reader(data)
    sig = r.take(8)
    if sig != SIGNATURE:
        raise ValueError(f"invalid signature {sig!r}")
    ver = (r.u16(), r.u16())
    if ver[0] != VERSION[0] or ver[1] > VERSION[1]:
        raise ValueError(f"unsupported version {ver}")

    smin = np.array([r.f32() for _ in range(3)], np.float32)
    smax = np.array([r.f32() for _ in range(3)], np.float32)
    n = r.u64()
    rec = r.array(np.uint8, n * 28).reshape(n, 28) if n else \
        np.zeros((0, 28), np.uint8)
    flat = rec[:, :24].reshape(n * 6 * 4) if n else np.zeros(0, np.uint8)
    f = np.frombuffer(flat.tobytes(), "<f4").reshape(n, 6) if n else \
        np.zeros((0, 6), np.float32)
    bmin = f[:, :3].astype(np.float32)
    bmax = f[:, 3:].astype(np.float32)
    ids = np.frombuffer(rec[:, 24:].tobytes(), "<u4").astype(np.uint32) \
        if n else np.zeros(0, np.uint32)

    layer = SceneLayer()
    collisions = np.zeros((0, 2), np.uint32)
    hits = np.zeros(0, np.uint32)
    nearest = None
    if ver[1] >= 1:
        layer.min_depth = r.u32()
        tn = r.u64()
        trec = r.array(np.uint8, tn * 12).reshape(tn, 12) if tn else \
            np.zeros((0, 12), np.uint8)
        layer.keys = np.frombuffer(trec[:, :8].tobytes(), "<u8").astype(
            np.uint64) if tn else np.zeros(0, np.uint64)
        layer.ids = np.frombuffer(trec[:, 8:].tobytes(), "<u4").astype(
            np.uint32) if tn else np.zeros(0, np.uint32)
        layer.sorted = bool(r.u8())
    if ver[1] >= 2:
        cn = r.u64()
        collisions = r.array(np.uint32, cn * 2).reshape(cn, 2)
        hn = r.u64()
        hits = r.array(np.uint32, hn)
        if r.u8():
            nearest = (r.u32(), r.f32())
    return Scene(smin, smax, bmin, bmax, ids, layer, collisions, hits,
                 nearest)


def dumps(scene: Scene) -> bytes:
    out = bytearray()
    out += SIGNATURE
    out += struct.pack("<HH", *VERSION)
    out += np.asarray(scene.system_min, "<f4").tobytes()
    out += np.asarray(scene.system_max, "<f4").tobytes()

    n = len(scene.ids)
    out += struct.pack("<Q", n)
    rec = np.zeros((n, 28), np.uint8)
    f = np.concatenate([np.asarray(scene.bounds_min, "<f4"),
                        np.asarray(scene.bounds_max, "<f4")], axis=1)
    rec[:, :24] = np.frombuffer(f.tobytes(), np.uint8).reshape(n, 24)
    rec[:, 24:] = np.frombuffer(
        np.asarray(scene.ids, "<u4").tobytes(), np.uint8).reshape(n, 4)
    out += rec.tobytes()

    out += struct.pack("<I", scene.layer.min_depth)
    tn = len(scene.layer.ids)
    out += struct.pack("<Q", tn)
    trec = np.zeros((tn, 12), np.uint8)
    trec[:, :8] = np.frombuffer(
        np.asarray(scene.layer.keys, "<u8").tobytes(), np.uint8
    ).reshape(tn, 8)
    trec[:, 8:] = np.frombuffer(
        np.asarray(scene.layer.ids, "<u4").tobytes(), np.uint8
    ).reshape(tn, 4)
    out += trec.tobytes()
    out += struct.pack("<B", 1 if scene.layer.sorted else 0)

    cn = len(scene.collisions)
    out += struct.pack("<Q", cn)
    out += np.asarray(scene.collisions, "<u4").tobytes()
    out += struct.pack("<Q", len(scene.hits))
    out += np.asarray(scene.hits, "<u4").tobytes()
    if scene.nearest is None:
        out += b"\x00"
    else:
        out += b"\x01" + struct.pack("<If", scene.nearest[0],
                                     scene.nearest[1])
    return bytes(out)


def load(path) -> Scene:
    with open(path, "rb") as f:
        return loads(f.read())


def save(path, scene: Scene) -> None:
    with open(path, "wb") as f:
        f.write(dumps(scene))
