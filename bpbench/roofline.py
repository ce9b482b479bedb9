"""The table of peaks and the least bytes a layer's contract moves.

A roofline share is the least time the card could take, the contract's
bytes over the card's memory bandwidth, over the layer's device time.
The bytes count each input read once and each output written once at
the narrowest width the contract allows (f32 coordinates, u32 ids, keys
of the index's width, a pair as two u32), whatever the implementation
reads again or stores wider, so that the share counts the same work
whatever kernels implement the layer.  Every layer here has no floating
point work to speak of: bandwidth bounds it.
"""

from __future__ import annotations

from typing import Optional

from .reference.broadphase import SPECS

# HBM bandwidth, bytes/s, of NVIDIA's data sheets (at the full power limit)
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
}
COORD_BYTES = 4
ID_BYTES = 4
PAIR_BYTES = 2 * ID_BYTES


def peak_bytes_per_s(kind: str) -> Optional[float]:
    return PEAK_BYTES_PER_S.get(kind)


def key_bytes(config: dict) -> int:
    return 4 if SPECS[config["index"]].key_bits <= 32 else 8


def tree_bytes(config: dict, cells: int) -> int:
    """A sorted tree of ``cells`` entries: a key and an id each."""
    return cells * (key_bytes(config) + ID_BYTES)


def build_bytes(config: dict, cells: int) -> int:
    """The objects' bounds and ids read once, the tree written once."""
    n, dim = config["objects"], config["dim"]
    return n * (2 * dim * COORD_BYTES + ID_BYTES) + tree_bytes(config, cells)


def scan_bytes(config: dict, cells: int, pairs: int) -> int:
    """The tree read once, the pairs written once."""
    return tree_bytes(config, cells) + pairs * PAIR_BYTES


def share(nbytes: float, seconds: float, kind: str) -> Optional[float]:
    """Percent of the card's bandwidth bound that ``seconds`` of device
    time reaches; None where the card or the time is unknown."""
    peak = peak_bytes_per_s(kind)
    if peak is None or seconds <= 0:
        return None
    return 100.0 * nbytes / peak / seconds
