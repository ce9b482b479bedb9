"""``layer.scan``: the candidate pairs of the frame's tree (k2-k5, and
with ``canonical`` the pair sort and dedup)."""

from broadphase_tpu_torch import layer

SPAN = "layer.scan"


def prepare(cell) -> None:
    pass


def run(cell, frame, out) -> None:
    out["tree"], out["pairs"] = layer.scan(
        cell.spec, out["tree"], cell.caps.pairs,
        emit_capacity=cell.caps.emit, canonical=cell.traffic["canonical"])
