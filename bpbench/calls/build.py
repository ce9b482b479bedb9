"""``layer.build``: the frame's bounds quantized, emitted into cells (k1)
and sorted into a fresh tree."""

from broadphase_tpu_torch import layer

SPAN = "layer.build"


def prepare(cell) -> None:
    pass


def run(cell, frame, out) -> None:
    c = cell.config
    out["tree"] = layer.build(
        cell.spec, cell.scene.system_min_t, cell.scene.system_max_t,
        frame.bounds_min, frame.bounds_max, cell.scene.ids,
        slots_per_axis=c["slots_per_axis"], min_depth=c["min_depth"],
        out_capacity=cell.caps.tree)
