"""``layer.merge`` of a level's static layer with the frame's dynamic
layer (k6 on the sorted path).  The static layer is built once at set-up
from ring frame 0's static objects (ids below the configuration's
``static_objects``) at the union's tree capacity, so that the merged
tree, which takes the static layer's capacity, holds the whole world."""

from broadphase_tpu_torch import layer

SPAN = "layer.merge"


def prepare(cell) -> None:
    c, s = cell.config, cell.config["static_objects"]
    cell.static = layer.build(
        cell.spec, cell.scene.system_min_t, cell.scene.system_max_t,
        cell.ring["bounds_min"][0][:s], cell.ring["bounds_max"][0][:s],
        cell.scene.ids[:s], slots_per_axis=c["slots_per_axis"],
        min_depth=c["min_depth"], out_capacity=cell.caps.tree)


def run(cell, frame, out) -> None:
    out["tree"] = layer.merge(cell.spec, cell.static, out["tree"])
