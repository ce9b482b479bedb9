"""``layer.build`` of a level's dynamic objects alone (ids from the
configuration's ``static_objects`` on), into a tree of their own
capacity: ``tree_capacity`` of the dynamic count at the configuration's
cells an object, not the union's."""

from broadphase_tpu_torch import layer

from ..caps import tree_capacity

SPAN = "layer.build"


def prepare(cell) -> None:
    c = cell.config
    cell.dynamic_from = c["static_objects"]
    cell.dynamic_capacity = tree_capacity(
        c["objects"] - cell.dynamic_from,
        c["capacity"]["tree_tenths_per_object"])


def run(cell, frame, out) -> None:
    c, s = cell.config, cell.dynamic_from
    out["tree"] = layer.build(
        cell.spec, cell.scene.system_min_t, cell.scene.system_max_t,
        frame.bounds_min[s:], frame.bounds_max[s:], cell.scene.ids[s:],
        slots_per_axis=c["slots_per_axis"], min_depth=c["min_depth"],
        out_capacity=cell.dynamic_capacity)
