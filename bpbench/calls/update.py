"""``update.update``: the persistent layer built at set-up from frame 0
(``update.build_tracked``) advanced to the frame's bounds by signature
diff and tombstone merge (k5, k6), with churn capacities for the mix's
``churn_fraction``."""

from broadphase_tpu_torch import update

from ..caps import update_caps

SPAN = "update.update"


def prepare(cell) -> None:
    c = cell.config
    cell.churn_caps = update_caps(c["objects"],
                                  cell.traffic["churn_fraction"])
    cell.tracked = update.build_tracked(
        cell.spec, cell.scene.system_min_t, cell.scene.system_max_t,
        cell.ring["bounds_min"][0], cell.ring["bounds_max"][0],
        cell.scene.ids, slots_per_axis=c["slots_per_axis"],
        min_depth=c["min_depth"], out_capacity=cell.caps.tree)


def run(cell, frame, out) -> None:
    churn_cap, obj_cap = cell.churn_caps
    cell.tracked = update.update(
        cell.spec, cell.tracked, cell.scene.system_min_t,
        cell.scene.system_max_t, frame.bounds_min, frame.bounds_max,
        churn_cap, slots_per_axis=cell.config["slots_per_axis"],
        obj_cap=obj_cap)
    out["tree"] = cell.tracked.state
