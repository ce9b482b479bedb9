"""Rank bodies that drive the sharded surface on host inputs and return
every output, for ``broadphase_tpu_torch.parallel.run_ranks``.

A spawned rank imports the module of its target, so the bodies live apart
from the test modules, which import JAX: this module imports only torch
and the port (``test_torch_jaxfree.py`` runs it where JAX cannot load),
and the ranks find it on the ``sys.path`` they inherit.  Each body takes
``(rank, device, cases)``: a list of dicts of numpy inputs (global object
arrays, which every rank cuts to its object shard) and keyword
configurations, and returns one dict of outputs per case.  The user
callables (scan filters, pick distances) are named, so a case pickles:
:data:`FILTERS` and :data:`DISTANCES`.
"""

from __future__ import annotations

import torch

from broadphase_tpu_torch import convert, layer, scene
from broadphase_tpu_torch.index import ALL_SPECS
from broadphase_tpu_torch.parallel.layer import (
    gather_layer, make_build_sharded, make_merge_sharded,
    make_queries_sharded, make_scan_sharded, shard_layer)
from broadphase_tpu_torch.parallel.scan import (
    gather_pairs, make_sharded_step, min_depth_for_devices, object_shard,
    world)
from broadphase_tpu_torch.parallel.update import (make_build_tracked_sharded,
                                                  make_update_sharded)

SPECS = {s.name: s for s in ALL_SPECS}


def filter_odd_sum(a, b):
    """Keep a pair when its ids' sum is odd."""
    return ((a + b) & 1) == 1


def distance_mod4(ids, mask):
    """A coarse distance (the id mod 4) with many ties, so that the pick's
    (visit rank, tree position) tie-break decides."""
    return torch.where(mask, (ids % 4).to(torch.float32), torch.inf)


def distance_scaled(ids, mask, k):
    """``(id * k) mod 7``, with ``k`` one of the query's arguments."""
    return torch.where(mask, ((ids * k) % 7).to(torch.float32), torch.inf)


FILTERS = {"odd_sum": filter_odd_sum}
DISTANCES = {"mod4": distance_mod4, "scaled": distance_scaled}


def _shard(scene_np):
    """(system_min, system_max, and the rank's object shard of bounds_min,
    bounds_max, ids)."""
    smin, smax, bmin, bmax, ids = scene_np
    return (smin, smax, object_shard(bmin), object_shard(bmax),
            object_shard(ids))


def _scan_config(cfg: dict) -> dict:
    cfg = dict(cfg)
    if "filter" in cfg:
        cfg["filter_fn"] = FILTERS[cfg.pop("filter")]
    return cfg


def _threads(device: torch.device) -> None:
    # many CPU ranks on one host: one thread each
    if device.type == "cpu":
        torch.set_num_threads(1)


def drive_step(rank, device, cases):
    """Each case: ``spec``, ``scene`` and the ``step`` configuration of
    ``make_sharded_step`` (``filter`` names a filter).  Returns the rank's
    :class:`~.scan.ShardedScanResult` and the gathered pairs."""
    _threads(device)
    out = []
    for c in cases:
        spec = SPECS[c["spec"]]
        step = make_sharded_step(spec, device=device,
                                 **_scan_config(c["step"]))
        res = step(*_shard(c["scene"]))
        out.append({"result": res, "pairs": gather_pairs(res)})
    return out


def _queries(spec, lyr, smin, smax, q: dict) -> dict:
    box, ray, make_pick = make_queries_sharded(spec,
                                               result_cap=q["result_cap"])
    got = {"box": box(lyr, smin, smax, q["boxes"]),
           "ray": ray(lyr, smin, smax, *q["rays"], 0.0, float("inf"))}
    if "picks" not in q:
        return got
    ro, rd, max_d, name, args = q["picks"]
    pick = make_pick(DISTANCES[name])
    got["pick"] = pick(lyr, smin, smax, ro, rd, max_d,
                       tuple(torch.as_tensor(a, device=lyr.ids.device)
                             for a in args))
    return got


def drive_layer(rank, device, cases):
    """Each case: ``spec``, ``scene``, ``build`` (``make_build_sharded``'s
    configuration) and ``scan`` (``make_scan_sharded``'s), and optionally:
    ``merge`` (``scene_b`` built alike and merged in, with ``config``),
    ``queries`` (boxes, rays, picks), ``reshard`` (the gathered layer
    through ``shard_layer`` at this fragment capacity), ``br_scene`` (the
    gathered layer through a BR_SCENE round trip, a 3D scene's, then
    ``shard_layer`` and a scan), ``jax_layer`` (a JAX ``ShardedLayer``'s numpy
    fields and its ``min_depth``, through ``convert``, scanned and
    queried in place of the build)."""
    _threads(device)
    out = []
    for c in cases:
        spec = SPECS[c["spec"]]
        smin, smax = c["scene"][0], c["scene"][1]
        build = make_build_sharded(spec, device=device, **c["build"])
        scan = make_scan_sharded(spec, **_scan_config(c["scan"]))
        if "jax_layer" in c:
            fields, md = c["jax_layer"]
            lyr = convert.sharded_layer_from_jax(
                spec, fields, rank, torch.distributed.get_world_size(), md,
                device)
        else:
            lyr = build(*_shard(c["scene"]))
        res = scan(lyr)
        got = {"layer": lyr, "scan": res, "pairs": gather_pairs(res),
               "gathered": gather_layer(spec, lyr)}
        if "merge" in c:
            other = build(*_shard(c["merge"]["scene_b"]))
            merge = make_merge_sharded(spec, **c["merge"]["config"])
            got["merged"] = merge(lyr, other)
            got["merged_gathered"] = gather_layer(spec, got["merged"])
        if "queries" in c:
            got.update(_queries(spec, lyr, smin, smax, c["queries"]))
        if "reshard" in c:
            fcap = c["reshard"]
            g = got["gathered"]
            got["resharded"] = shard_layer(spec, g, fragment_capacity=fcap)
        if c.get("br_scene"):
            g = got["gathered"]
            blob = scene.dumps(scene.Scene(
                *c["scene"], layer.layer_to_scene_layer(spec, g)))
            restored = layer.layer_from_scene_layer(
                spec, scene.loads(blob).layer, capacity=g.ids.shape[0],
                device=device)
            got["restored"] = shard_layer(
                spec, restored, fragment_capacity=lyr.ids.shape[0])
            got["restored_pairs"] = gather_pairs(scan(got["restored"]))
        out.append(got)
    return out


def drive_checks(rank, device, spec_name, scene_np, jax_layer):
    """What the sharded surface refuses, on ``scene_np`` (every rank
    builds the whole scene): ``shard_layer`` of single-chip builds below
    ``min_depth_for_devices`` ("shallow"), over the fragment capacity
    ("small") and fitting ("deep"); and what runs on the card by default,
    so raises where there is none: a sharded step given host arrays and
    no device ("default") and ``convert.sharded_layer_from_jax`` of
    ``jax_layer`` (a JAX ``ShardedLayer``'s numpy fields and its
    ``min_depth``) with no device ("convert").  Returns the name of the
    exception each raised, or "ok" (for "convert", the device type of
    the fragment)."""
    _threads(device)
    spec = SPECS[spec_name]
    n_dev = world()[1]
    need = min_depth_for_devices(spec, n_dev)
    fits = layer.build(spec, *scene_np, device=device).ids.shape[0]
    out = {}
    for name, depth, fcap in (("shallow", 0, fits), ("small", need, 2),
                              ("deep", need, fits)):
        state = layer.build(spec, *scene_np, min_depth=depth, device=device)
        try:
            shard_layer(spec, state, fragment_capacity=fcap)
            out[name] = "ok"
        except ValueError as exc:
            out[name] = type(exc).__name__
    step = make_sharded_step(spec, bucket_capacity=fits, pair_capacity=fits)
    try:
        step(*_shard(scene_np))
        out["default"] = "ok"
    except RuntimeError as exc:
        out["default"] = type(exc).__name__
    try:
        lyr = convert.sharded_layer_from_jax(spec, jax_layer[0], rank, n_dev,
                                             jax_layer[1])
        out["convert"] = lyr.ids.device.type
    except RuntimeError as exc:
        out["convert"] = type(exc).__name__
    return out


def drive_update(rank, device, cases):
    """Each case: ``spec``, ``scene``, ``build`` (the tracked build's
    configuration), ``update`` (``make_update_sharded``'s) and ``frames``
    (the new global (bounds_min, bounds_max) of each frame); optionally
    ``jax_tracked`` (a JAX ``ShardedTracked``'s numpy fields and its
    ``min_depth``, through ``convert``, in place of the build).  Returns
    per frame the rank's updated tracked state and a fresh sharded build
    on the frame's bounds."""
    _threads(device)
    out = []
    for c in cases:
        spec = SPECS[c["spec"]]
        smin, smax, _, _, ids = c["scene"]
        build_cfg = dict(c["build"])
        if "jax_tracked" in c:
            fields, md = c["jax_tracked"]
            tracked = convert.sharded_tracked_from_jax(
                spec, fields, rank, torch.distributed.get_world_size(), md,
                device)
        else:
            tracked = make_build_tracked_sharded(
                spec, device=device, **build_cfg)(*_shard(c["scene"]))
        upd = make_update_sharded(spec, **c["update"])
        build = make_build_sharded(spec, device=device, **build_cfg)
        frames = []
        for bmin, bmax in c["frames"]:
            tracked = upd(tracked, smin, smax, object_shard(bmin),
                          object_shard(bmax))
            fresh = build(smin, smax, object_shard(bmin),
                          object_shard(bmax), object_shard(ids))
            frames.append({"tracked": tracked, "fresh": fresh})
        out.append({"frames": frames})
    return out
