"""Port parity: the persistent sharded layer, broadphase_tpu_torch.parallel
against broadphase_tpu.parallel (build, scan, gather_layer, shard_layer,
merge, batched queries) and against the port's single-chip layer.

The port runs as 1, 2, 3 and 4 ranks of a CPU gloo group, one spawn per
world size for every case; JAX on as many devices of the 8-device CPU
mesh.  Compared exactly: every rank's fragment lane for lane (keys, ids,
aux), the replicated counts and flags, each rank's class of pairs, the
gathered layer, the merged fragments, and the query rows and picks
(distance ties included).  Also: ``nested_ids``, ``filter_fn``, fragment
and ``result_cap`` overflow, ids either side of 2^29 - 1 (the narrow-id
gate on aux, reduced over the group), the gather / shard round trip and a
BR_SCENE
round trip of the gathered layer, and a JAX sharded layer carried across
with ``convert.sharded_layer_from_jax``.

Where the port differs from JAX on purpose, the test says so:
``gather_layer`` takes the layer's own ``min_depth`` (JAX's defaults to 0;
JAX is called with it given), ``shard_layer`` raises on a layer shallower
than ``min_depth_for_devices`` (JAX warns), and the merged fragments are
padded to ``fragment_capacity``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from broadphase_tpu import index as bidx
from broadphase_tpu import layer as jl
from broadphase_tpu import parallel as jpar
from broadphase_tpu_torch import index as tidx
from broadphase_tpu_torch import layer as tl
from broadphase_tpu_torch.parallel import run_ranks

import torch_rank_bodies as bodies
from test_torch_parallel import N, WORLDS, jax_config, mesh, scene

FCAP = 8 * N
BUILD = {"fragment_capacity": FCAP}
SCAN = {"pair_capacity": 16 * N}
RESULT_CAP = 512


def jax_distance_mod4(ids, mask):
    """``bodies.distance_mod4`` on JAX arrays."""
    return jnp.where(mask, (ids % 4).astype(jnp.float32), jnp.inf)


def _queries(spec_name, seed, result_cap=RESULT_CAP, picks=True):
    spec = getattr(bidx, spec_name)
    rng = np.random.default_rng(seed)
    Q, dim = 16, spec.dim
    qmin = rng.uniform(-60, 30, (Q, dim)).astype(np.float32)
    qmax = (qmin + rng.uniform(2, 40, (Q, dim))).astype(np.float32)
    ro = rng.uniform(-60, 60, (Q, dim)).astype(np.float32)
    rd = rng.uniform(-1, 1, (Q, dim)).astype(np.float32)
    rd[::5, 0] = 0.0                          # axis-parallel rays
    q = {"result_cap": result_cap, "boxes": (qmin, qmax), "rays": (ro, rd)}
    if picks:
        q["picks"] = (ro, rd, np.float32(1e9), "mod4", ())
    return q


def _nested_scene():
    smin, smax, bmin, bmax, ids = scene(bidx.Index64_3D, N // 2, seed=17)
    bmin2 = np.clip(bmin - 3.0, smin + 0.5, None).astype(np.float32)
    bmax2 = np.clip(bmax + 3.0, None, smax - 0.5).astype(np.float32)
    return (smin, smax, np.concatenate([bmin, bmin2]),
            np.concatenate([bmax, bmax2]), np.concatenate([ids, ids]))


def _ids_scene(top):
    """The largest ids, up to ``top``, on the last rank's object shard: a
    rank-local narrow-id gate would disagree across ranks."""
    smin, smax, bmin, bmax, _ = scene(bidx.Index64_3D, N, seed=5)
    ids = (top - np.arange(N, dtype=np.int64)[::-1]).astype(np.uint32)
    return smin, smax, bmin, bmax, ids


def _second_scene(spec_name):
    """Another N objects with ids N..2N-1 in the same system box."""
    smin, smax, bmin, bmax, _ = scene(getattr(bidx, spec_name), N, seed=29)
    return smin, smax, bmin, bmax, np.arange(N, 2 * N, dtype=np.uint32)


FULL = (3, 4)                    # the world sizes that run every case
# name: (spec, scene, build, scan, extras, world sizes); extras: "merge"
# (its configuration), "queries", "reshard", "br_scene", "from_jax"
CASES = {
    "Index64_3D": ("Index64_3D", lambda: scene(bidx.Index64_3D, N, 7), BUILD,
                   SCAN, {"merge": {}, "queries": ("Index64_3D", 19),
                          "reshard": FCAP, "br_scene": True,
                          "from_jax": True}, WORLDS),
    "Index64_2D": ("Index64_2D", lambda: scene(bidx.Index64_2D, N, 7), BUILD,
                   SCAN, {}, WORLDS),
    "Index32_2D": ("Index32_2D", lambda: scene(bidx.Index32_2D, N, 7), BUILD,
                   SCAN, {}, WORLDS),
    "Index32_2D_merge_queries": ("Index32_2D",
                                 lambda: scene(bidx.Index32_2D, N, 7), BUILD,
                                 SCAN, {"merge": {},
                                        "queries": ("Index32_2D", 23)},
                                 (4,)),
    "ids_2^29-2": ("Index64_3D", lambda: _ids_scene((1 << 29) - 2), BUILD,
                   SCAN, {}, FULL),
    "ids_2^29-1": ("Index64_3D", lambda: _ids_scene((1 << 29) - 1), BUILD,
                   SCAN, {}, FULL),
    "nested_ids": ("Index64_3D", _nested_scene, BUILD,
                   {"pair_capacity": 64 * N, "nested_ids": True}, {}, FULL),
    "filter_fn": ("Index64_3D", lambda: scene(bidx.Index64_3D, N, 13),
                  BUILD, {**SCAN, "filter": "odd_sum"}, {}, FULL),
    "fragment_overflow": ("Index64_3D", lambda: scene(bidx.Index64_3D, N, 7),
                          {"fragment_capacity": N}, SCAN,
                          {"merge": {"fragment_capacity": 64}}, FULL),
    "result_cap": ("Index64_3D", lambda: scene(bidx.Index64_3D, N, 7), BUILD,
                   SCAN, {"queries": ("Index64_3D", 31, 4)}, (4,)),
}
PARAMS = [(w, name) for name, (*_, worlds) in CASES.items()
          for w in worlds]


def _params(key):
    return [(w, n) for w, n in PARAMS if key in CASES[n][4]]


@functools.lru_cache(maxsize=None)
def scene_of(name):
    return CASES[name][1]()


@functools.lru_cache(maxsize=None)
def queries_of(name):
    args = CASES[name][4]["queries"]
    return _queries(*args[:2], *args[2:], picks=len(args) == 2)


@functools.lru_cache(maxsize=None)
def jax_fns(spec_name, world, build_items, scan_items):
    spec, m = getattr(bidx, spec_name), mesh(world)
    return (jpar.make_build_sharded(spec, m, "objects", **dict(build_items)),
            jpar.make_scan_sharded(spec, m, "objects",
                                   **jax_config(dict(scan_items))))


@functools.lru_cache(maxsize=None)
def jax_queries(spec_name, world, result_cap):
    box, ray, make_pick = jpar.make_queries_sharded(
        getattr(bidx, spec_name), mesh(world), "objects",
        result_cap=result_cap)
    return box, ray, make_pick(jax_distance_mod4)


@functools.lru_cache(maxsize=None)
def jax_merge(spec_name, world, cfg_items):
    return jpar.make_merge_sharded(getattr(bidx, spec_name), mesh(world),
                                   "objects", **dict(cfg_items))


def _fns(name, world):
    spec, _, build, scan_cfg, _, _ = CASES[name]
    return jax_fns(spec, world, tuple(sorted(build.items())),
                   tuple(sorted(scan_cfg.items())))


@functools.lru_cache(maxsize=None)
def jax_layer(name, world):
    return _fns(name, world)[0](*scene_of(name))


def fields_of(spec, lyr):
    """A JAX ShardedLayer's fields as numpy, for ``convert``."""
    return {"keys": tuple(np.asarray(c)
                          for c in bidx.sort_operands(spec, lyr.keys)),
            "ids": np.asarray(lyr.ids), "aux": np.asarray(lyr.aux),
            "counts": np.asarray(lyr.counts),
            "invalid_count": np.asarray(lyr.invalid_count),
            "overflow": np.asarray(lyr.overflow)}


def _port_case(name, world):
    spec, _, build, scan_cfg, extras, _ = CASES[name]
    c = {"spec": spec, "scene": scene_of(name), "build": build,
         "scan": scan_cfg}
    if "merge" in extras:
        c["merge"] = {"scene_b": _second_scene(spec),
                      "config": extras["merge"]}
    if "queries" in extras:
        c["queries"] = queries_of(name)
    for key in ("reshard", "br_scene"):
        if key in extras:
            c[key] = extras[key]
    return c


@pytest.fixture(scope="module")
def port_runs():
    """{world: {case name: [rank outputs]}}, one spawn per world size; the
    ``from_jax`` cases run again from the JAX layer (``name/from_jax``)."""
    runs = {}

    def get(world):
        if world not in runs:
            names = [n for n, (*_, ws) in CASES.items() if world in ws]
            cases = [_port_case(n, world) for n in names]
            for n in list(names):
                if CASES[n][4].get("from_jax"):
                    spec = getattr(bidx, CASES[n][0])
                    c = _port_case(n, world)
                    c.pop("merge"), c.pop("reshard"), c.pop("br_scene")
                    c["jax_layer"] = (fields_of(spec, jax_layer(n, world)),
                                      jpar.min_depth_for_devices(spec,
                                                                 world))
                    cases.append(c)
                    names.append(n + "/from_jax")
            out = run_ranks(bodies.drive_layer, world, "gloo", "cpu", cases)
            runs[world] = {n: [rank[i] for rank in out]
                           for i, n in enumerate(names)}
        return runs[world]

    return get


def port_keys(spec, keys):
    """The port's int64 keys (numpy) as the JAX package's host view."""
    return tidx.keys_to_numpy(getattr(tidx, spec.name), torch.as_tensor(keys))


def assert_fragments(spec, world, want, ranks, aux=True):
    """Every rank's fragment equals JAX's lanes for that device, and the
    counts and flags are replicated and equal."""
    frag = np.asarray(want.ids).shape[0] // world
    keys = bidx.keys_to_numpy(spec, want.keys).reshape(world, frag)
    ids = np.asarray(want.ids).reshape(world, frag)
    aux_w = np.asarray(want.aux).reshape(world, frag)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(
            port_keys(spec, got.keys), keys[r])
        np.testing.assert_array_equal(got.ids.astype(np.uint32), ids[r])
        if aux:
            np.testing.assert_array_equal(got.aux.astype(np.uint32),
                                          aux_w[r])
        np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
        assert int(got.invalid_count) == int(want.invalid_count)
        assert bool(got.overflow) == bool(want.overflow)


def assert_scan(world, want, ranks, key="scan"):
    lanes = np.asarray(want.pairs_a).shape[0] // world
    want_pairs = np.array(jpar.gather_pairs(want), np.uint32).reshape(-1, 2)
    for r, got in enumerate(ranks):
        res = got[key]
        cut = slice(r * lanes, (r + 1) * lanes)
        np.testing.assert_array_equal(res.pairs_a.astype(np.uint32),
                                      np.asarray(want.pairs_a)[cut])
        np.testing.assert_array_equal(res.pairs_b.astype(np.uint32),
                                      np.asarray(want.pairs_b)[cut])
        np.testing.assert_array_equal(res.shard_counts,
                                      np.asarray(want.shard_counts))
        assert int(res.total_count) == int(want.total_count)
        assert int(res.invalid_count) == int(want.invalid_count)
        assert bool(res.overflow) == bool(want.overflow)
        np.testing.assert_array_equal(got["pairs"], want_pairs)


@pytest.mark.parametrize("world,name", PARAMS)
def test_sharded_build_matches_jax(port_runs, world, name):
    spec = getattr(bidx, CASES[name][0])
    want = jax_layer(name, world)
    assert_fragments(spec, world, want,
                     [got["layer"] for got in port_runs(world)[name]])
    assert bool(want.overflow) == (name == "fragment_overflow")
    for got in port_runs(world)[name]:
        assert int(got["layer"].min_depth) == max(
            0, jpar.min_depth_for_devices(spec, world))


@pytest.mark.parametrize("world,name", PARAMS)
def test_sharded_scan_matches_jax(port_runs, world, name):
    want = _fns(name, world)[1](jax_layer(name, world))
    assert_scan(world, want, port_runs(world)[name])


@pytest.mark.parametrize("world,name", PARAMS)
def test_gather_layer_matches_jax_and_single_chip(port_runs, world, name):
    """The gathered layer equals JAX's ``gather_layer`` given the
    effective min_depth (the port takes the layer's own) and, without
    overflow, the port's single-chip build at that min_depth."""
    spec = getattr(bidx, CASES[name][0])
    tspec = getattr(tidx, spec.name)
    md = jpar.min_depth_for_devices(spec, world)
    want = jpar.gather_layer(spec, jax_layer(name, world), min_depth=md)
    wk, wi, wc = jl.tree_to_numpy(spec, want)
    single = tl.build(tspec, *scene_of(name), min_depth=md,
                      out_capacity=8 * len(scene_of(name)[4]),
                      device="cpu")
    for got in port_runs(world)[name]:
        g = got["gathered"]
        cnt = int(g.count)
        assert cnt == wc and int(g.min_depth) == md
        assert g.ids.shape[0] == np.asarray(want.ids).shape[0]
        np.testing.assert_array_equal(
            port_keys(spec, g.keys[:cnt]), wk)
        np.testing.assert_array_equal(g.ids[:cnt].astype(np.uint32), wi)
        np.testing.assert_array_equal(g.aux[:cnt].astype(np.uint32),
                                      np.asarray(want.aux)[:wc])
        assert int(g.invalid_count) == int(want.invalid_count)
        assert bool(g.overflow) == bool(want.overflow)
        if not bool(want.overflow):
            n = int(single.count)
            assert cnt == n
            np.testing.assert_array_equal(g.keys[:n], single.keys[:n])
            np.testing.assert_array_equal(g.ids[:n], single.ids[:n])
            np.testing.assert_array_equal(g.aux[:n], single.aux[:n])


@pytest.mark.parametrize("world,name", _params("merge"))
def test_sharded_merge_matches_jax(port_runs, world, name):
    """Merged fragments equal JAX's on the live lanes and the flags; the
    port's are padded to the fragment capacity.  Without overflow the
    gathered merge equals the single-chip build of both scenes."""
    spec_name = CASES[name][0]
    spec = getattr(bidx, spec_name)
    cfg = CASES[name][4]["merge"]
    build = _fns(name, world)[0]
    a = jax_layer(name, world)
    b = build(*_second_scene(spec_name))
    want = jax_merge(spec_name, world, tuple(sorted(cfg.items())))(a, b)
    ranks = port_runs(world)[name]
    tspec = getattr(tidx, spec_name)
    jfrag = np.asarray(want.ids).shape[0] // world
    out_cap = cfg.get("fragment_capacity",
                      np.asarray(a.ids).shape[0] // world * 2)
    keys = bidx.keys_to_numpy(spec, want.keys).reshape(world, jfrag)
    ids = np.asarray(want.ids).reshape(world, jfrag)
    aux = np.asarray(want.aux).reshape(world, jfrag)
    counts = np.asarray(want.counts)
    for r, got in enumerate(ranks):
        m = got["merged"]
        assert m.ids.shape[0] == out_cap
        np.testing.assert_array_equal(m.counts, counts)
        c = counts[r]
        np.testing.assert_array_equal(
            port_keys(spec, m.keys[:c]), keys[r, :c])
        np.testing.assert_array_equal(m.ids[:c].astype(np.uint32),
                                      ids[r, :c])
        np.testing.assert_array_equal(m.aux[:c].astype(np.uint32),
                                      aux[r, :c])
        assert (m.ids[c:] == 0xFFFF_FFFF).all()
        assert bool(m.overflow) == bool(want.overflow)
        assert int(m.invalid_count) == int(want.invalid_count)
    assert bool(want.overflow) == ("fragment_capacity" in cfg)
    if not bool(want.overflow):
        md = jpar.min_depth_for_devices(spec, world)
        s1, s2 = scene_of(name), _second_scene(spec_name)
        both = tuple(np.concatenate([x, y]) for x, y in zip(s1[2:], s2[2:]))
        single = tl.build(tspec, s1[0], s1[1], *both, min_depth=md,
                          device="cpu")
        n = int(single.count)
        for got in ranks:
            g = got["merged_gathered"]
            assert int(g.count) == n
            np.testing.assert_array_equal(g.keys[:n], single.keys[:n])
            np.testing.assert_array_equal(g.ids[:n], single.ids[:n])
            np.testing.assert_array_equal(g.aux[:n], single.aux[:n])


def _assert_hits(got, want):
    np.testing.assert_array_equal(got.ids.astype(np.uint32),
                                  np.asarray(want.ids))
    np.testing.assert_array_equal(got.count, np.asarray(want.count))
    np.testing.assert_array_equal(got.overflow, np.asarray(want.overflow))


@pytest.mark.parametrize("world,name", _params("queries"))
def test_sharded_queries_match_jax(port_runs, world, name):
    """Boxes, rays and picks (id-mod-4 distances: ties everywhere) equal
    JAX's sharded queries on every rank."""
    spec_name = CASES[name][0]
    q = queries_of(name)
    box, ray, pick = jax_queries(spec_name, world, q["result_cap"])
    lyr = jax_layer(name, world)
    smin, smax = scene_of(name)[:2]
    want_box = box(lyr, smin, smax, q["boxes"])
    want_ray = ray(lyr, smin, smax, *q["rays"], 0.0, np.inf)
    if q["result_cap"] < RESULT_CAP:
        assert np.asarray(want_box.overflow).any()
    for got in port_runs(world)[name]:
        _assert_hits(got["box"], want_box)
        _assert_hits(got["ray"], want_ray)
    if "picks" not in q:
        return
    ro, rd, md, _, _ = q["picks"]
    want = pick(lyr, smin, smax, ro, rd, md)
    assert np.asarray(want.found).any()
    for got in port_runs(world)[name]:
        p = got["pick"]
        np.testing.assert_array_equal(p.obj_id.astype(np.uint32),
                                      np.asarray(want.obj_id))
        np.testing.assert_array_equal(p.distance, np.asarray(want.distance))
        np.testing.assert_array_equal(p.found, np.asarray(want.found))
        np.testing.assert_array_equal(p.overflow,
                                      np.asarray(want.overflow))


@pytest.mark.parametrize("world,name", _params("reshard"))
def test_gather_shard_round_trip(port_runs, world, name):
    """``shard_layer`` of the gathered layer gives back every rank's
    fragment, and equals JAX's ``shard_layer`` lane for lane."""
    spec = getattr(bidx, CASES[name][0])
    md = jpar.min_depth_for_devices(spec, world)
    st = jpar.gather_layer(spec, jax_layer(name, world), min_depth=md)
    want = jpar.shard_layer(spec, st, world,
                            fragment_capacity=CASES[name][4]["reshard"])
    ranks = port_runs(world)[name]
    assert_fragments(spec, world, want, [g["resharded"] for g in ranks])
    for got in ranks:
        for f in ("keys", "ids", "aux", "counts"):
            np.testing.assert_array_equal(getattr(got["resharded"], f),
                                          getattr(got["layer"], f))
        assert int(got["resharded"].min_depth) == md


@pytest.mark.parametrize("world,name", _params("br_scene"))
def test_br_scene_round_trip(port_runs, world, name):
    """The gathered layer through BR_SCENE and back through
    ``shard_layer`` holds the same fragments (BR_SCENE keeps no aux: the
    restore recomputes it) and scans to JAX's pairs."""
    spec = getattr(bidx, CASES[name][0])
    want = _fns(name, world)[1](jax_layer(name, world))
    want_pairs = np.array(jpar.gather_pairs(want), np.uint32).reshape(-1, 2)
    for got in port_runs(world)[name]:
        for f in ("keys", "ids", "aux", "counts"):
            np.testing.assert_array_equal(getattr(got["restored"], f),
                                          getattr(got["layer"], f))
        np.testing.assert_array_equal(got["restored_pairs"], want_pairs)
    assert spec.dim == 3


@pytest.mark.parametrize("world,name", _params("from_jax"))
def test_convert_sharded_layer_from_jax(port_runs, world, name):
    """Ranks made from a JAX sharded layer by ``convert`` hold its
    fragments, and scan and query exactly as it does."""
    spec = getattr(bidx, CASES[name][0])
    lyr = jax_layer(name, world)
    ranks = port_runs(world)[name + "/from_jax"]
    assert_fragments(spec, world, lyr, [g["layer"] for g in ranks])
    assert_scan(world, _fns(name, world)[1](lyr), ranks)
    built = port_runs(world)[name]
    for got, ref in zip(ranks, built):
        for kind in ("box", "ray"):
            for f in ("ids", "count", "overflow"):
                np.testing.assert_array_equal(getattr(got[kind], f),
                                              getattr(ref[kind], f))
        for f in ("obj_id", "distance", "found"):
            np.testing.assert_array_equal(getattr(got["pick"], f),
                                          getattr(ref["pick"], f))


def test_shard_layer_raises_where_jax_warns():
    """A layer shallower than ``min_depth_for_devices`` is refused (JAX's
    ``shard_layer`` only warns), as is a fragment over capacity; and a
    step given host arrays and no device, and a JAX sharded layer carried
    across by ``convert`` with no device, run on the card, so they raise
    without one."""
    spec = bidx.Index64_3D
    jax_fields = (fields_of(spec, jax_layer("Index64_3D", 2)),
                  jpar.min_depth_for_devices(spec, 2))
    out = run_ranks(bodies.drive_checks, 2, "gloo", "cpu",
                    "Index64_3D", scene(spec, N, 7), jax_fields)
    card = torch.cuda.is_available()
    for got in out:
        assert got == {"shallow": "ValueError", "small": "ValueError",
                       "deep": "ok",
                       "default": "ok" if card else "RuntimeError",
                       "convert": "cuda" if card else "RuntimeError"}
