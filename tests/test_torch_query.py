"""Port parity for the linear query engines: broadphase_tpu_torch.query
against broadphase_tpu.query's linear engine, on trees built by each
package (the JAX tree carried across with ``convert``).

Hit lists (ids, count, overflow) and pick results (found, id, distance)
are compared exactly: tolerance 0, distances equal as f32.  The pick
distances come from one numpy f32 table per ray, gathered by id in both
packages, so that both rank the same numbers; the tie scenes make every
candidate's distance equal, so the winner is the reference's DFS visit
order (the scenes of tests/test_query.py).  Also: the f32 cell replay and
the ray intervals bit for bit, max_depth cutoffs, misses, result_cap
overflow, an overflowed tree's flag, and the engine argument (both
engines, the 32,768-lane switch and BROADPHASE_QUERY_ENGINE).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from broadphase_tpu import geom as jgeom
from broadphase_tpu import index as bidx
from broadphase_tpu import layer as jl
from broadphase_tpu import query as jq
from broadphase_tpu_torch import convert
from broadphase_tpu_torch import geom as tgeom
from broadphase_tpu_torch import index as tidx
from broadphase_tpu_torch import layer as tl
from broadphase_tpu_torch import query as tq

from test_torch_index import SPEC_IDS, SPEC_PAIRS, random_keys
from test_torch_layer import _jax_fields

def _scene(spec, n, seed, lo=-50.0, hi=50.0, shuffle_ids=False):
    """tests/test_query.py's scene; shuffled sparse ids where the tie
    scenes need first-visited and lowest-id to disagree."""
    rng = np.random.default_rng(seed)
    dim = spec.dim
    size = rng.uniform(0.5, 8.0, size=(n, dim)).astype(np.float32)
    bmin = rng.uniform(lo, hi - 8.0, size=(n, dim)).astype(np.float32)
    bmax = bmin + size
    ids = np.arange(n, dtype=np.uint32)
    if shuffle_ids:
        ids = np.sort(rng.choice(100_000, n, replace=False).astype(np.uint32))
        rng.shuffle(ids)
    smin = np.full(dim, lo, np.float32)
    smax = np.full(dim, hi, np.float32)
    return smin, smax, bmin, bmax, ids


def _layers(spec, tspec, scene, built_by, min_depth=0, out_capacity=None):
    """(JAX layer, port layer) of one tree, built by ``built_by``."""
    jst = jl.build(spec, *scene, min_depth=min_depth,
                   out_capacity=out_capacity)
    if built_by == "jax":
        return jst, convert.layer_state_from_jax(tspec, _jax_fields(spec,
                                                                    jst))
    return jst, tl.build(tspec, *scene, min_depth=min_depth,
                         out_capacity=out_capacity, device="cpu")


def _assert_same_hits(jres, tres):
    assert int(tres.count) == int(jres.count)
    assert bool(tres.overflow) == bool(jres.overflow)
    np.testing.assert_array_equal(tres.ids.numpy().astype(np.uint32),
                                  np.asarray(jres.ids))


def _assert_same_pick(jres, tres):
    assert bool(tres.found) == bool(jres.found)
    assert int(tres.obj_id) == int(jres.obj_id)
    assert bool(tres.overflow) == bool(jres.overflow)
    assert tres.distance.dtype == torch.float32
    np.testing.assert_array_equal(tres.distance.numpy(),
                                  np.asarray(jres.distance))


# ---------------------------------------------------------------------------
# The f32 replay, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,tspec", SPEC_PAIRS, ids=SPEC_IDS)
def test_cell_bounds_and_ray_intervals_bitwise(spec, tspec):
    origin, depth = random_keys(spec, 3000, seed=5)
    keys_j = bidx.make_key(spec, [jnp.asarray(o) for o in origin],
                           jnp.asarray(depth))
    cols = [np.asarray(c) for c in bidx.sort_operands(spec, keys_j)]
    keys_t = tidx.key_from_columns(tspec, cols)
    smin = np.full(spec.dim, -37.25, np.float32)
    smax = np.full(spec.dim, 91.5, np.float32)
    for replay in (None, 3):
        jmin, jmax = jgeom.cell_bounds_f32(
            spec, bidx.origin_of(spec, keys_j), bidx.depth_of(spec, keys_j),
            smin, smax, replay_depth=replay)
        tmin, tmax = tgeom.cell_bounds_f32(
            tspec, tidx.origin_of(tspec, keys_t),
            tidx.depth_of(tspec, keys_t), smin, smax, replay_depth=replay)
        np.testing.assert_array_equal(tmin.numpy(), np.asarray(jmin))
        np.testing.assert_array_equal(tmax.numpy(), np.asarray(jmax))
    rng = np.random.default_rng(8)
    for rd in (rng.normal(size=spec.dim), np.eye(spec.dim)[0],
               -np.eye(spec.dim)[-1], np.array([-0.0] + [1.0] *
                                               (spec.dim - 1))):
        ro = rng.uniform(-40, 80, spec.dim).astype(np.float32)
        rd = rd.astype(np.float32)
        for lo, hi, md in ((0.0, np.inf, None), (3.0, 60.0, 4)):
            jr = jq.ray_intervals_keys(spec, keys_j, smin, smax, ro, rd, lo,
                                       hi, md)
            tr = tq.ray_intervals_keys(tspec, keys_t, smin, smax, ro, rd,
                                       lo, hi, md)
            for t, j in zip(tr, jr):
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ---------------------------------------------------------------------------
# test_box / test_ray / test
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,tspec", SPEC_PAIRS, ids=SPEC_IDS)
@pytest.mark.parametrize("max_depth", [None, 3])
@pytest.mark.parametrize("built_by", ["jax", "port"])
def test_test_box_matches_jax(spec, tspec, max_depth, built_by):
    scene = _scene(spec, 300, seed=11)
    jst, tst = _layers(spec, tspec, scene, built_by)
    rng = np.random.default_rng(5)
    boxes = []
    for _ in range(3):
        qmin = rng.uniform(-50, 30, spec.dim).astype(np.float32)
        boxes.append((qmin, qmin + rng.uniform(1, 25, spec.dim).astype(
            np.float32)))
    boxes.append((np.full(spec.dim, 60.0, np.float32),      # a miss
                  np.full(spec.dim, 70.0, np.float32)))
    for qb in boxes:
        _, jres = jq.test_box(spec, jst, scene[0], scene[1], qb, 512,
                              max_depth, engine="linear")
        _, tres = tq.test_box(tspec, tst, scene[0], scene[1], qb, 512,
                              max_depth)
        _assert_same_hits(jres, tres)
    assert int(tres.count) == 0


@pytest.mark.parametrize("spec,tspec", SPEC_PAIRS, ids=SPEC_IDS)
@pytest.mark.parametrize("max_depth", [None, 4])
def test_test_ray_matches_jax(spec, tspec, max_depth):
    scene = _scene(spec, 300, seed=13)
    jst, tst = _layers(spec, tspec, scene, "port")
    rng = np.random.default_rng(6)
    for trial in range(6):
        origin = rng.uniform(-45, 45, spec.dim).astype(np.float32)
        direction = rng.normal(size=spec.dim).astype(np.float32)
        lo, hi = (0.0, np.inf) if trial < 4 else (5.0, 30.0)
        if trial == 2:
            direction[0] = 0.0          # axis-parallel
        if trial == 3:
            direction = np.zeros(spec.dim, np.float32)
            direction[-1] = -1.0        # exactly axis-aligned, negative
        _, jres = jq.test_ray(spec, jst, scene[0], scene[1], origin,
                              direction, lo, hi, 512, max_depth,
                              engine="linear")
        _, tres = tq.test_ray(tspec, tst, scene[0], scene[1], origin,
                              direction, lo, hi, 512, max_depth)
        _assert_same_hits(jres, tres)
    # a ray that leaves the system box: a miss
    _, tres = tq.test_ray(tspec, tst, scene[0], scene[1],
                          np.full(spec.dim, 49.0, np.float32),
                          np.ones(spec.dim, np.float32), 0.0, np.inf, 512)
    _, jres = jq.test_ray(spec, jst, scene[0], scene[1],
                          np.full(spec.dim, 49.0, np.float32),
                          np.ones(spec.dim, np.float32), 0.0, np.inf, 512,
                          engine="linear")
    _assert_same_hits(jres, tres)


@pytest.mark.parametrize("query", ["box", "ray"])
def test_result_cap_overflow(query):
    """Fewer result slots than hits: the first ids, count capped,
    overflow set."""
    spec, tspec = SPEC_PAIRS[2]
    scene = _scene(spec, 300, seed=11)
    jst, tst = _layers(spec, tspec, scene, "port")
    args = {"box": ((np.full(3, -40.0, np.float32),
                     np.full(3, 20.0, np.float32)), 7),
            "ray": (np.full(3, -45.0, np.float32),
                    np.ones(3, np.float32), 0.0, np.inf, 7)}[query]
    jfn, tfn = {"box": (jq.test_box, tq.test_box),
                "ray": (jq.test_ray, tq.test_ray)}[query]
    _, jres = jfn(spec, jst, scene[0], scene[1], *args, engine="linear")
    _, tres = tfn(tspec, tst, scene[0], scene[1], *args)
    _assert_same_hits(jres, tres)
    assert bool(tres.overflow) and int(tres.count) == 7


def test_overflowed_tree_flags_every_query():
    spec, tspec = SPEC_PAIRS[2]
    scene = _scene(spec, 300, seed=11)
    jst, tst = _layers(spec, tspec, scene, "jax", out_capacity=200)
    assert bool(tst.overflow)
    qb = (np.full(3, -10.0, np.float32), np.full(3, 10.0, np.float32))
    _, jres = jq.test_box(spec, jst, scene[0], scene[1], qb, 512,
                          engine="linear")
    _, tres = tq.test_box(tspec, tst, scene[0], scene[1], qb, 512)
    _assert_same_hits(jres, tres)
    assert bool(tres.overflow)

    def get_dist(ids, mask):
        return torch.where(mask, 1.0, torch.inf)

    _, pres = tq.pick_ray(tspec, tst, scene[0], scene[1],
                          np.zeros(3, np.float32), np.ones(3, np.float32),
                          1e9, get_dist)
    assert bool(pres.overflow)


@pytest.mark.parametrize("spec,tspec", SPEC_PAIRS, ids=SPEC_IDS)
def test_generic_test_and_pick_match_jax(spec, tspec):
    """query.test with a box predicate, and query.pick with a distance of
    the replayed cell's min corner from a point (ties broken by id)."""
    scene = _scene(spec, 150, seed=29)
    jst, tst = _layers(spec, tspec, scene, "jax")
    qmin = np.full(spec.dim, -10.0, np.float32)
    qmax = np.full(spec.dim, 15.0, np.float32)

    def should_test_j(cmin, cmax, lo, hi):
        return jnp.all((cmin <= hi[None, :]) & (cmax >= lo[None, :]),
                       axis=-1)

    def should_test_t(cmin, cmax, lo, hi):
        return torch.all((cmin <= hi[None, :]) & (cmax >= lo[None, :]),
                         dim=-1)

    _, jres = jq.test(spec, jst, scene[0], scene[1], should_test_j,
                      (jnp.asarray(qmin), jnp.asarray(qmax)), 512, 4)
    _, tres = tq.test(tspec, tst, scene[0], scene[1], should_test_t,
                      (torch.as_tensor(qmin), torch.as_tensor(qmax)), 512, 4)
    _assert_same_hits(jres, tres)
    assert int(tres.count) > 0

    point = np.full(spec.dim, 3.0, np.float32)

    def dist_j(ids, cmin, cmax, mask, p):
        return jnp.max(jnp.abs(cmin - p[None, :]), axis=-1)

    def dist_t(ids, cmin, cmax, mask, p):
        return torch.amax(torch.abs(cmin - p[None, :]), dim=-1)

    for md in (np.inf, 20.0, 0.5):
        _, jres = jq.pick(spec, jst, scene[0], scene[1], dist_j, md,
                          (jnp.asarray(point),))
        _, tres = tq.pick(tspec, tst, scene[0], scene[1], dist_t, md,
                          (torch.as_tensor(point),))
        _assert_same_pick(jres, tres)
    assert not bool(tres.found)


# ---------------------------------------------------------------------------
# pick_ray
# ---------------------------------------------------------------------------

def _sphere_table(scene, origin, direction):
    """Each object's exact ray-sphere distance (f32, inf on a miss), as a
    table by id: both packages gather the same numbers."""
    _, _, bmin, bmax, ids = scene
    centers = (bmin + bmax) / 2.0
    radii = np.min(bmax - bmin, axis=1) / 2.0
    dn = direction / np.linalg.norm(direction)
    c = centers - origin
    t = c @ dn
    d2 = np.sum(c * c, axis=1) - t * t
    r2 = radii.astype(np.float64) ** 2
    root = np.sqrt(np.maximum(r2 - d2, 0.0))
    hit = (d2 <= r2) & (t + root >= 0)
    table = np.full(int(ids.max()) + 1, np.inf, np.float32)
    table[ids] = np.where(hit, t - root, np.inf).astype(np.float32)
    return table


def _get_dist_jax(ids, mask, table):
    return jnp.where(mask, table[jnp.where(mask, ids, 0)], jnp.inf)


def _get_dist_torch(ids, mask, table):
    return torch.where(mask, table[torch.where(mask, ids, 0)], torch.inf)


@pytest.mark.parametrize("spec,tspec", SPEC_PAIRS, ids=SPEC_IDS)
@pytest.mark.parametrize("built_by", ["jax", "port"])
def test_pick_ray_matches_jax(spec, tspec, built_by):
    scene = _scene(spec, 200, seed=17)
    jst, tst = _layers(spec, tspec, scene, built_by)
    centers = (scene[2] + scene[3]) / 2.0
    rng = np.random.default_rng(23)
    hits = 0
    for trial in range(8):
        origin = rng.uniform(-45, 45, spec.dim).astype(np.float32)
        if trial % 2 == 0:      # aim at an object's center: rays that hit
            direction = (centers[rng.integers(200)] - origin).astype(
                np.float32)
        else:
            direction = rng.normal(size=spec.dim).astype(np.float32)
        table = _sphere_table(scene, origin, direction)
        md = np.float32(1e9 if trial != 6 else 3.0)
        _, jres = jq.pick_ray(spec, jst, scene[0], scene[1], origin,
                              direction, md, _get_dist_jax,
                              (jnp.asarray(table),), engine="linear")
        _, tres = tq.pick_ray(tspec, tst, scene[0], scene[1], origin,
                              direction, md, _get_dist_torch,
                              (torch.as_tensor(table),))
        _assert_same_pick(jres, tres)
        hits += bool(tres.found)
    assert 0 < hits < 8


@pytest.mark.parametrize("spec,tspec", SPEC_PAIRS, ids=SPEC_IDS)
@pytest.mark.parametrize("const,max_depth", [(0.0, None), (17.0, None),
                                             (17.0, 3)])
def test_pick_ray_ties_match_jax(spec, tspec, const, max_depth):
    """Every candidate at one distance: the winner is the first visited
    (tests/test_query.py::test_pick_ray_distance_tie_matches_traversal_
    order): sign flips, |axis| ties and an axis-parallel direction."""
    scene = _scene(spec, 150, seed=23, shuffle_ids=True)
    jst, tst = _layers(spec, tspec, scene, "port")
    rng = np.random.default_rng(3)

    def dist_j(ids, mask):
        return jnp.where(mask, jnp.float32(const), jnp.inf)

    def dist_t(ids, mask):
        return torch.where(mask, const, torch.inf)

    dirs = [rng.normal(size=spec.dim).astype(np.float32) for _ in range(3)]
    dirs.append(np.ones(spec.dim, np.float32))
    d_neg = -np.ones(spec.dim, np.float32)
    d_neg[-1] = 1.0
    dirs.append(d_neg)
    d_par = np.zeros(spec.dim, np.float32)
    d_par[0] = 1.0
    dirs.append(d_par)
    found = 0
    for direction in dirs:
        origin = rng.uniform(-45, 45, spec.dim).astype(np.float32)
        _, jres = jq.pick_ray(spec, jst, scene[0], scene[1], origin,
                              direction, np.float32(1e9), dist_j,
                              max_depth=max_depth, engine="linear")
        _, tres = tq.pick_ray(tspec, tst, scene[0], scene[1], origin,
                              direction, np.float32(1e9), dist_t,
                              max_depth=max_depth)
        _assert_same_pick(jres, tres)
        found += bool(tres.found)
    assert found >= 3


def test_engine_argument(monkeypatch):
    """None, "auto", "linear" and "tree" give JAX's result; the engine
    switches to the tree at 32,768 lanes and honours
    BROADPHASE_QUERY_ENGINE, as broadphase_tpu.query._engine does; an
    unknown engine raises."""
    spec, tspec = SPEC_PAIRS[2]
    scene = _scene(spec, 50, seed=1)
    jst, tst = _layers(spec, tspec, scene, "port")
    qb = (np.full(3, -10.0, np.float32), np.full(3, 10.0, np.float32))
    ro, rd = np.full(3, -40.0, np.float32), np.ones(3, np.float32)
    table = _sphere_table(scene, ro, rd)
    _, jbox = jq.test_box(spec, jst, scene[0], scene[1], qb, 64,
                          engine="linear")
    _, jray = jq.test_ray(spec, jst, scene[0], scene[1], ro, rd, 0.0,
                          np.inf, 64, engine="linear")
    _, jpick = jq.pick_ray(spec, jst, scene[0], scene[1], ro, rd, 1e9,
                           _get_dist_jax, (jnp.asarray(table),),
                           engine="linear")
    assert int(jbox.count) > 0 and int(jray.count) > 0
    for engine in (None, "auto", "linear", "tree"):
        _assert_same_hits(jbox, tq.test_box(tspec, tst, scene[0], scene[1],
                                            qb, 64, engine=engine)[1])
        _assert_same_hits(jray, tq.test_ray(tspec, tst, scene[0], scene[1],
                                            ro, rd, 0.0, np.inf, 64,
                                            engine=engine)[1])
        _assert_same_pick(jpick, tq.pick_ray(
            tspec, tst, scene[0], scene[1], ro, rd, 1e9, _get_dist_torch,
            (torch.as_tensor(table),), engine=engine)[1])
    monkeypatch.delenv("BROADPHASE_QUERY_ENGINE", raising=False)
    for cap in (8, 32767, 32768, 1 << 20):
        want = jq._engine(None, cap)
        assert tq._engine(None, cap) == want
        assert want == ("tree" if cap >= 32768 else "linear")
    for env in ("tree", "linear", "auto"):
        monkeypatch.setenv("BROADPHASE_QUERY_ENGINE", env)
        for cap in (8, 1 << 20):
            assert tq._engine(None, cap) == jq._engine(None, cap)
            assert tq._engine("linear", cap) == "linear"
    with pytest.raises(ValueError, match="unknown query engine"):
        tq.test_box(tspec, tst, scene[0], scene[1], qb, 64, engine="bvh")
    monkeypatch.setenv("BROADPHASE_QUERY_ENGINE", "bvh")
    with pytest.raises(ValueError, match="unknown query engine"):
        tq._engine(None, 8)


def test_queries_sort_an_unsorted_layer():
    """A layer from extend is sorted first, as in the JAX package."""
    spec, tspec = SPEC_PAIRS[2]
    smin, smax, bmin, bmax, ids = _scene(spec, 200, seed=4)
    tst = tl.extend(tspec, tl.make_layer(tspec, 1600, device="cpu"),
                    smin, smax, bmin, bmax, ids)
    assert not bool(tst.sorted)
    qb = (np.full(3, -20.0, np.float32), np.full(3, 5.0, np.float32))
    sst, got = tq.test_box(tspec, tst, smin, smax, qb, 256)
    assert bool(sst.sorted)
    jst = jl.build(spec, smin, smax, bmin, bmax, ids)
    _, want = jq.test_box(spec, jst, smin, smax, qb, 256, engine="linear")
    _assert_same_hits(want, got)
