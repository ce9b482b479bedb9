"""Port parity for the generic traversals: broadphase_tpu_torch.traverse
against broadphase_tpu.traverse.

Tolerance 0: ids, counts and overflow flags; pick ids and f32 distances.
The cases of tests/test_traverse.py (the breadth-first walk with a
monotone box predicate against test_box, the non-monotone extent bands,
a root that fails, a max_depth cutoff, pick_generic, frontier overflow)
and of tests/test_pick_ordered.py (box and ray geometries with an
inconsistent id-hash distance, a distance read from the visiting cell,
max_depth, a constant distance where every candidate ties, the "weird"
geometry with a depth-permuted test_order and a nearest-dependent
should_test, stack overflow, empty layers and misses, a min_depth tree,
the id_bound fast path, a truncated tree, and one identical cluster).
Trees share one capacity so that JAX compiles each walk once per spec and
callback set.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from broadphase_tpu import traverse as jtr
from broadphase_tpu_torch import layer as tl
from broadphase_tpu_torch import query as tq
from broadphase_tpu_torch import traverse as ttr

from test_torch_index import SPEC_PAIRS
from test_torch_query import _assert_same_hits as assert_same_hits
from test_torch_query import _assert_same_pick as assert_same_pick
from test_torch_query import _scene as scene
from test_torch_singleq import jax_built, port_built

S32, S64_2, S64_3 = SPEC_PAIRS


def _system(dim):
    return np.full(dim, -50.0, np.float32), np.full(dim, 50.0, np.float32)


# ---------------------------------------------------------------------------
# Breadth-first walk: test_generic, pick_generic
# ---------------------------------------------------------------------------

def _band_jax(qmin, qmax, lo_e, hi_e, gap=False):
    """Overlap and an extent band (tests/test_traverse.py); with ``gap``,
    cells right of x = 0 pass the band whatever their extent, so left of
    it the walk prunes cells of middle size whose small descendants would
    pass their own test."""
    qmin, qmax = jnp.asarray(qmin), jnp.asarray(qmax)

    def should_test(gstate):
        cmin, cmax = gstate
        overlap = jnp.all((cmin <= qmax) & (cmax >= qmin), axis=-1)
        ext = jnp.max(cmax - cmin, axis=-1)
        band = (ext >= lo_e) & (ext <= hi_e)
        if gap:
            band = band | (cmin[..., 0] >= 0.0)
        return overlap & band

    return should_test


def _band_torch(qmin, qmax, lo_e, hi_e, gap=False):
    qmin, qmax = torch.as_tensor(qmin), torch.as_tensor(qmax)

    def should_test(gstate):
        cmin, cmax = gstate
        overlap = torch.all((cmin <= qmax) & (cmax >= qmin), dim=-1)
        ext = torch.amax(cmax - cmin, dim=-1)
        band = (ext >= lo_e) & (ext <= hi_e)
        if gap:
            band = band | (cmin[..., 0] >= 0.0)
        return overlap & band

    return should_test


@pytest.fixture(scope="module")
def trees():
    """One 250-object tree per spec (seed 37), built by JAX."""
    return {spec.name: jax_built(spec, tspec, scene(spec, 250, seed=37))
            for spec, tspec in SPEC_PAIRS}


@pytest.mark.parametrize("pair", [S64_3, S32], ids=lambda p: p[0].name)
@pytest.mark.parametrize("band", [(-1.0, 1e9, False), (0.0, 30.0, False),
                                  (40.0, 1e9, True)],
                         ids=["monotone", "band0-30", "gap"])
def test_generic_matches_jax(trees, pair, band):
    """Non-monotone extent bands prune descendants that would pass (the
    0-30 band fails at the root, so nothing passes); with the band off
    the walk equals test_box."""
    spec, tspec = pair
    jst, tst = trees[spec.name]
    smin, smax = _system(spec.dim)
    rng = np.random.default_rng(4)
    qmin = rng.uniform(-50, 10, spec.dim).astype(np.float32)
    qmax = qmin + rng.uniform(10, 40, spec.dim).astype(np.float32)
    if band[2]:                 # straddle x = 0
        qmin[0], qmax[0] = -15.0, 15.0
    jroot, jsub = jtr.box_halving_state(spec, smin, smax)
    troot, tsub = ttr.box_halving_state(tspec, smin, smax)
    _, jres = jtr.test_generic(spec, jst, jroot, jsub,
                               _band_jax(qmin, qmax, *band), 1024)
    _, tres = ttr.test_generic(tspec, tst, troot, tsub,
                               _band_torch(qmin, qmax, *band), 1024)
    assert_same_hits(jres, tres)
    assert not bool(tres.overflow)
    _, box = tq.test_box_linear(tspec, tst, smin, smax, (qmin, qmax), 1024)
    if band[0] < 0:
        assert torch.equal(box.ids, tres.ids)
    elif band[2]:           # pruned: fewer than the box, but some
        assert 0 < int(tres.count) < int(box.count)
    else:
        assert int(tres.count) == 0


def test_generic_root_fails_and_max_depth(trees):
    spec, tspec = S64_3
    jst, tst = trees[spec.name]
    smin, smax = _system(3)
    troot, tsub = ttr.box_halving_state(tspec, smin, smax)
    # the root's extent is 100: a band of 0-10 prunes everything, which
    # the monotone engine would not
    _, tres = ttr.test_generic(tspec, tst, troot, tsub,
                               _band_torch(smin, smax, 0.0, 10.0), 1024)
    assert int(tres.count) == 0
    _, mono = tq.test(tspec, tst, smin, smax,
                      lambda cmin, cmax: torch.amax(cmax - cmin, dim=-1)
                      <= 10.0, result_cap=1024)
    assert int(mono.count) > 0
    # max_depth 3: the slices left at depth 3 report whole
    qmin = np.full(3, -20.0, np.float32)
    qmax = qmin + 25.0
    jroot, jsub = jtr.box_halving_state(spec, smin, smax)
    _, jres = jtr.test_generic(spec, jst, jroot, jsub,
                               _band_jax(qmin, qmax, -1.0, 1e9), 1024,
                               max_depth=3)
    _, tres = ttr.test_generic(tspec, tst, troot, tsub,
                               _band_torch(qmin, qmax, -1.0, 1e9), 1024,
                               max_depth=3)
    assert_same_hits(jres, tres)
    _, box = tq.test_box_linear(tspec, tst, smin, smax, (qmin, qmax), 1024,
                                max_depth=3)
    assert torch.equal(box.ids, tres.ids)


def test_generic_frontier_overflow_matches_jax(trees):
    spec, tspec = S64_3
    jst, tst = trees[spec.name]
    smin, smax = _system(3)
    jroot, jsub = jtr.box_halving_state(spec, smin, smax)
    troot, tsub = ttr.box_halving_state(tspec, smin, smax)
    _, jres = jtr.test_generic(spec, jst, jroot, jsub,
                               _band_jax(smin, smax, -1.0, 1e9), 1024, 8)
    _, tres = ttr.test_generic(tspec, tst, troot, tsub,
                               _band_torch(smin, smax, -1.0, 1e9), 1024, 8)
    assert bool(tres.overflow)
    assert_same_hits(jres, tres)


def test_pick_generic_matches_jax(trees):
    spec, tspec = S64_3
    jst, tst = trees[spec.name]
    smin, smax = _system(3)
    jroot, jsub = jtr.box_halving_state(spec, smin, smax)
    troot, tsub = ttr.box_halving_state(tspec, smin, smax)

    def dist_jax(ids, mask):
        return jnp.where(mask, (ids % 97).astype(jnp.float32) * 0.5, jnp.inf)

    def dist_torch(ids, mask):
        return torch.where(mask, (ids % 97).to(torch.float32) * 0.5,
                           torch.inf)

    for md in (1e9, 0.0):
        _, jres = jtr.pick_generic(spec, jst, jroot, jsub,
                                   _band_jax(smin, smax, -1.0, 1e9),
                                   dist_jax, max_distance=md)
        _, tres = ttr.pick_generic(tspec, tst, troot, tsub,
                                   _band_torch(smin, smax, -1.0, 1e9),
                                   dist_torch, max_distance=md)
        assert_same_pick(jres, tres)
    assert not bool(tres.found)


# ---------------------------------------------------------------------------
# Ordered pick
# ---------------------------------------------------------------------------

def _mix_gd_jax(gstate, nearest, oid, k, c):
    """k * (id hash) + c: an inconsistent distance, or a constant one
    (every candidate ties) with k = 0."""
    h = ((oid * jnp.uint32(2654435761)) % jnp.uint32(4096)).astype(
        jnp.float32) / jnp.float32(16.0)
    return h * k + c


def _mix_gd_torch(gstate, nearest, oid, k, c):
    h = ((oid * 2654435761) % 4096).to(torch.float32) / 16.0
    return h * k + c


def _mix_ray_jax(nearest, oid, k, c):
    return _mix_gd_jax(None, nearest, oid, k, c)


def _mix_ray_torch(nearest, oid, k, c):
    return _mix_gd_torch(None, nearest, oid, k, c)


def _args(k, c):
    return ((jnp.float32(k), jnp.float32(c)),
            (torch.tensor(k, dtype=torch.float32),
             torch.tensor(c, dtype=torch.float32)))


@pytest.mark.parametrize("pair", SPEC_PAIRS, ids=lambda p: p[0].name)
def test_pick_ordered_box_matches_jax(trees, pair):
    spec, tspec = pair
    jst, tst = trees[spec.name]
    smin, smax = _system(spec.dim)
    rng = np.random.default_rng(7)
    found = 0
    for trial in range(4):
        qmin = rng.uniform(-50, 20, spec.dim).astype(np.float32)
        qmax = qmin + rng.uniform(5, 40, spec.dim).astype(np.float32)
        ja, ta = _args(0.0 if trial == 3 else 1.0, 2.5)
        jr = jtr.box_pick_state(spec, smin, smax, qmin, qmax)
        tr = ttr.box_pick_state(tspec, smin, smax, qmin, qmax)
        _, jres = jtr.pick_ordered(spec, jst, *jr, _mix_gd_jax,
                                   max_distance=1e9, get_dist_args=ja)
        _, tres = ttr.pick_ordered(tspec, tst, *tr, _mix_gd_torch,
                                   max_distance=1e9, get_dist_args=ta)
        assert_same_pick(jres, tres)
        found += bool(tres.found)
    assert found >= 2


@pytest.mark.parametrize("pair", [S32, S64_3], ids=lambda p: p[0].name)
def test_pick_ray_ordered_matches_jax(trees, pair):
    """Random rays (one axis-parallel), the id-hash distance and, on the
    last ray, a constant one (every candidate ties); the hit point too."""
    spec, tspec = pair
    jst, tst = trees[spec.name]
    smin, smax = _system(spec.dim)
    rng = np.random.default_rng(9)
    hits = 0
    for trial in range(5):
        ro = rng.uniform(-45, 45, spec.dim).astype(np.float32)
        rd = rng.normal(size=spec.dim).astype(np.float32)
        if trial == 0:
            rd[0] = 0.0
        ja, ta = _args(0.0 if trial == 4 else 1.0, 1.0)
        _, jres, jpt = jtr.pick_ray_ordered(spec, jst, smin, smax, ro, rd,
                                            1e9, _mix_ray_jax, ja)
        _, tres, tpt = ttr.pick_ray_ordered(tspec, tst, smin, smax, ro, rd,
                                            1e9, _mix_ray_torch, ta)
        assert_same_pick(jres, tres)
        np.testing.assert_array_equal(tpt.numpy(), np.asarray(jpt))
        hits += bool(tres.found)
    assert hits >= 2


def _range_gd_jax(gstate, nearest, oid, k, c):
    return gstate[2][0] + _mix_gd_jax(None, nearest, oid, k, c)


def _range_gd_torch(gstate, nearest, oid, k, c):
    return gstate[2][0] + _mix_gd_torch(None, nearest, oid, k, c)


@pytest.mark.parametrize("max_depth", [None, 3])
def test_pick_ordered_first_visit_geometry(trees, max_depth):
    """The distance reads the visiting cell's sub-ray entry: equal only if
    the visit order and the once-per-id processed map are."""
    spec, tspec = S64_3
    jst, tst = trees[spec.name]
    smin, smax = _system(3)
    rng = np.random.default_rng(11)
    hits = 0
    ja, ta = _args(1.0, 0.0)
    for _ in range(4):
        ro = rng.uniform(-45, 45, 3).astype(np.float32)
        rd = rng.normal(size=3).astype(np.float32)
        jr = jtr.ray_pick_state(spec, smin, smax, ro, rd, 0.0, 1e9)
        tr = ttr.ray_pick_state(tspec, smin, smax, ro, rd, 0.0, 1e9)
        _, jres = jtr.pick_ordered(spec, jst, *jr, _range_gd_jax, 1e9, ja,
                                   max_depth=max_depth)
        _, tres = ttr.pick_ordered(tspec, tst, *tr, _range_gd_torch, 1e9, ta,
                                   max_depth=max_depth)
        assert_same_pick(jres, tres)
        hits += bool(tres.found)
    assert hits >= 2


def _weird_subdivide_jax(gstate):
    cmin, cmax, qmin, qmax, depth = gstate
    dim = cmin.shape[-1]
    center = cmin + (cmax - cmin) / jnp.float32(2)
    mins, maxs = [], []
    for child in range(1 << dim):
        side = jnp.array([bool((child >> a) & 1) for a in range(dim)])
        mins.append(jnp.where(side[None, :], center, cmin))
        maxs.append(jnp.where(side[None, :], cmax, center))
    rep = lambda x: jnp.broadcast_to(x[None], (1 << dim,) + x.shape)
    return (jnp.stack(mins), jnp.stack(maxs), rep(qmin), rep(qmax),
            rep(depth) + 1)


def _weird_should_test_jax(gstate, nearest):
    cmin, cmax, qmin, qmax, _ = gstate
    overlap = jnp.all((cmin <= qmax) & (cmax >= qmin), axis=-1)
    return overlap & (nearest > jnp.max(cmax - cmin, axis=-1)
                      * jnp.float32(0.25))


def _weird_test_order_jax(gstate):
    fanout = 1 << gstate[0].shape[-1]
    mult = 5 if fanout == 8 else 3
    return (mult * jnp.arange(fanout, dtype=jnp.int32)
            + gstate[4][0]) % fanout


def _weird_subdivide_torch(gstate):
    cmin, cmax, qmin, qmax, depth = gstate
    fan = 1 << cmin.shape[-1]
    mins, maxs = ttr._halves(cmin, cmax, cmin + (cmax - cmin) / 2)
    return (mins, maxs, ttr._repeat(qmin, fan), ttr._repeat(qmax, fan),
            ttr._repeat(depth, fan) + 1)


def _weird_should_test_torch(gstate, nearest):
    cmin, cmax, qmin, qmax, _ = gstate
    overlap = torch.all((cmin <= qmax) & (cmax >= qmin), dim=-1)
    return overlap & (nearest > torch.amax(cmax - cmin, dim=-1) * 0.25)


def _weird_test_order_torch(gstate):
    fanout = 1 << gstate[0].shape[-1]
    mult = 5 if fanout == 8 else 3
    return (mult * torch.arange(fanout) + gstate[4][0]) % fanout


@pytest.mark.parametrize("pair", [S32, S64_3], ids=lambda p: p[0].name)
def test_pick_ordered_weird_geometry_matches_jax(trees, pair):
    """A depth-permuted test_order and a nearest-dependent should_test:
    where a traversal-order fault would show."""
    spec, tspec = pair
    jst, tst = trees[spec.name]
    smin, smax = _system(spec.dim)
    rng = np.random.default_rng(97)
    ja, ta = _args(1.0, 0.0)
    found = 0
    for _ in range(5):
        qmin = rng.uniform(-50, 20, spec.dim).astype(np.float32)
        qmax = qmin + rng.uniform(5, 60, spec.dim).astype(np.float32)
        root = (smin[None], smax[None], qmin[None], qmax[None])
        _, jres = jtr.pick_ordered(
            spec, jst, tuple(jnp.asarray(x) for x in root)
            + (jnp.zeros((1,), jnp.int32),), _weird_subdivide_jax,
            _weird_should_test_jax, _weird_test_order_jax, _mix_gd_jax,
            100.0, ja)
        _, tres = ttr.pick_ordered(
            tspec, tst, tuple(torch.as_tensor(x) for x in root)
            + (torch.zeros(1, dtype=torch.int64),), _weird_subdivide_torch,
            _weird_should_test_torch, _weird_test_order_torch,
            _mix_gd_torch, 100.0, ta)
        assert_same_pick(jres, tres)
        assert not bool(tres.overflow)
        found += bool(tres.found)
    assert found >= 2


def test_pick_ordered_stack_overflow_matches_jax(trees):
    spec, tspec = S64_3
    jst, tst = trees[spec.name]
    smin, smax = _system(3)
    ja, ta = _args(1.0, 0.0)
    _, jres = jtr.pick_ordered(spec, jst, *jtr.box_pick_state(
        spec, smin, smax, smin, smax), _mix_gd_jax, 1e9, ja, stack_cap=4)
    _, tres = ttr.pick_ordered(tspec, tst, *ttr.box_pick_state(
        tspec, smin, smax, smin, smax), _mix_gd_torch, 1e9, ta, stack_cap=4)
    assert bool(tres.overflow)
    assert_same_pick(jres, tres)


def test_pick_ordered_empty_and_miss():
    spec, tspec = S32
    smin, smax = _system(2)
    _, ta = _args(1.0, 1e6)
    empty = tl.make_layer(tspec, 64, device="cpu")
    _, res = ttr.pick_ordered(tspec, empty, *ttr.box_pick_state(
        tspec, smin, smax, smin, smax), _mix_gd_torch, 1e9, ta)
    assert not bool(res.found) and torch.isinf(res.distance)
    assert int(res.obj_id) == tl.PAD_ID
    _, st = port_built(spec, tspec, scene(spec, 50, seed=79))
    _, res = ttr.pick_ordered(tspec, st, *ttr.box_pick_state(
        tspec, smin, smax, smin, smax), _mix_gd_torch, 10.0, ta)
    assert not bool(res.found)


def test_pick_ordered_min_depth_and_id_bound_match_jax():
    """A min_depth 2 tree (its shallow slices hold no keys), with and
    without the id_bound map, against JAX."""
    spec, tspec = S64_3
    smin, smax = _system(3)
    jst, tst = port_built(spec, tspec, scene(spec, 150, seed=83),
                          min_depth=2)
    ja, ta = _args(1.0, 0.0)
    rng = np.random.default_rng(29)
    found = 0
    for _ in range(3):
        ro = rng.uniform(-45, 45, 3).astype(np.float32)
        rd = rng.normal(size=3).astype(np.float32)
        _, jres, _ = jtr.pick_ray_ordered(spec, jst, smin, smax, ro, rd, 1e9,
                                          _mix_ray_jax, ja)
        for bound in (None, 150):
            _, tres, _ = ttr.pick_ray_ordered(tspec, tst, smin, smax, ro, rd,
                                              1e9, _mix_ray_torch, ta,
                                              id_bound=bound)
            assert_same_pick(jres, tres)
        found += bool(tres.found)
    assert found >= 1


def test_pick_ordered_truncated_tree_flags_overflow():
    spec, tspec = S64_3
    sc = scene(spec, 100, seed=91)
    st = tl.build(tspec, *sc, out_capacity=64, device="cpu")
    assert bool(st.overflow)
    _, ta = _args(1.0, 0.0)
    _, res, _ = ttr.pick_ray_ordered(tspec, st, sc[0], sc[1],
                                     np.zeros(3, np.float32),
                                     np.ones(3, np.float32), 1e9,
                                     _mix_ray_torch, ta)
    assert bool(res.overflow)


def test_pick_ordered_identical_cluster_matches_jax():
    """Every object identical and co-located: every candidate folds
    through one slice, the DFS's worst case."""
    spec, tspec = S64_3
    n = 300
    sc = (np.zeros(3, np.float32), np.full(3, 10.0, np.float32),
          np.full((n, 3), 1.0, np.float32), np.full((n, 3), 1.4, np.float32),
          np.arange(n, dtype=np.uint32))
    jst, tst = port_built(spec, tspec, sc)
    ja, ta = _args(1.0, 0.0)
    ro, rd = np.zeros(3, np.float32), np.ones(3, np.float32)
    _, jres, _ = jtr.pick_ray_ordered(spec, jst, sc[0], sc[1], ro, rd, 1e9,
                                      _mix_ray_jax, ja, id_bound=n)
    steps = ttr.pick_ordered.steps
    _, tres, _ = ttr.pick_ray_ordered(tspec, tst, sc[0], sc[1], ro, rd, 1e9,
                                      _mix_ray_torch, ta, id_bound=n)
    assert bool(tres.found) and not bool(tres.overflow)
    assert_same_pick(jres, tres)
    assert ttr.pick_ordered.steps - steps > n


def test_pick_ordered_consistent_agrees_with_vectorized(trees):
    """A consistent narrow phase (never nearer than the cell's entry):
    the ordered walk and the port's vectorized pick_ray agree."""
    spec, tspec = S64_3
    _, tst = trees[spec.name]
    sc = scene(spec, 250, seed=37)
    smin, smax = sc[0], sc[1]
    centers = torch.as_tensor((sc[2] + sc[3]) / 2)

    def proj(c, ro, rd):
        t = ((c[..., 0] - ro[0]) * rd[0] + (c[..., 1] - ro[1]) * rd[1]
             + (c[..., 2] - ro[2]) * rd[2])
        e = c - (ro + rd * t[..., None])
        miss = (e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]
                + e[..., 2] * e[..., 2]) > 36.0
        return torch.where(miss, torch.inf, torch.clamp(t, min=0.0))

    def one(nearest, oid, ro, rd):
        return proj(centers[oid.clamp(max=249)], ro, rd)

    def vec(ids, mask, ro, rd):
        return torch.where(mask, proj(centers[ids.clamp(max=249)], ro, rd),
                           torch.inf)

    rng = np.random.default_rng(13)
    hits = 0
    for _ in range(4):
        ro = rng.uniform(-45, 45, 3).astype(np.float32)
        rd = rng.normal(size=3).astype(np.float32)
        rd /= np.float32(np.linalg.norm(rd))
        args = (torch.as_tensor(ro), torch.as_tensor(rd))
        _, got, _ = ttr.pick_ray_ordered(tspec, tst, smin, smax, ro, rd, 1e9,
                                         one, args)
        _, want = tq.pick_ray_linear(tspec, tst, smin, smax, ro, rd, 1e9,
                                     vec, args)
        assert bool(got.found) == bool(want.found)
        if bool(got.found):
            hits += 1
            assert int(got.obj_id) == int(want.obj_id)
            assert torch.equal(got.distance, want.distance)
    assert hits >= 2
