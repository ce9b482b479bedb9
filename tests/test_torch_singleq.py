"""Port parity for the sublinear tree engine: broadphase_tpu_torch.singleq
against broadphase_tpu.singleq, and against the port's own linear engine,
on one small tree per spec (JAX's own build, carried across with
``convert``) and a few special trees built by the port and carried to JAX.

Tolerance 0: ids, counts and overflow flags equal; pick ids equal and
distances equal as f32.  The cases of tests/test_singleq.py: boxes (point,
whole-system, outside, inverted, NaN), rays (axis-parallel and -aligned,
bounded ranges, backwards), max_depth cutoffs, ray-sphere picks and
distance ties, candidate and frontier overflow, empty and duplicate-id
layers, and the host-side box descent against JAX's u32 descent on
degenerate boxes.  Every tree has one capacity, so that JAX compiles its
tree engine once per spec and static argument set.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from broadphase_tpu import index as bidx
from broadphase_tpu import layer as jl
from broadphase_tpu import singleq as jsq
from broadphase_tpu_torch import convert
from broadphase_tpu_torch import index as tidx
from broadphase_tpu_torch import layer as tl
from broadphase_tpu_torch import query as tq
from broadphase_tpu_torch import singleq as tsq

from test_torch_index import SPEC_IDS, SPEC_PAIRS
from test_torch_layer import _jax_fields
from test_torch_layer_api import _jax_state as jax_state
from test_torch_query import _assert_same_hits as assert_same_hits
from test_torch_query import _assert_same_pick as assert_same_pick
from test_torch_query import _get_dist_jax as dist_jax
from test_torch_query import _get_dist_torch as dist_torch
from test_torch_query import _scene as scene
from test_torch_query import _sphere_table as sphere_table

CAP = 4096


def jax_built(spec, tspec, sc, cap=CAP):
    """(JAX layer, port layer) of JAX's own build, padded to ``cap``."""
    f = _jax_fields(spec, jl.build(spec, *sc))
    extra = cap - len(f["ids"])
    f = dict(f, keys=tuple(np.concatenate([c, np.full(
        extra, 0xFFFF_FFFF, np.uint32)]) for c in f["keys"]),
        ids=np.concatenate([f["ids"], np.full(extra, 0xFFFF_FFFF,
                                              np.uint32)]),
        aux=np.concatenate([f["aux"], np.zeros(extra, np.uint32)]))
    return jax_state(spec, f), convert.layer_state_from_jax(tspec, f)


def port_built(spec, tspec, sc, cap=CAP, **kw):
    """(JAX layer, port layer) of the port's build, carried to JAX."""
    tst = tl.build(tspec, *sc, out_capacity=cap, device="cpu", **kw)
    return jax_state(spec, convert.layer_state_to_numpy(tspec, tst)), tst


@pytest.fixture(scope="module")
def trees():
    """One 400-object tree per spec (seed 31), built by JAX."""
    return {spec.name: jax_built(spec, tspec, scene(spec, 400, seed=31))
            for spec, tspec in SPEC_PAIRS}


def box_queries(spec, seed):
    """tests/test_singleq.py's boxes, and a NaN box."""
    rng = np.random.default_rng(seed)
    dim = spec.dim
    out = []
    for _ in range(4):
        qmin = rng.uniform(-50, 30, dim).astype(np.float32)
        out.append((qmin, qmin + rng.uniform(0.5, 20, dim).astype(
            np.float32)))
    p = rng.uniform(-40, 40, dim).astype(np.float32)
    smin, smax = np.full(dim, -50.0, np.float32), np.full(dim, 50.0,
                                                          np.float32)
    nan = p.copy()
    nan[0] = np.nan
    out += [(p, p.copy()), (smin - 1.0, smax + 1.0), (smax + 5.0, smax + 9.0),
            (p + 3.0, p - 3.0), (nan, nan + 4.0)]
    return out


@pytest.mark.parametrize("spec,tspec,max_depth", [
    *[(s, t, None) for s, t in SPEC_PAIRS], (*SPEC_PAIRS[2], 3)],
    ids=[*SPEC_IDS, "Index64_3D-max_depth3"])
def test_box_tree_matches_jax_and_linear(trees, spec, tspec, max_depth):
    jst, tst = trees[spec.name]
    smin, smax = np.full(spec.dim, -50.0, np.float32), np.full(
        spec.dim, 50.0, np.float32)
    for i, qb in enumerate(box_queries(spec, seed=7)):
        _, jres = jsq.test_box(spec, jst, smin, smax, qb, 1024, max_depth,
                               8192)
        _, tres = tsq.test_box(tspec, tst, smin, smax, qb, 1024, max_depth,
                               8192)
        assert_same_hits(jres, tres)
        _, lres = tq.test_box_linear(tspec, tst, smin, smax, qb, 1024,
                                     max_depth)
        assert torch.equal(tres.ids, lres.ids), f"query {i}"
        assert int(tres.count) == int(lres.count)


@pytest.mark.parametrize("spec,tspec", SPEC_PAIRS, ids=SPEC_IDS)
def test_box_cover_paths_match_jax_on_degenerate_boxes(spec, tspec):
    """The host descent keeps JAX's u32 adjacency test: crossed paths of
    an inverted or NaN box wrap to a large difference and stop d*, which
    an int64 difference would let advance."""
    rng = np.random.default_rng(3)
    smin, smax = np.full(spec.dim, -50.0, np.float32), np.full(
        spec.dim, 50.0, np.float32)
    boxes = box_queries(spec, seed=5)
    p = rng.uniform(-40, 40, spec.dim).astype(np.float32)
    boxes += [(p + 0.01, p - 0.01), (p + 30.0, p - 30.0),
              (np.full(spec.dim, np.nan, np.float32),) * 2]
    for qmin, qmax in boxes:
        jl_, jh, jd = jsq._box_cover_paths(spec, smin, smax, jnp.asarray(qmin),
                                           jnp.asarray(qmax), spec.axis_bits)
        tl_, th, td = tsq._box_cover_paths(tspec, smin, smax, qmin, qmax,
                                           tspec.axis_bits)
        np.testing.assert_array_equal(tl_, np.asarray(jl_))
        np.testing.assert_array_equal(th, np.asarray(jh))
        assert td == int(jd)
    # an inverted box crosses its paths at the first split below its size
    q = (p + 30.0, p - 30.0)
    _, th, td = tsq._box_cover_paths(tspec, smin, smax, *q, tspec.axis_bits)
    assert td < tspec.axis_bits


def ray_trials(spec, seed):
    """tests/test_singleq.py's rays."""
    rng = np.random.default_rng(seed)
    out = []
    for trial in range(8):
        origin = rng.uniform(-60, 60, spec.dim).astype(np.float32)
        direction = rng.normal(size=spec.dim).astype(np.float32)
        lo, hi = 0.0, np.inf
        if trial == 2:
            direction[0] = 0.0
        if trial == 3:
            direction = np.zeros(spec.dim, np.float32)
            direction[-1] = 1.0
        if trial == 4:
            lo, hi = 5.0, 40.0
        if trial == 5:
            direction = -direction
        out.append((origin, direction, lo, hi))
    return out


@pytest.mark.parametrize("spec,tspec,max_depth", [
    *[(s, t, None) for s, t in SPEC_PAIRS], (*SPEC_PAIRS[2], 4)],
    ids=[*SPEC_IDS, "Index64_3D-max_depth4"])
def test_ray_tree_matches_jax_and_linear(trees, spec, tspec, max_depth):
    jst, tst = trees[spec.name]
    smin, smax = np.full(spec.dim, -50.0, np.float32), np.full(
        spec.dim, 50.0, np.float32)
    reads = tsq._ray_frontier_ranges.host_reads
    for trial, (ro, rd, lo, hi) in enumerate(ray_trials(spec, seed=9)):
        # 128 candidate slots: the frontier descends a few levels before
        # the candidates fit
        _, jres = jsq.test_ray(spec, jst, smin, smax, ro, rd, lo, hi, 1024,
                               max_depth, 128)
        _, tres = tsq.test_ray(tspec, tst, smin, smax, ro, rd, lo, hi, 1024,
                               max_depth, 128)
        assert_same_hits(jres, tres)
        assert not bool(tres.overflow)
        _, lres = tq.test_ray_linear(tspec, tst, smin, smax, ro, rd, lo, hi,
                                     1024, max_depth)
        assert torch.equal(tres.ids, lres.ids), f"trial {trial}"
    assert tsq._ray_frontier_ranges.host_reads - reads >= 2 * 8


@pytest.mark.parametrize("spec,tspec", SPEC_PAIRS, ids=SPEC_IDS)
def test_pick_ray_tree_matches_jax_and_linear(trees, spec, tspec):
    jst, tst = trees[spec.name]
    sc = scene(spec, 400, seed=31)
    smin, smax = sc[0], sc[1]
    centers = (sc[2] + sc[3]) / 2.0
    rng = np.random.default_rng(11)
    found = exact = 0
    for trial in range(6):
        ro = rng.uniform(-45, 45, spec.dim).astype(np.float32)
        rd = (centers[rng.integers(400)] - ro) if trial % 3 else \
            rng.normal(size=spec.dim)
        rd = (rd / np.linalg.norm(rd)).astype(np.float32)
        md = np.float32(np.inf if trial % 2 == 0 else 60.0)
        table = sphere_table(sc, ro, rd)
        _, jres = jsq.pick_ray(spec, jst, smin, smax, ro, rd, md, dist_jax,
                               (jnp.asarray(table),), None, 128)
        _, tres = tsq.pick_ray(tspec, tst, smin, smax, ro, rd, md,
                               dist_torch, (torch.as_tensor(table),), None,
                               128)
        assert_same_pick(jres, tres)
        if not bool(tres.overflow):     # all candidates fitted
            _, lres = tq.pick_ray_linear(tspec, tst, smin, smax, ro, rd, md,
                                         dist_torch,
                                         (torch.as_tensor(table),))
            assert_same_pick(jres, lres)
            exact += 1
        found += bool(tres.found)
    assert found >= 2 and exact >= 3


@pytest.mark.parametrize("spec,tspec", [SPEC_PAIRS[0], SPEC_PAIRS[2]],
                         ids=[SPEC_IDS[0], SPEC_IDS[2]])
def test_pick_ray_tree_distance_tie(spec, tspec):
    """Co-located equal objects with descending ids: every candidate ties,
    so the winner is the reference's first visited, as JAX picks it."""
    dim = spec.dim
    n = 12
    sc = (np.full(dim, -50.0, np.float32), np.full(dim, 50.0, np.float32),
          np.full((n, dim), 4.0, np.float32), np.full((n, dim), 6.0,
                                                       np.float32),
          np.arange(n, dtype=np.uint32)[::-1].copy())
    jst, tst = port_built(spec, tspec, sc)
    ro = np.full(dim, -20.0, np.float32)
    rd = np.full(dim, 25.0, np.float32)
    rd /= np.linalg.norm(rd)
    table = np.full(n, np.float32(np.sqrt(np.float32(dim)) * 25 - 1),
                    np.float32)
    _, jres = jsq.pick_ray(spec, jst, sc[0], sc[1], ro, rd, np.float32(np.inf),
                           dist_jax, (jnp.asarray(table),), None, 8192)
    _, tres = tsq.pick_ray(tspec, tst, sc[0], sc[1], ro, rd,
                           np.float32(np.inf), dist_torch,
                           (torch.as_tensor(table),), None, 8192)
    assert bool(tres.found)
    assert_same_pick(jres, tres)


def test_tree_overflow_flags(trees):
    """Candidate-buffer and frontier overflow are flagged, as in JAX."""
    spec, tspec = SPEC_PAIRS[2]
    jst, tst = trees[spec.name]
    smin, smax = np.full(3, -50.0, np.float32), np.full(3, 50.0, np.float32)
    _, jres = jsq.test_box(spec, jst, smin, smax, (smin, smax), 4096, None,
                           64)
    _, tres = tsq.test_box(tspec, tst, smin, smax, (smin, smax), 4096, None,
                           64)
    assert bool(tres.overflow)
    assert_same_hits(jres, tres)
    ro, rd = np.full(3, -49.0, np.float32), np.ones(3, np.float32)
    _, jres = jsq.test_ray(spec, jst, smin, smax, ro, rd, 0.0, np.inf, 4096,
                           None, 64, 2)
    _, tres = tsq.test_ray(tspec, tst, smin, smax, ro, rd, 0.0, np.inf, 4096,
                           None, 64, 2)
    assert bool(tres.overflow)
    assert_same_hits(jres, tres)


@pytest.mark.parametrize("spec,tspec", SPEC_PAIRS, ids=SPEC_IDS)
def test_tree_engine_on_empty_and_duplicate_layers(spec, tspec):
    dim = spec.dim
    smin, smax = np.full(dim, -50.0, np.float32), np.full(dim, 50.0,
                                                          np.float32)
    q = (np.full(dim, -10.0, np.float32), np.full(dim, 10.0, np.float32))
    empty = tl.make_layer(tspec, CAP, device="cpu")
    _, res = tsq.test_box(tspec, empty, smin, smax, q, 64, None, 8192)
    assert int(res.count) == 0 and not bool(res.overflow)
    _, res = tsq.test_ray(tspec, empty, smin, smax, q[0], np.ones(dim),
                          0.0, np.inf, 64, None, 8192)
    assert int(res.count) == 0 and not bool(res.overflow)

    rng = np.random.default_rng(43)
    n = 200
    bmin = rng.uniform(-49, 39, size=(n, dim)).astype(np.float32)
    bmax = bmin + rng.uniform(5, 10, size=(n, dim)).astype(np.float32)
    sc = (smin, smax, bmin, bmax, np.arange(n, dtype=np.uint32) % 50)
    jst, tst = port_built(spec, tspec, sc)
    _, jres = jsq.test_box(spec, jst, smin, smax, q, 1024, None, 8192)
    _, tres = tsq.test_box(tspec, tst, smin, smax, q, 1024, None, 8192)
    assert_same_hits(jres, tres)
    assert int(tres.count) > 0
