"""Port parity for the batched queries: broadphase_tpu_torch.query's
test_box_batch, test_ray_batch and pick_ray_batch against
broadphase_tpu.query's, and every row against the port's single query.

Tolerance 0: ids, counts and overflow flags per row; pick ids and f32
distances per row.  The cases of tests/test_query.py's batch tests: boxes
and rays (an axis-parallel one) over several specs, Q above the chunk
(several chunks), id-as-distance and per-query distance tables, constant
distances (every candidate ties, so the reference's visit order decides)
with shuffled sparse ids, and result buffers that overflow.  The scenes'
boxes span several cells, so ids repeat in the tree and the first-hit-
per-id rule is exercised.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from broadphase_tpu import query as jq
from broadphase_tpu_torch import query as tq

from test_torch_index import SPEC_PAIRS
from test_torch_query import _assert_same_hits as assert_same_hits
from test_torch_query import _assert_same_pick as assert_same_pick
from test_torch_query import _get_dist_jax, _get_dist_torch
from test_torch_query import _scene as scene
from test_torch_query import _sphere_table as sphere_table
from test_torch_singleq import jax_built, port_built

S32, S64_2, S64_3 = SPEC_PAIRS


@pytest.fixture(scope="module")
def trees():
    """One 300-object tree per spec (seed 21), built by JAX."""
    return {spec.name: jax_built(spec, tspec, scene(spec, 300, seed=21))
            for spec, tspec in SPEC_PAIRS}


def _row(res, q):
    return type(res)(*(f[q] for f in res))


def _boxes(dim, Q, seed):
    rng = np.random.default_rng(seed)
    qmin = rng.uniform(-50, 30, (Q, dim)).astype(np.float32)
    return qmin, qmin + rng.uniform(1, 25, (Q, dim)).astype(np.float32)


@pytest.mark.parametrize("pair,max_depth,chunk", [
    (S64_3, None, 64), (S32, None, 64), (S64_3, 3, 64), (S64_3, None, 4)],
    ids=["Index64_3D", "Index32_2D", "Index64_3D-max_depth3",
         "Index64_3D-chunk4"])
def test_test_box_batch_matches_jax_and_single(trees, pair, max_depth,
                                               chunk):
    spec, tspec = pair
    jst, tst = trees[spec.name]
    smin, smax = np.full(spec.dim, -50.0, np.float32), np.full(
        spec.dim, 50.0, np.float32)
    qb = _boxes(spec.dim, 11, seed=9)
    _, jres = jq.test_box_batch(spec, jst, smin, smax, qb, 512, max_depth,
                                chunk)
    _, tres = tq.test_box_batch(tspec, tst, smin, smax, qb, 512, max_depth,
                                chunk)
    assert tres.ids.shape == (11, 512)
    for q in range(11):
        assert_same_hits(_row(jres, q), _row(tres, q))
        _, single = tq.test_box_linear(tspec, tst, smin, smax,
                                       (qb[0][q], qb[1][q]), 512, max_depth)
        assert torch.equal(_row(tres, q).ids, single.ids)
    assert int(tres.count.max()) > 0


@pytest.mark.parametrize("pair", [S64_3, S64_2], ids=lambda p: p[0].name)
def test_test_ray_batch_matches_jax_and_single(trees, pair):
    spec, tspec = pair
    jst, tst = trees[spec.name]
    smin, smax = np.full(spec.dim, -50.0, np.float32), np.full(
        spec.dim, 50.0, np.float32)
    rng = np.random.default_rng(11)
    Q = 6
    ro = rng.uniform(-50, 50, (Q, spec.dim)).astype(np.float32)
    rd = rng.uniform(-1, 1, (Q, spec.dim)).astype(np.float32)
    rd[0, 0] = 0.0                              # axis-parallel
    lo = np.array([0, 0, 5, 0, 2, 0], np.float32)
    hi = np.array([np.inf, 30, 40, np.inf, np.inf, 10], np.float32)
    _, jres = jq.test_ray_batch(spec, jst, smin, smax, ro, rd, lo, hi, 512)
    _, tres = tq.test_ray_batch(tspec, tst, smin, smax, ro, rd, lo, hi, 512)
    for q in range(Q):
        assert_same_hits(_row(jres, q), _row(tres, q))
        _, single = tq.test_ray_linear(tspec, tst, smin, smax, ro[q], rd[q],
                                       lo[q], hi[q], 512)
        assert torch.equal(_row(tres, q).ids, single.ids)
        assert int(_row(tres, q).count) == int(single.count)


def test_batch_result_cap_overflow(trees):
    """Rows with more hits than slots: the first ids, the count capped,
    the flag set, row by row as JAX."""
    spec, tspec = S64_3
    jst, tst = trees[spec.name]
    smin, smax = np.full(3, -50.0, np.float32), np.full(3, 50.0, np.float32)
    qb = _boxes(3, 5, seed=2)
    _, jres = jq.test_box_batch(spec, jst, smin, smax, qb, 3)
    _, tres = tq.test_box_batch(tspec, tst, smin, smax, qb, 3)
    for q in range(5):
        assert_same_hits(_row(jres, q), _row(tres, q))
    assert bool(tres.overflow.any())


@pytest.mark.parametrize("pair", [S64_3, S32], ids=lambda p: p[0].name)
def test_pick_ray_batch_matches_jax_and_single(trees, pair):
    """Per-query ray-sphere distance tables (get_dist_args with a leading
    Q axis), each row against JAX and the single pick."""
    spec, tspec = pair
    jst, tst = trees[spec.name]
    sc = scene(spec, 300, seed=21)
    smin, smax = sc[0], sc[1]
    centers = (sc[2] + sc[3]) / 2.0
    rng = np.random.default_rng(13)
    Q = 7
    ro = rng.uniform(-45, 45, (Q, spec.dim)).astype(np.float32)
    rd = np.stack([centers[rng.integers(300)] - ro[q] if q % 2 else
                   rng.normal(size=spec.dim) for q in range(Q)])
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    tables = np.stack([sphere_table(sc, ro[q], rd[q]) for q in range(Q)])
    md = np.float32(1e9)
    _, jres = jq.pick_ray_batch(spec, jst, smin, smax, ro, rd, md,
                                _get_dist_jax, (jnp.asarray(tables),))
    _, tres = tq.pick_ray_batch(tspec, tst, smin, smax, ro, rd, md,
                                _get_dist_torch, (torch.as_tensor(tables),))
    for q in range(Q):
        assert_same_pick(_row(jres, q), _row(tres, q))
        _, single = tq.pick_ray_linear(tspec, tst, smin, smax, ro[q], rd[q],
                                       md, _get_dist_torch,
                                       (torch.as_tensor(tables[q]),))
        assert_same_pick(_row(jres, q), single)
    assert int(tres.found.sum()) >= 2


@pytest.mark.parametrize("pair", [S32, S64_3], ids=lambda p: p[0].name)
def test_pick_ray_batch_ties_match_jax(pair):
    """A constant distance: every candidate ties and the reference's
    first visited wins; shuffled sparse ids so that it is not the lowest
    id; sign flips and |axis| ties among the directions."""
    spec, tspec = pair
    rng = np.random.default_rng(7)
    smin, smax, bmin, bmax, _ = scene(spec, 120, seed=29)
    ids = rng.choice(50_000, 120, replace=False).astype(np.uint32)
    jst, tst = port_built(spec, tspec, (smin, smax, bmin, bmax, ids))

    def dist_jax(ids, mask):
        return jnp.where(mask, jnp.float32(5.0), jnp.inf)

    def dist_torch(ids, mask):
        return torch.where(mask, 5.0, torch.inf)

    Q = 9
    ro = rng.uniform(-45, 45, (Q, spec.dim)).astype(np.float32)
    rd = rng.normal(size=(Q, spec.dim)).astype(np.float32)
    rd[0] = 1.0
    rd[1] = -1.0
    _, jres = jq.pick_ray_batch(spec, jst, smin, smax, ro, rd,
                                np.float32(1e9), dist_jax, chunk=4)
    _, tres = tq.pick_ray_batch(tspec, tst, smin, smax, ro, rd,
                                np.float32(1e9), dist_torch, chunk=4)
    for q in range(Q):
        assert_same_pick(_row(jres, q), _row(tres, q))
        _, single = tq.pick_ray_linear(tspec, tst, smin, smax, ro[q], rd[q],
                                       np.float32(1e9), dist_torch)
        assert_same_pick(_row(jres, q), single)
    assert int(tres.found.sum()) >= 3


def test_batch_of_no_queries():
    spec, tspec = S64_3
    _, tst = port_built(spec, tspec, scene(spec, 50, seed=1))
    smin, smax = np.full(3, -50.0, np.float32), np.full(3, 50.0, np.float32)
    empty = np.zeros((0, 3), np.float32)
    _, res = tq.test_box_batch(tspec, tst, smin, smax, (empty, empty), 16)
    assert res.ids.shape == (0, 16) and res.count.shape == (0,)
    _, res = tq.pick_ray_batch(tspec, tst, smin, smax, empty, empty, 1e9,
                               lambda i, m: torch.where(m, 1.0, torch.inf))
    assert res.found.shape == (0,)
