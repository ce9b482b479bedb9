"""Port parity for the bound searches (broadphase_tpu_torch.ops.search)
and the key codecs the tree walks call (broadphase_tpu_torch.index:
set_depth, clamp_depth, same_cell_at_depth, overlaps, subdivide) against
broadphase_tpu, exactly.

The searches run over random sorted keys with duplicates and pads, with
queries drawn from the keys, between them, past both ends and at the pad;
the bracketed searches get random brackets around the answer, brackets
that miss it on either side, closed (0, 0) and (k, k) brackets, and
inverted ones, where JAX's loop returns the bracket's low end.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from broadphase_tpu import index as bidx
from broadphase_tpu.ops import search as jsearch
from broadphase_tpu_torch import index as tidx
from broadphase_tpu_torch.ops import search as tsearch

from test_torch_index import (SPEC_IDS, SPEC_PAIRS, jax_to_torch_keys,
                              random_keys)


def _sorted_tree(spec, n, pads, seed):
    """(JAX keys, port keys, numpy host view) of a sorted tree of n valid
    keys, many repeated, followed by ``pads`` pads."""
    origin, depth = random_keys(spec, n // 2, seed)
    keys = np.asarray(bidx.keys_to_numpy(spec, bidx.make_key(
        spec, [jnp.asarray(o) for o in origin], jnp.asarray(depth))))
    rng = np.random.default_rng(seed)
    keys = np.sort(np.concatenate([keys, rng.choice(keys, n - n // 2)]))
    pad = np.full(pads, np.iinfo(keys.dtype).max, keys.dtype)
    host = np.concatenate([keys, pad])
    jk = bidx.keys_from_numpy(spec, host)
    return jk, tidx.keys_from_numpy(spec, host), host


def _queries(spec, host, count, seed):
    """Keys of the tree, neighbours of them (between keys), the least and
    largest key values below the port's pad, and the pad."""
    rng = np.random.default_rng(seed)
    live = host[:count]
    q = rng.choice(live, 300)
    near = (rng.choice(live, 300).astype(np.uint64)
            + rng.integers(0, 3, 300).astype(np.uint64) - np.uint64(1))
    # Index64_2D's key_bits is 63, so its largest key value would be the
    # port's pad: stop one below (no valid key has that depth field)
    top = np.uint64(min((1 << spec.key_bits) - 1, tidx.PAD_KEY - 1))
    q = np.concatenate([q.astype(np.uint64), np.minimum(near, top),
                        np.array([0, top, host[-1]], np.uint64)])
    q = q.astype(host.dtype)
    return bidx.keys_from_numpy(spec, q), tidx.keys_from_numpy(spec, q)


@pytest.mark.parametrize("spec,tspec", SPEC_PAIRS, ids=SPEC_IDS)
def test_bound_searches_match_jax(spec, tspec):
    n, pads = 700, 77
    jk, tk, host = _sorted_tree(spec, n, pads, seed=2)
    jq, tq = _queries(spec, host, n, seed=3)
    for jfn, tfn in ((jsearch.lower_bound_keys, tsearch.lower_bound_keys),
                     (jsearch.upper_bound_keys, tsearch.upper_bound_keys),
                     (jsearch.merged_upper_bound,
                      tsearch.merged_upper_bound)):
        want = np.asarray(jfn(spec, jk, jq))
        got = tfn(tspec, tk, tq)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
    # queries of two dimensions, as the walks search (fanout, F) children
    got = tsearch.lower_bound_keys(tspec, tk, tq[:300].reshape(3, 100))
    np.testing.assert_array_equal(got.numpy().reshape(-1), np.asarray(
        jsearch.lower_bound_keys(spec, jk, jq))[:300])


@pytest.mark.parametrize("spec,tspec", SPEC_PAIRS, ids=SPEC_IDS)
def test_bracketed_searches_match_jax(spec, tspec):
    n, pads = 700, 77
    cap = n + pads
    jk, tk, host = _sorted_tree(spec, n, pads, seed=4)
    jq, tq = _queries(spec, host, n, seed=5)
    m = tq.shape[0]
    rng = np.random.default_rng(6)
    for jfn, tfn, gfn in (
            (jsearch.lower_bound_keys_bracketed,
             tsearch.lower_bound_keys_bracketed, tsearch.lower_bound_keys),
            (jsearch.upper_bound_keys_bracketed,
             tsearch.upper_bound_keys_bracketed, tsearch.upper_bound_keys)):
        answer = gfn(tspec, tk, tq).numpy()
        around_lo = np.maximum(answer - rng.integers(0, 40, m), 0)
        around_hi = np.minimum(answer + rng.integers(0, 40, m), cap)
        a = rng.integers(0, cap + 1, m)
        b = rng.integers(0, cap + 1, m)
        k = rng.integers(0, cap + 1, m)
        cases = {
            "around the answer": (around_lo, around_hi),
            "random (may miss it)": (np.minimum(a, b), np.maximum(a, b)),
            "closed (0, 0)": (np.zeros(m, np.int64), np.zeros(m, np.int64)),
            "closed (k, k)": (k, k),
            "inverted": (np.maximum(a, b), np.minimum(a, b)),
        }
        for name, (lo, hi) in cases.items():
            want = np.asarray(jfn(spec, jk, jq, jnp.asarray(lo, jnp.int32),
                                  jnp.asarray(hi, jnp.int32)))
            got = tfn(tspec, tk, tq, torch.as_tensor(lo), torch.as_tensor(hi))
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
            # scalar brackets, as the walks pass their slice bounds
            got = tfn(tspec, tk, tq, int(lo[0]), int(hi[0]))
            want = np.asarray(jfn(spec, jk, jq, jnp.full(m, lo[0], jnp.int32),
                                  jnp.full(m, hi[0], jnp.int32)))
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_upper_bound_i32_matches_jax():
    rng = np.random.default_rng(8)
    vals = np.sort(rng.integers(-50, 50, 500)).astype(np.int32)
    q = rng.integers(-60, 60, 400).astype(np.int32)
    want = np.asarray(jsearch.upper_bound_i32(jnp.asarray(vals),
                                              jnp.asarray(q)))
    got = tsearch.upper_bound_i32(torch.as_tensor(vals), torch.as_tensor(q))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Key codecs of the tree walks
# ---------------------------------------------------------------------------

def _keys_both(spec, tspec, n, seed):
    origin, depth = random_keys(spec, n, seed)
    depth[:8] = spec.axis_bits                  # the depth limit
    depth[8:12] = 0
    jk = bidx.make_key(spec, [jnp.asarray(o) for o in origin],
                       jnp.asarray(depth))
    return jk, jax_to_torch_keys(spec, tspec, jk), depth


def _np_keys(spec, key):
    return np.asarray(bidx.keys_to_numpy(spec, key)).astype(np.uint64)


@pytest.mark.parametrize("spec,tspec", SPEC_PAIRS, ids=SPEC_IDS)
def test_key_codecs_match_jax(spec, tspec):
    jk, tk, depth = _keys_both(spec, tspec, 2000, seed=9)
    jk2, tk2, _ = _keys_both(spec, tspec, 2000, seed=10)
    rng = np.random.default_rng(11)
    newd = rng.integers(0, spec.axis_bits + 6, 2000).astype(np.uint32)
    # set_depth and clamp_depth, past axis_bits too
    np.testing.assert_array_equal(
        tidx.keys_to_numpy(tspec, tidx.set_depth(
            tspec, tk, torch.as_tensor(newd.astype(np.int64)))).astype(
                np.uint64),
        _np_keys(spec, bidx.set_depth(spec, jk, jnp.asarray(newd))))
    np.testing.assert_array_equal(
        tidx.clamp_depth(tspec, torch.as_tensor(newd.astype(np.int64))),
        np.asarray(bidx.clamp_depth(spec, jnp.asarray(newd))))
    # same_cell_at_depth and overlaps: against unrelated keys, and against
    # ancestors of the same keys (so that many pairs agree)
    jpar = bidx.set_depth(spec, jk, jnp.asarray(depth // 2))
    olap = []
    for jb, tb in ((jk2, tk2), (jpar, jax_to_torch_keys(spec, tspec, jpar))):
        for d in (0, 1, spec.axis_bits // 2, spec.axis_bits):
            np.testing.assert_array_equal(
                tidx.same_cell_at_depth(tspec, tk, tb, d).numpy(),
                np.asarray(bidx.same_cell_at_depth(spec, jk, jb, d)))
        olap.append(tidx.overlaps(tspec, tk, tb).numpy())
        np.testing.assert_array_equal(olap[-1], np.asarray(
            bidx.overlaps(spec, jk, jb)))
    assert olap[0].any() and not olap[0].all() and olap[1].all()


@pytest.mark.parametrize("spec,tspec", SPEC_PAIRS, ids=SPEC_IDS)
def test_subdivide_matches_jax(spec, tspec):
    """Children and validity, at the depth limit too (its children keep
    the limit depth and the parent's bits, as the JAX shift gives); and
    subdivide_at, for cells of a depth known on the host."""
    jk, tk, depth = _keys_both(spec, tspec, 1500, seed=12)
    jc, jv = bidx.subdivide(spec, jk)
    tc, tv = tidx.subdivide(tspec, tk)
    assert tc.shape == (spec.fanout, 1500)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for child in range(spec.fanout):
        jchild = jax.tree_util.tree_map(lambda a: a[child], jc)
        np.testing.assert_array_equal(
            tidx.keys_to_numpy(tspec, tc[child]).astype(np.uint64),
            _np_keys(spec, jchild))
    assert not tv[:8].any() and tv[8:12].all()
    # subdivide_at, where the depth is known: the same children
    for d in (0, 1, spec.axis_bits // 2, spec.axis_bits - 1):
        at = tk[torch.as_tensor(depth.astype(np.int64)) == d]
        assert at.numel() > 0
        np.testing.assert_array_equal(tidx.subdivide_at(tspec, at, d).numpy(),
                                      tidx.subdivide(tspec, at)[0].numpy())

