"""Port parity: kernel 6, ops/merge.py::merge_cancel_compact.

The plain version (what a CPU tensor runs) against the JAX Pallas kernel
``broadphase_tpu.ops.pallas_merge.merge_cancel_compact`` in interpret mode,
on the cases of ``tests/test_pallas_merge.py`` (u32 columns converted at
the boundary: the key columns become one int64 key, the last column the
int64 meta, all-ones pads ``PAD_KEY``), and against a numpy lexsort
reference on the cases the TPU kernel's churn window cannot take; exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from broadphase_tpu.ops.pallas_merge import merge_cancel_compact as jmerge
from broadphase_tpu_torch.index import PAD_KEY
from broadphase_tpu_torch.ops import merge as tmerge

from test_pallas_merge import _make_scene, _pad

ONES = 0xFFFF_FFFF


def _to_port(cols):
    """u32 key columns + meta column -> int64 (key, meta); pads PAD_KEY."""
    cols = [np.asarray(c).astype(np.int64) for c in cols]
    key = cols[0] if len(cols) == 2 else (cols[0] << 32) | cols[1]
    pad = cols[-1] == ONES
    return (torch.as_tensor(np.where(pad, PAD_KEY, key)),
            torch.as_tensor(np.where(pad, PAD_KEY, cols[-1])))


def _to_jax_cols(key, meta, nc):
    key, meta = key.numpy(), meta.numpy()
    pad = key == PAD_KEY
    if nc == 2:
        kc = (key,)
    else:
        kc = (key >> 32, key & ONES)
    return tuple(np.where(pad, ONES, c).astype(np.uint32)
                 for c in kc + (meta,))


@pytest.mark.parametrize("nc", [2, 3])
@pytest.mark.parametrize("n_tree,n_tomb,n_ins,seed", [
    (5000, 300, 250, 0),
    (9000, 0, 0, 1),          # no churn at all
    (3000, 500, 0, 2),        # deletes only
    (3000, 0, 700, 3),        # inserts only
    (300, 50, 50, 4),         # single tile
])
def test_plain_matches_jax_kernel(nc, n_tree, n_tomb, n_ins, seed):
    rng = np.random.default_rng(seed)
    tc, cc = _make_scene(rng, n_tree, n_tomb, n_ins, nc=nc)
    cap = n_tree + n_ins + 64
    tcp, ccp = _pad(tc, cap), _pad(cc, 2048)
    want_cols, want_cnt, w_ovf = jmerge(
        tuple(map(jnp.asarray, tcp)), tuple(map(jnp.asarray, ccp)),
        jnp.int32(len(cc[0])), cap, tile_rows=8, window_rows=4,
        interpret=True)
    assert not bool(w_ovf)
    (key, meta), cnt, ovf = tmerge.merge_cancel_compact(
        *_to_port(tcp), *_to_port(ccp), len(cc[0]), cap)
    assert not bool(ovf)
    assert int(cnt) == int(want_cnt) == n_tree + n_ins - n_tomb
    for g, w in zip(_to_jax_cols(key, meta, nc), want_cols):
        np.testing.assert_array_equal(g, np.asarray(w))


def _numpy_reference(tree, churn, churn_count, out_cap):
    """Stable lexsort of tree ++ live churn, adjacent cancel, compact."""
    key = np.concatenate([tree[0], churn[0][:churn_count]])
    meta = np.concatenate([tree[1], churn[1][:churn_count]])
    o = np.lexsort((np.arange(len(key)), meta, key))
    key, meta = key[o], meta[o]
    dead = (meta & 1) == 1
    twin = ((key[:-1] == key[1:]) & ((meta[:-1] >> 1) == (meta[1:] >> 1))
            & ((meta[1:] & 1) == 1))
    dead[:-1] |= twin
    out_k = np.full(out_cap, PAD_KEY, np.int64)
    out_m = np.full(out_cap, PAD_KEY, np.int64)
    k = min(int((~dead).sum()), out_cap)
    out_k[:k] = key[~dead][:k]
    out_m[:k] = meta[~dead][:k]
    return out_k, out_m, int((~dead).sum())


def _sorted_cols(key, meta, n):
    o = np.lexsort((meta, key))
    pad = np.full(n - len(key), PAD_KEY, np.int64)
    return (np.concatenate([key[o], pad]), np.concatenate([meta[o], pad]))


@pytest.mark.parametrize("case", ["whole_tree", "equal_insert", "empty_tree",
                                  "outside_keys", "churn_count_short",
                                  "twin_at_tile_edge", "equal_ties"])
def test_plain_matches_numpy_reference(case):
    """Whole-tree churn (every entry tombstoned and reinserted, which no
    TPU churn window holds), an insert equal to a live tree entry, an empty
    tree, churn below and above every tree key, pads inside the churn
    buffer's live length, a tombstone at merged position 2048 (the first of
    the kernel's second tile) with its twin last in the first, and churn
    inserts equal in (key, meta) to tree entries and to each other."""
    rng = np.random.default_rng(11)
    n = 3000
    tk = np.sort(rng.choice(1 << 40, n, replace=False) + (1 << 20))
    tm = rng.integers(0, 1 << 30, n) << 1
    cap, nc = n + 600, 2 * n + 64
    ck, cm = tk[:0], tm[:0]
    churn_count = None
    if case == "whole_tree":
        ck = np.concatenate([tk, tk])
        cm = np.concatenate([tm | 1, tm + 2])          # moved in meta
    elif case == "equal_insert":
        pick = rng.choice(n, 400, replace=False)
        ck = np.concatenate([tk[pick], tk[pick[:200]]])
        cm = np.concatenate([tm[pick] | 1, tm[pick[:200]]])
    elif case == "empty_tree":
        ck = rng.choice(1 << 40, 500, replace=False)
        cm = rng.integers(0, 1 << 30, 500) << 1
        tk, tm = tk[:0], tm[:0]
    elif case == "outside_keys":
        ck = np.concatenate([np.arange(300), (1 << 41) + np.arange(300)])
        cm = np.arange(600) << 1
    elif case == "twin_at_tile_edge":
        ck, cm = tk[2047:2048], tm[2047:2048] | 1
    elif case == "equal_ties":
        pick = rng.choice(n, 300, replace=False)
        ck = np.concatenate([tk[pick], tk[pick[:100]]])
        cm = np.concatenate([tm[pick], tm[pick[:100]]])
    else:
        ck, cm = tk[:100], tm[:100] | 1
        churn_count = 140                              # 40 pads counted live
    tree = _sorted_cols(tk, tm, cap)
    churn = _sorted_cols(ck, cm, nc)
    churn_count = len(ck) if churn_count is None else churn_count
    want_k, want_m, want_cnt = _numpy_reference((tk, tm), churn,
                                                churn_count, cap)
    (key, meta), cnt, _ = tmerge.merge_cancel_compact(
        *map(torch.as_tensor, tree), *map(torch.as_tensor, churn),
        churn_count, cap)
    assert int(cnt) == want_cnt
    np.testing.assert_array_equal(key.numpy(), want_k)
    np.testing.assert_array_equal(meta.numpy(), want_m)
    if case == "twin_at_tile_edge":
        assert want_cnt == n - 1 and tk[2047] not in key.numpy()
    if case == "equal_ties":
        assert want_cnt == n + 400
    if case == "whole_tree":
        assert want_cnt == n
        np.testing.assert_array_equal(key.numpy()[:n], tk)
        np.testing.assert_array_equal(meta.numpy()[:n], tm + 2)
