"""Port parity: kernel 8, ops/pairsort.py::pair_sort, the canonical pair sort.

The plain version (what a CPU tensor runs, and what the chain computes on
the card) against the pair sort the port ran before it (``torch.sort`` of
``((a - 2^31) << 32) + b`` and the dedup by kernel 5's plain version) and
against ``broadphase_tpu.layer.canonical_pairs``; exact.  Also the
emission compaction folded into the chain at and around the pair
capacity, the passes and spilled counters, the plan of buckets (against
the chain's constants and at the 1M step's numbers) and the dispatch.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from broadphase_tpu import layer as jlayer
from broadphase_tpu_torch import layer, profiling
from broadphase_tpu_torch.index import PAD_KEY
from broadphase_tpu_torch.ops import pairsort
from broadphase_tpu_torch.ops.compact import stream_compact_plain

PAD_ID = 0xFFFF_FFFF
N = 3000
# the largest id of each case: all ids 0, then 1, a byte, either side of
# the JAX package's 20-bit pack, 2^24 and the largest live id
WIDTHS = {"zero": 0, "one": 1, "byte": 2 ** 8 - 1, "jax_pack_under": 2 ** 20 - 2,
          "jax_pack_at": 2 ** 20 - 1, "2^24": 2 ** 24, "u32": 2 ** 32 - 2}
PATTERNS = ("prefix", "scattered", "none", "all")


@pytest.fixture(autouse=True)
def _tracing_off():
    with profiling.tracing(False):
        profiling.counters()
        yield
    profiling.counters()


def _ids(rng, top, n):
    """n ids in [0, top], top among them."""
    ids = rng.integers(0, top + 1, n, dtype=np.uint64).astype(np.int64)
    ids[rng.integers(0, n)] = top
    return ids


def _valid(rng, pattern, n):
    return {"prefix": np.arange(n) < (2 * n) // 3,
            "scattered": rng.random(n) < 0.45,
            "none": np.zeros(n, bool),
            "all": np.ones(n, bool)}[pattern]


def _torch_sort_reference(a, b, valid):
    """The port's canonical sort before kernel 8: an int64 key sorted by
    ``torch.sort``, decoded, deduplicated and compacted."""
    key = torch.where(valid, (a - (1 << 31)) * (1 << 32) + b, PAD_KEY)
    key = torch.sort(key).values
    a_s = (key >> 32) + (1 << 31)
    b_s = key & 0xFFFF_FFFF
    prev = torch.cat([key[:1] ^ 1, key[:-1]])
    keep = (key != PAD_KEY) & (key != prev)
    (out_a, out_b), count = stream_compact_plain(keep, (a_s, b_s))
    return out_a, out_b, count


def _jax(a, b, valid):
    got = jlayer.canonical_pairs(jnp.asarray(a.numpy().astype(np.uint32)),
                                 jnp.asarray(b.numpy().astype(np.uint32)),
                                 jnp.asarray(valid.numpy()))
    return tuple(np.asarray(x).astype(np.int64) for x in got)


def _assert_equal(got, *wants):
    for want in wants:
        assert int(got[2]) == int(want[2])
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("width", WIDTHS)
def test_pair_sort_matches_torch_sort_and_jax(width, pattern):
    rng = np.random.default_rng(len(width) * 7 + PATTERNS.index(pattern))
    top = WIDTHS[width]
    a, b = (torch.as_tensor(_ids(rng, top, N)) for _ in range(2))
    valid = torch.as_tensor(_valid(rng, pattern, N))
    got = layer.canonical_pairs(a, b, valid)
    _assert_equal(got, _torch_sort_reference(a, b, valid), _jax(a, b, valid))
    if pattern == "none":
        assert int(got[2]) == 0
    assert bool((got[0][int(got[2]):] == PAD_ID).all())


@pytest.mark.parametrize("width", ["byte", "jax_pack_at", "u32"])
def test_pair_sort_drops_repeated_pairs(width):
    """v2 and wide-id emissions repeat pairs: each survives once."""
    rng = np.random.default_rng(11)
    top = WIDTHS[width]
    pool = np.stack([_ids(rng, top, 200), _ids(rng, top, 200)], 1)
    pick = pool[rng.integers(0, 200, N)]
    a, b = torch.as_tensor(pick[:, 0]), torch.as_tensor(pick[:, 1])
    valid = torch.as_tensor(rng.random(N) < 0.8)
    got = layer.canonical_pairs(a, b, valid)
    want_count = len({tuple(p) for p in pick[valid.numpy()]})
    assert int(got[2]) == want_count < int(valid.sum())
    _assert_equal(got, _torch_sort_reference(a, b, valid), _jax(a, b, valid))


@pytest.mark.parametrize("kept", ["under", "exact", "one_over",
                                  "spill_past_the_cut"])
def test_folded_compaction_keeps_the_same_prefix_and_overflow(kept):
    """A canonical scan whose emission buffer is wider than its pair buffer
    compacts inside kernel 8: the same first ``pair_capacity`` valid
    emissions and the same overflow flag as kernel 5 then the sort.  The
    buckets are planned over those lanes alone: past the cut, twice a
    bucket's keys that share one ``a`` spill nothing."""
    pair_cap, emit_cap = 1000, 4000
    rng = np.random.default_rng(5)
    if kept == "spill_past_the_cut":
        emit_cap = pair_cap + 2 * pairsort.BUCKET_KEYS
    n_valid = {"under": pair_cap - 37, "exact": pair_cap,
               "one_over": pair_cap + 1,
               "spill_past_the_cut": emit_cap}[kept]
    valid_np = np.zeros(emit_cap, bool)
    valid_np[rng.choice(emit_cap, n_valid, replace=False)] = True
    a, b = (torch.as_tensor(_ids(rng, 2 ** 20 - 1, emit_cap))
            for _ in range(2))
    # repeats inside and across the cut, as the v2 expansion emits them
    a[1::7], b[1::7] = a[::7][:len(a[1::7])], b[::7][:len(b[1::7])]
    if kept == "spill_past_the_cut":
        a[pair_cap:] = 12345
        b[pair_cap:] = torch.as_tensor(rng.permutation(2 ** 20)[
            :emit_cap - pair_cap])
    a, b = torch.where(torch.as_tensor(valid_np), a, PAD_ID), \
        torch.where(torch.as_tensor(valid_np), b, PAD_ID)
    valid = torch.as_tensor(valid_np)
    no = torch.zeros((), dtype=torch.bool)
    with profiling.tracing():
        got = layer._finish_pairs(a, b, valid, pair_cap, emit_cap, no, no,
                                  True)
    (ca, cb), ccnt = stream_compact_plain(valid, (a, b))
    ca, cb = ca[:pair_cap], cb[:pair_cap]
    want = _torch_sort_reference(ca, cb, ca != PAD_ID)
    _assert_equal(got, want)
    assert bool(got.overflow) == (int(ccnt) > pair_cap) == (kept in (
        "one_over", "spill_past_the_cut"))
    assert got.pairs_a.shape == (pair_cap,)
    assert profiling.counters()["scan.sort_spilled"] == 0


# the keys of the cases whose buckets spill: twice a bucket's keys share
# one a, at the foot of 20-bit ids and at the top of 32-bit ids, beside
# 3000 pairs of other ids
SPILLED = {"one_a": 2 * pairsort.BUCKET_KEYS,
           "u32_one_a": 2 * pairsort.BUCKET_KEYS}


def _one_a(rng, a_one, b_top, others_a):
    """2 x BUCKET_KEYS pairs (a_one, distinct b up to b_top), then a pair
    (a, an id up to b_top) for each a of ``others_a``."""
    m = 2 * pairsort.BUCKET_KEYS
    b = rng.permutation(np.unique(rng.integers(0, b_top + 1, 2 * m)))[:m]
    a = np.concatenate([np.full(m, a_one), others_a])
    b = np.concatenate([b, _ids(rng, b_top, len(others_a))])
    return (torch.as_tensor(a.astype(np.int64)),
            torch.as_tensor(b.astype(np.int64)))


@pytest.mark.parametrize("case,top,passes", [
    ("zero", 0, 0), ("one", 1, 1), ("byte", 2 ** 8 - 1, 2),
    ("1M_ids", 2 ** 20 - 1, 5), ("2^24", 2 ** 24, 7), ("u32", 2 ** 32 - 2, 8),
    # ids 2^25 + [0, 2^12): the digits of bits 16-23 and 40-51 never vary
    ("offset_ids", None, 4),
    # 100 pairs: one bucket
    ("tiny", None, 2),
    # one a with more distinct b than a bucket holds: its bucket spills
    ("one_a", None, 5), ("u32_one_a", None, 8)])
def test_sort_passes_counts_the_passes_that_work(case, top, passes):
    rng = np.random.default_rng(3)
    if case == "offset_ids":
        a, b = (torch.as_tensor(2 ** 25 + rng.integers(0, 2 ** 12, N))
                for _ in range(2))
    elif case == "tiny":
        a, b = (torch.as_tensor(_ids(rng, 2 ** 8 - 1, 100)) for _ in range(2))
    elif case == "one_a":       # the others' a far from the one a's bucket
        a, b = _one_a(rng, 7, 2 ** 20 - 1, 2 ** 19 + _ids(rng, 2 ** 19 - 1, N))
    elif case == "u32_one_a":
        a, b = _one_a(rng, 2 ** 32 - 2, 2 ** 32 - 2, _ids(rng, 2 ** 31, N))
    else:
        a, b = (torch.as_tensor(_ids(rng, top, N)) for _ in range(2))
    valid = torch.ones(a.shape[0], dtype=torch.bool)
    with profiling.tracing():
        got = layer.canonical_pairs(a, b, valid)
    assert profiling.counters() == {"scan.sort_passes": passes,
                                    "scan.sort_spilled": SPILLED.get(case, 0)}
    _assert_equal(got, _torch_sort_reference(a, b, valid))
    if case == "tiny":
        w = pairsort.width_of(int(torch.maximum(a, b).max()))
        assert len(pairsort.plan_buckets((a << w) | b)[1]) == 1


def test_a_wider_id_bound_changes_only_the_passes():
    rng = np.random.default_rng(4)
    a, b = (torch.as_tensor(_ids(rng, 1000, N)) for _ in range(2))
    valid = torch.as_tensor(rng.random(N) < 0.5)
    with profiling.tracing():
        narrow = layer.canonical_pairs(a, b, valid)
        wide = pairsort.pair_sort(a, b, valid, N, torch.tensor(2 ** 31))
    assert profiling.counters() == {"scan.sort_passes": 3 + 4,
                                    "scan.sort_spilled": 0}
    _assert_equal(wide, narrow)


@pytest.mark.parametrize("live,span,shift,buckets", [
    # the 1M step: 8.53M live pairs over 20-bit ids, 3907 buckets of 2^8 a
    (8_531_205, 999_999 << 20, 28, 3907),
    # ids offset by 2^25 (26-bit ids, 52-bit keys): offsets past 32 bits,
    # so half the target
    (8_531_205, 1 << 46, 33, 8193),
    (100, 1 << 40, 41, 1),                       # tiny: one bucket
    (10 ** 6, 0, 0, 1),                          # every key equal
    (2 ** 31 - 1, 2 ** 64 - 1, 51, 8192)])      # the most buckets asked
def test_bucket_shift_plans_buckets_of_at_most_the_target(live, span, shift,
                                                          buckets):
    assert pairsort.bucket_shift(live, span) == shift
    assert (span >> shift) + 1 == buckets
    assert live / buckets <= pairsort.BUCKET_TARGET or (
        buckets == pairsort.MAX_BUCKETS // 2 or span == 0)


def test_plain_plan_mirrors_the_chain_constants():
    src = (pairsort._cuda.SRC_DIR / "pairsort.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert pairsort.BUCKET_KEYS == const("kThreads") * const("kBucketRows")
    assert pairsort.BUCKET_TARGET == const("kTarget")
    assert pairsort.MAX_BUCKETS == const("kMaxBuckets")


@pytest.mark.parametrize("bound", [None, 2 ** 20 - 1])
def test_no_valid_bytes_means_the_ids_differ(bound):
    """Without valid bytes a lane is valid where a != b: the expansion
    writes PAD on both sides of a dropped or empty slot."""
    rng = np.random.default_rng(6)
    a, b = (torch.as_tensor(_ids(rng, 2 ** 20 - 1, N)) for _ in range(2))
    pad = torch.as_tensor(rng.random(N) < 0.4)
    a[pad], b[pad] = PAD_ID, PAD_ID
    b[::97] = a[::97]
    bound = None if bound is None else torch.tensor(bound)
    got = pairsort.pair_sort(a, b, None, N // 2, bound)
    want = pairsort.pair_sort(a, b, a != b, N // 2, bound)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[3]) == int((a != b).sum()) > N // 2


def test_pair_sort_dispatches_on_device():
    """A tensor not on the CPU goes to the chain, which refuses anything but
    a CUDA tensor: no silent plain path and no launch counted."""
    z = torch.zeros(8, dtype=torch.int64, device="meta")
    with profiling.tracing():
        with pytest.raises(ValueError, match="CUDA"):
            pairsort.pair_sort(z, z, z != 0, 8)
        assert profiling.counters() == {}
