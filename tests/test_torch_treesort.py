"""Port parity: kernel 9, ops/treesort.py::tree_sort, the build's tree sort.

The plain version (what a CPU tensor runs, and what the chain computes on
the card) against the tree sort the port ran before it (two stable
``torch.sort``, by ``(id << dim) | aux`` and then by key, aux masked
first) for keys, ids, aux and the permutation, and against
``broadphase_tpu.layer.sort`` for keys, ids and aux; exact.  The inputs
are real emissions of the three specs with their ids ascending, shuffled,
repeated, at and above 2^29 - 1 (aux masked) and up to 2^32 - 2, pads at
the end or among the entries.  Also the plan (the passes that work, the
shortcut taken exactly when the emission is in (id, aux) order), which
callers ask for the permutation, and the dispatch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from broadphase_tpu import index as bidx
from broadphase_tpu import layer as jl
from broadphase_tpu_torch import bench_caps, layer, profiling, update
from broadphase_tpu_torch import index as tidx
from broadphase_tpu_torch.index import PAD_KEY
from broadphase_tpu_torch.ops import treesort

PAD_ID = 0xFFFF_FFFF
SPECS = [(s, getattr(tidx, s.name)) for s in bidx.ALL_SPECS]
SPEC_IDS = [s.name for s in bidx.ALL_SPECS]
N = 300
# the ids each case gives the emission's objects (0..N-1 in input order)
ID_CASES = ("ascending", "shuffled", "repeated", "repeated_shuffled",
            "aux_ties", "narrow_bound", "wide", "wide_shuffled", "u32")
PAD_CASES = ("end", "interleaved")


@pytest.fixture(autouse=True)
def _tracing_off():
    with profiling.tracing(False):
        profiling.counters()
        yield
    profiling.counters()


def _two_sorts(spec, keys, ids, aux):
    """The port's tree sort before kernel 9: aux masked, then two stable
    library sorts over the whole capacity."""
    masked = layer.mask_aux(ids, aux)
    order = torch.sort(ids * (1 << spec.dim) + masked, stable=True).indices
    skeys, order2 = torch.sort(keys[order], stable=True)
    perm = order[order2]
    return skeys, ids[perm], masked[perm], perm


def _jax_sort(spec, tspec, keys, ids, aux):
    """``broadphase_tpu.layer.sort`` of an unsorted layer of these columns:
    (keys, ids, aux) as the port holds them."""
    st = jl.LayerState(
        keys=bidx.key_from_columns(spec, tuple(
            jnp.asarray(c) for c in tidx.key_to_columns(tspec, keys))),
        ids=jnp.asarray(ids.numpy().astype(np.uint32)),
        aux=jnp.asarray(aux.numpy().astype(np.uint32)),
        count=jnp.int32(int((ids != PAD_ID).sum())),
        sorted=jnp.bool_(False), min_depth=jnp.uint32(0),
        invalid_count=jnp.int32(0), overflow=jnp.bool_(False))
    out = jl.sort(spec, st)
    return (tidx.key_from_columns(tspec, tuple(
                np.asarray(c) for c in bidx.sort_operands(spec, out.keys))),
            torch.as_tensor(np.asarray(out.ids).astype(np.int64)),
            torch.as_tensor(np.asarray(out.aux).astype(np.int32)))


def _emission(tspec, seed=0):
    """(keys, ids, aux) of the N boxes' cells in emission order (objects in
    input order, slots ascending), pads at the end, at a capacity of
    ``2^dim`` cells an object."""
    smin, smax, bmin, bmax, ids = bench_caps.bench_scene(tspec.dim, N,
                                                         seed=seed)
    st = layer.extend(tspec, layer.make_layer(tspec, N << tspec.dim,
                                              device="cpu"),
                      smin, smax, bmin, bmax, ids)
    assert 0 < int(st.count) < N << tspec.dim
    return st.keys, st.ids, st.aux


def _with_ids(ids, case, seed=0):
    """The emission's object ids replaced as ``case`` says."""
    rng = np.random.default_rng(seed)
    live = ids != PAD_ID
    obj = ids[live].numpy()
    new = {
        "ascending": lambda: obj,
        "shuffled": lambda: rng.permutation(N)[obj],
        "repeated": lambda: obj // 3,
        "repeated_shuffled": lambda: rng.permutation(N)[obj] // 3,
        "aux_ties": lambda: obj // 4,
        # the largest id one below the bound at which aux is masked
        "narrow_bound": lambda: obj + (2 ** 29 - 2 - (N - 1)),
        "wide": lambda: obj + (2 ** 29 - 1),
        "wide_shuffled": lambda: rng.permutation(N)[obj] + 2 ** 30,
        "u32": lambda: (obj * ((2 ** 32 - 2) // (N - 1))
                        + (2 ** 32 - 2) % (N - 1)),
    }[case]()
    out = ids.clone()
    out[live] = torch.as_tensor(np.asarray(new, np.int64))
    return out


def _interleave(cols, seed=0):
    """The live entries spread over the capacity in their order, pads
    between them."""
    keys, ids, aux = cols
    live = ids != PAD_ID
    n_live, cap = int(live.sum()), ids.shape[0]
    at = torch.as_tensor(np.sort(np.random.default_rng(seed).choice(
        cap, n_live, replace=False)))
    out = (torch.full_like(keys, PAD_KEY), torch.full_like(ids, PAD_ID),
           torch.zeros_like(aux))
    for o, c in zip(out, cols):
        o[at] = c[live]
    return out


def _case(tspec, id_case, pad_case, seed=0):
    keys, ids, aux = _emission(tspec, seed)
    ids = _with_ids(ids, id_case, seed)
    if id_case == "aux_ties":      # (key, id) ties with aux out of order
        rng = np.random.default_rng(seed + 1)
        aux = torch.where(ids != PAD_ID, torch.as_tensor(rng.integers(
            0, 1 << tspec.dim, ids.shape[0]), dtype=torch.int32), 0)
    cols = (keys, ids, aux)
    return _interleave(cols, seed) if pad_case == "interleaved" else cols


def _assert_same(got, want, n=4):
    for g, w in zip(got[:n], want[:n]):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.mark.parametrize("pad_case", PAD_CASES)
@pytest.mark.parametrize("id_case", ID_CASES)
@pytest.mark.parametrize("spec,tspec", SPECS, ids=SPEC_IDS)
def test_plain_equals_the_two_sorts_and_jax(spec, tspec, id_case, pad_case):
    keys, ids, aux = _case(tspec, id_case, pad_case)
    got = treesort.tree_sort_plain(tspec, keys, ids, aux)
    _assert_same(got, _two_sorts(tspec, keys, ids, aux))
    _assert_same(got, _jax_sort(spec, tspec, keys, ids, aux), 3)
    if id_case in ("repeated", "aux_ties"):   # (key, id) ties occur
        n = int((ids != PAD_ID).sum())
        keys_s, ids_s = got[0][:n], got[1][:n]
        assert bool(((keys_s[1:] == keys_s[:-1])
                     & (ids_s[1:] == ids_s[:-1])).any())
    if id_case.startswith(("wide", "u32")):
        assert not bool(got[2].any())


@pytest.mark.parametrize("spec,tspec", SPECS, ids=SPEC_IDS)
@pytest.mark.parametrize("shape", ["empty", "all_pads", "full"])
def test_empty_all_pad_and_full_trees(spec, tspec, shape):
    keys, ids, aux = _emission(tspec)
    live = ids != PAD_ID
    if shape == "empty":
        keys, ids, aux = keys[:0], ids[:0], aux[:0]
    elif shape == "all_pads":
        keys, ids, aux = (torch.full_like(keys, PAD_KEY),
                          torch.full_like(ids, PAD_ID), torch.zeros_like(aux))
    else:                          # every lane live, shuffled ids
        keys, ids, aux = keys[live], _with_ids(ids, "shuffled")[live], \
            aux[live]
    got = treesort.tree_sort_plain(tspec, keys, ids, aux)
    _assert_same(got, _two_sorts(tspec, keys, ids, aux))
    if ids.shape[0]:
        _assert_same(got, _jax_sort(spec, tspec, keys, ids, aux), 3)
    if shape != "full":
        assert got[4] == 0
        assert torch.equal(got[3], torch.arange(ids.shape[0]))


def _live(keys_digits, t):
    """A 64-bit-spec tree of live entries with these keys and t values (ids
    t >> 3, aux t & 7), no pads."""
    keys = torch.as_tensor(np.asarray(keys_digits, np.int64))
    t = torch.as_tensor(np.asarray(t, np.int64))
    return keys, t >> 3, (t & 7).to(torch.int32)


@pytest.mark.parametrize("case,passes", [
    ("keys_equal_in_order", 0), ("digit0_in_order", 1),
    ("digits_0_and_7_in_order", 2), ("digits_0_and_7_t_one_digit", 3),
    ("t_three_digits", 1 + 3), ("t_ties_in_order", 1),
    ("wide_ids_shuffled", 1 + 4), ("bench_1M_like", 5)])
def test_passes_count_the_digits_that_work(case, passes):
    rng = np.random.default_rng(9)
    n = 2000
    low = rng.integers(0, 256, n)
    up = np.arange(n)
    top = (low & 127) << 56       # digit 7, keys below 2^63
    keys, ids, aux = {
        "keys_equal_in_order": lambda: _live(np.full(n, 77), up),
        "digit0_in_order": lambda: _live(low, up),
        "digits_0_and_7_in_order": lambda: _live(low | top, up),
        # t below 2^8 shuffled: one digit of t
        "digits_0_and_7_t_one_digit": lambda: _live(
            low | top, rng.permutation(n) % 256),
        # t below 2^23 (ids below 2^20): three digits of t
        "t_three_digits": lambda: _live(low, rng.integers(0, 2 ** 23, n)),
        "t_ties_in_order": lambda: _live(low, np.sort(rng.integers(0, 9, n))),
        # aux masked: t is the id, 32 bits
        "wide_ids_shuffled": lambda: (
            torch.as_tensor(low), torch.as_tensor(rng.integers(
                2 ** 31, 2 ** 32 - 1, n)), torch.zeros(n, dtype=torch.int32)),
        # depth in bits 0-4, Morton bits only from bit 32 up: digits 1-3
        # shared, as at 1M
        "bench_1M_like": lambda: _live(
            rng.integers(0, 11, n) | (rng.integers(0, 2 ** 31, n) << 32),
            up),
    }[case]()
    tspec = tidx.Index64_3D
    with profiling.tracing():
        got = treesort.tree_sort(tspec, keys, ids, aux)
    assert profiling.counters() == {"build.sort_passes": passes}
    assert treesort.tree_sort_plain(tspec, keys, ids, aux)[4] == passes
    _assert_same(got, _two_sorts(tspec, keys, ids, aux)[:3] + (None,), 3)


@pytest.mark.parametrize("change,in_order", [
    ("none", True), ("swap_adjacent", False), ("equal_t", True),
    ("drop_across_pads", False), ("rise_across_pads", True),
    ("aux_falls", False), ("aux_falls_masked", True)])
def test_shortcut_taken_exactly_when_in_order(change, in_order):
    """The digits of t are sorted exactly when t falls somewhere from one
    live lane to the next, pads between them or not; once aux is masked
    t is the id, so a falling aux keeps the order."""
    tspec = tidx.Index64_3D
    keys, ids, aux = _emission(tspec)
    live = torch.nonzero(ids != PAD_ID).squeeze(1)
    a, b = int(live[40]), int(live[41])
    ids = ids.clone()
    aux = aux.clone()
    if change == "swap_adjacent":
        ids[a], ids[b] = ids[b] + 1, ids[a]
    elif change == "equal_t":
        ids[b], aux[b] = ids[a], aux[a]
    elif change in ("drop_across_pads", "rise_across_pads"):
        keys, ids, aux = _interleave((keys, ids, aux), seed=3)
        live = torch.nonzero(ids != PAD_ID).squeeze(1)
        # two live lanes in a row with pads between them
        k = 40 + int(torch.nonzero(live[41:] - live[40:-1] > 1)[0])
        a, b = int(live[k]), int(live[k + 1])
        if change == "drop_across_pads":
            ids[b] = ids[a] - 1
        else:
            ids[b], aux[b] = ids[a], aux[a]
    elif change.startswith("aux_falls"):
        if change == "aux_falls_masked":
            ids = torch.where(ids != PAD_ID, ids + 2 ** 30, PAD_ID)
        ids[b], aux[a], aux[b] = ids[a], 5, 2
    got = treesort.tree_sort_plain(tspec, keys, ids, aux)
    key_passes = treesort.digits_that_work(keys[ids != PAD_ID],
                                           treesort.key_digits(tspec))
    assert (got[4] == key_passes) == in_order
    _assert_same(got, _two_sorts(tspec, keys, ids, aux))


@pytest.mark.parametrize("caller,want_perm", [
    ("build", False), ("sort", False), ("build_tracked", True)])
def test_only_build_tracked_asks_for_the_permutation(monkeypatch, caller,
                                                     want_perm):
    asked = []
    real = layer.tree_sort

    def recording(spec, keys, ids, aux, want=False):
        asked.append(want)
        return real(spec, keys, ids, aux, want)

    monkeypatch.setattr(layer, "tree_sort", recording)
    tspec = tidx.Index64_3D
    scene = bench_caps.bench_scene(3, N)
    if caller == "build":
        layer.build(tspec, *scene, device="cpu")
    elif caller == "sort":
        st = layer.extend(tspec, layer.make_layer(tspec, 8 * N, device="cpu"),
                          *scene)
        layer.sort(tspec, st)
    else:
        update.build_tracked(tspec, *scene, device="cpu")
    assert asked == [want_perm] * len(asked) and asked


def test_tree_sort_dispatches_on_device():
    """A tensor not on the CPU goes to the chain, which refuses anything but
    a CUDA tensor: no silent plain path and no launch counted."""
    z = torch.zeros(8, dtype=torch.int64, device="meta")
    a = torch.zeros(8, dtype=torch.int32, device="meta")
    with profiling.tracing():
        with pytest.raises(ValueError, match="CUDA"):
            treesort.tree_sort(tidx.Index64_3D, z, z, a)
        with pytest.raises(ValueError, match="int32"):
            treesort.tree_sort(tidx.Index64_3D, z, z, z)
        assert profiling.counters() == {}
    assert "k9.launches" in profiling.COUNTERS
