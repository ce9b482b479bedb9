"""Port parity: kernel 7, ops/expand.py (the v2 expansion), and the scan
branch that takes it, ``layer.scan(..., expand="v2")``.

The plain versions of both entry points (``expand_pairs`` on every
element's starts and runs, ``expand_pairs_entries`` on the entries that
the prep kernel's plain version makes from the same runs) against the JAX
Pallas kernel ``broadphase_tpu.ops.pallas_expand.expand_pairs`` in
interpret mode on cases of ``tests/test_pallas_expand.py``, slot for
slot; and the port's v2 scan against JAX ``layer.scan`` with
``BROADPHASE_FORCE_PALLAS=1`` and ``BROADPHASE_EXPAND=v2``, both
contracts, pairs, counts and flags exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from broadphase_tpu import index as bidx
from broadphase_tpu import layer as jl
from broadphase_tpu.ops.pallas_expand import TILE
from broadphase_tpu.ops.pallas_expand import expand_pairs as jexpand
from broadphase_tpu_torch import index as tidx
from broadphase_tpu_torch import layer as tl
from broadphase_tpu_torch.ops import expand as texpand
from broadphase_tpu_torch.ops import prep as tprep

from test_torch_layer import _assert_scan_equal, _scene


def _runs(case):
    rng = np.random.default_rng(3)
    if case == "long_run":                  # one run longer than any window
        cap = 16384
        ids = np.arange(cap, dtype=np.uint32) * 3 + 1
        run = np.zeros(cap, np.int64)
        run[0] = 8192
        return ids, run, 8 * TILE
    if case == "far_apart":                 # two runs, 5999 empties between
        cap = 16384
        ids = np.arange(cap, dtype=np.uint32) * 7 + 5
        run = np.zeros(cap, np.int64)
        run[0], run[6000] = 512, 512
        return ids, run, TILE
    if case == "total_mid_buffer":
        ids = np.arange(4096, dtype=np.uint32)
        run = np.zeros(4096, np.int64)
        run[10] = 700
        return ids, run, 4 * TILE
    if case == "all_empty":
        return np.arange(4096, dtype=np.uint32), np.zeros(4096, np.int64), TILE
    cap = 1 << 13                           # mixed, total > pair capacity
    ids = rng.integers(0, 1 << 31, cap, dtype=np.uint32)
    run = np.zeros(cap, np.int64)
    chosen = rng.choice(cap - 64, 300, replace=False)
    run[chosen] = rng.integers(1, 48, 300)
    run = np.minimum(run, cap - 1 - np.arange(cap))
    return ids, run, ((int(run.sum()) // TILE) - 1) * TILE


def _entries(ids, run):
    """The prep kernel's plain version on the run ends that give ``run``
    (e[j] = j + 1 + run[j], count = cap): (ids, sv, ab, bid, m, total)."""
    cap = len(run)
    e = (np.arange(cap) + 1 + run).astype(np.int32)
    t_ids = torch.as_tensor(ids.astype(np.int64))
    sv, ab, bid, bmeta, m, total, _ = tprep.prep_runs_plain(
        torch.as_tensor(e), t_ids, None, cap)
    assert bmeta is None and int(total) == int(run.sum())
    return t_ids, sv, ab, bid, m, total


_CASES = ["long_run", "far_apart", "total_mid_buffer", "all_empty",
          "total_over_capacity"]


@pytest.mark.parametrize("case", _CASES)
def test_plain_matches_jax_kernel(case):
    """Both entry points' plain versions against the JAX kernel."""
    ids, run, P = _runs(case)
    starts = np.cumsum(run) - run
    total = int(run.sum())
    want_a, want_b = jexpand(jnp.asarray(ids), jnp.asarray(starts, jnp.int32),
                             jnp.asarray(run, jnp.int32), jnp.int32(total), P,
                             interpret=True)
    a, b = texpand.expand_pairs(torch.as_tensor(ids.astype(np.int64)),
                                torch.as_tensor(starts),
                                torch.as_tensor(run), total, P)
    np.testing.assert_array_equal(a.numpy(), np.asarray(want_a, np.int64))
    np.testing.assert_array_equal(b.numpy(), np.asarray(want_b, np.int64))
    a, b = texpand.expand_pairs_entries(*_entries(ids, run), P)
    np.testing.assert_array_equal(a.numpy(), np.asarray(want_a, np.int64))
    np.testing.assert_array_equal(b.numpy(), np.asarray(want_b, np.int64))


@pytest.mark.parametrize("case", _CASES)
def test_entries_match_runs(case):
    """On the entries of the same runs, the v2 expansion equals the
    expansion of every element's starts and runs, and kernel 4's plain
    version with the rule off, slot for slot, at a pair capacity below
    and above total."""
    ids, run, P = _runs(case)
    ent = _entries(ids, run)
    starts = torch.as_tensor(np.cumsum(run) - run)
    for cap in (P, int(run.sum()) + 3 * TILE + 5):
        got = texpand.expand_pairs_entries(*ent, cap)
        want = texpand.expand_pairs_plain(ent[0], starts,
                                          torch.as_tensor(run), ent[5], cap)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


N = 400


@pytest.mark.parametrize("kind,caps", [
    ("bench", (8 * N, 40 * N + 17, 64 * N)),
    ("depth0", (8 * N, 40 * N + 18, 64 * N)),
    ("bench", (8 * N, 4 * N + 19, 4 * N + 19)),     # emission undersized
])
def test_v2_scan_matches_jax(kind, caps, monkeypatch):
    """Pair capacities no other test uses, so that JAX traces its scan
    afresh under the environment set here."""
    spec, tspec = bidx.Index64_3D, tidx.Index64_3D
    tree_cap, pair_cap, emit_cap = caps
    scene = _scene(kind, n=N)
    jst = jl.build(spec, *scene, out_capacity=tree_cap)
    tst = tl.build(tspec, *scene, out_capacity=tree_cap, device="cpu")
    monkeypatch.setenv("BROADPHASE_FORCE_PALLAS", "1")
    monkeypatch.setenv("BROADPHASE_EXPAND", "v2")
    for canonical in (True, False):
        _, jres = jl.scan(spec, jst, pair_cap, emit_capacity=emit_cap,
                          canonical=canonical)
        _, tres = tl.scan(tspec, tst, pair_cap, emit_capacity=emit_cap,
                          canonical=canonical, expand="v2")
        _assert_scan_equal(jres, tres)
        assert bool(tres.overflow) == (emit_cap < 8 * N)
    if emit_cap < 8 * N:
        with pytest.raises(ValueError, match="expand"):
            tl.scan(tspec, tst, 64, expand="v1")
        return
    # without the rule the canonical dedup still gives the v3 pairs
    _, v3 = tl.scan(tspec, tst, pair_cap, emit_capacity=emit_cap)
    _, v2 = tl.scan(tspec, tst, pair_cap, emit_capacity=emit_cap,
                    expand="v2")
    np.testing.assert_array_equal(tl.scan_result_to_numpy(v2),
                                  tl.scan_result_to_numpy(v3))
