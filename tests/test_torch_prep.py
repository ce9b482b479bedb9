"""Port parity: kernel 3, ops/prep.py::prep_runs.

The plain version against the JAX Pallas kernel (interpret mode) and
against the XLA formulation of the same step (``layer.py:980-987``: run
lengths, int32 cumsum, wrap check), exact.  The port's b-side rule bytes
(its own column) must be the input bytes of the nonempty runs, in order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from broadphase_tpu.ops.pallas_prep import prep_runs as jax_prep_runs
from broadphase_tpu_torch.ops import prep as tprep


def _runs(cap, count_frac, style, rng):
    count = int(cap * count_frac)
    e = np.zeros(cap, np.int32)
    if style == "random":
        e = (np.arange(cap) + rng.integers(0, 50, cap)).astype(np.int32)
    elif style == "dense":
        e = (np.arange(cap) + 2).astype(np.int32)
    elif style == "sparse":
        e = np.arange(cap, dtype=np.int32)
        hot = rng.choice(cap, 60, replace=False)
        e[hot] += rng.integers(1, 2000, 60).astype(np.int32)
    return e, count


@pytest.mark.parametrize("cap,count_frac,style", [
    (4096, 1.0, "random"), (5000, 0.7, "random"), (4096, 1.0, "dense"),
    (8192, 0.9, "sparse"), (4096, 0.0, "empty"), (1, 1.0, "dense"),
    # several 4096-lane tiles: every run nonempty (but the last lane's),
    # every run empty, and count = cap off a tile multiple
    (16384, 1.0, "dense"), (16384, 1.0, "empty"), (12289, 1.0, "random"),
])
def test_prep_runs_matches_jax(cap, count_frac, style):
    rng = np.random.default_rng(cap + int(count_frac * 10))
    e, count = _runs(cap, count_frac, style, rng)
    ids = rng.integers(0, 1 << 32, cap, dtype=np.uint64).astype(np.uint32)
    meta = rng.integers(0, 256, cap).astype(np.int32)
    jsv, jab, jbid, jm, jtotal, jwrapped = jax_prep_runs(
        jnp.asarray(e), jnp.asarray(ids), jnp.int32(count), interpret=True)
    sv, ab, bid, bmeta, m, total, wrapped = tprep.prep_runs(
        torch.as_tensor(e), torch.as_tensor(ids.astype(np.int64)),
        torch.as_tensor(meta), count)
    m_ = int(m)
    assert m_ == int(jm)
    assert int(total) == int(jtotal)
    assert bool(wrapped) == bool(jwrapped) is False
    np.testing.assert_array_equal(sv.numpy()[:m_], np.asarray(jsv)[:m_])
    np.testing.assert_array_equal(ab.numpy()[:m_], np.asarray(jab)[:m_])
    np.testing.assert_array_equal(bid.numpy()[:m_].astype(np.uint32),
                                  np.asarray(jbid)[:m_])
    assert np.all(sv.numpy()[m_:] == tprep.HUGE)
    assert np.all(ab.numpy()[m_:] == 0)
    assert np.all(bid.numpy()[m_:] == tprep.PAD_ID)

    # the XLA formulation, and the rule bytes carried beside the ids
    pos = np.arange(cap)
    run = np.where(pos < count, np.maximum(np.minimum(e, count) - pos - 1,
                                           0), 0)
    nz = np.nonzero(run)[0]
    np.testing.assert_array_equal(bmeta.numpy()[:m_], meta[nz])
    assert np.all(bmeta.numpy()[m_:] == 0)
    starts = np.cumsum(run) - run
    np.testing.assert_array_equal(sv.numpy()[:m_], starts[nz])


@pytest.mark.parametrize("n,wraps", [(65536, False), (65537, True)])
def test_wrapped_exactly_when_int32_prefix_sum_wraps(n, wraps):
    """Every element's run reaches the end: total = n(n-1)/2, which first
    reaches 2^31 at n = 65537.  The port sums in int64 (total exact) and
    flags wrapped exactly where the JAX int32 cumsum wraps."""
    e = np.full(n, n, np.int32)
    run = (n - 1 - np.arange(n)).astype(np.int32)
    incl = np.cumsum(run, dtype=np.int32)
    xla_wrapped = bool(np.any(incl < incl - run))
    _, _, _, _, m, total, wrapped = tprep.prep_runs(
        torch.as_tensor(e), torch.arange(n), torch.zeros(n, dtype=torch.int32),
        n)
    assert int(total) == n * (n - 1) // 2
    assert int(m) == n - 1
    assert bool(wrapped) == xla_wrapped == wraps


@pytest.mark.parametrize("cap,count_frac,style", [
    (5000, 0.7, "random"), (8192, 0.9, "sparse"), (4096, 0.0, "empty"),
    (12289, 1.0, "random")])
def test_prep_runs_without_meta(cap, count_frac, style):
    """With meta None (the v2 scan) there is no bmeta column, and every
    other output equals the meta mode's."""
    rng = np.random.default_rng(cap)
    e, count = _runs(cap, count_frac, style, rng)
    ids = torch.as_tensor(rng.integers(0, 1 << 32, cap))
    meta = torch.as_tensor(rng.integers(0, 256, cap).astype(np.int32))
    with_meta = tprep.prep_runs(torch.as_tensor(e), ids, meta, count)
    without = tprep.prep_runs(torch.as_tensor(e), ids, None, count)
    assert without[3] is None
    for i in (0, 1, 2, 4, 5, 6):
        assert torch.equal(without[i], with_meta[i])
