"""The port's spans and counters (``broadphase_tpu_torch.profiling``):
under ``profiling.tracing()`` ``layer.build``, ``layer.scan``,
``layer.merge`` and ``update.update`` open exactly their registered stage
spans, each inside its layer; with tracing off they open none and keep no
counter; the scan's, the merge's and the update's counters equal what
they computed; and tracing changes no output."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bpbench.reference import broadphase as ref
from broadphase_tpu_torch import bench_caps, layer, profiling, update
from broadphase_tpu_torch import index as tidx
from broadphase_tpu_torch.ops import pairsort, treesort
from broadphase_tpu_torch.ops.prep import prep_runs
from broadphase_tpu_torch.ops.runends import scan_pass1

SPEC = tidx.Index64_3D
N = 1500
TREE, PAIRS, EMIT = 8 * N, 24 * N, 40 * N

# (scan options, the stages it opens besides pass1, prep and expand): a
# canonical scan compacts its emissions inside the pair sort (kernel 8)
SCANS = {
    "canonical": (dict(emit_capacity=PAIRS), ["scan.canonical"]),
    "canonical_wide_emit": (dict(emit_capacity=EMIT), ["scan.canonical"]),
    "unsorted": (dict(emit_capacity=EMIT, canonical=False),
                 ["scan.compact"]),
    "nested_ids": (dict(emit_capacity=EMIT, nested_ids=True),
                   ["scan.nested", "scan.canonical"]),
    "nested_ids_unsorted": (dict(nested_ids=True, canonical=False),
                            ["scan.nested", "scan.compact"]),
    "v2": (dict(emit_capacity=EMIT, expand="v2"), ["scan.canonical"]),
}
BUILD_STAGES = ["build.quantize", "build.emit", "build.sort"]
# (how the layer merged in is made, the stages the merge opens): a sorted
# layer goes through the merge kernel (k6), an unsorted one is appended
MERGES = {
    "sorted": ("build", ["merge.cols", "merge.kernel", "merge.unpack"]),
    "append": ("extend", ["merge.kernel"]),
}
UPDATE_STAGES = ["update.diff", "update.extract", "update.churn",
                 "update.merge"]


@pytest.fixture(autouse=True)
def _tracing_off():
    """Each test starts and ends with tracing off and no kept counter."""
    with profiling.tracing(False):
        profiling.counters()
        yield
    profiling.counters()


def _scene(seed=0):
    return bench_caps.bench_scene(3, N, seed=seed)


def _build(scene):
    return layer.build(SPEC, *scene, out_capacity=TREE, device="cpu")


def _scan(state, opts):
    return layer.scan(SPEC, state, PAIRS, **opts)[1]


def _spans(fn):
    """[(span, its parent span or None)] of the port's spans that ``fn()``
    opens under tracing and a CPU profiler, in the order they start."""
    with profiling.tracing(), profile(activities=[ProfilerActivity.CPU]) \
            as prof:
        fn()
    out = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.name in profiling.SPANS:
            parent = e.cpu_parent
            while parent is not None and parent.name not in profiling.SPANS:
                parent = parent.cpu_parent
            out.append((e.name, None if parent is None else parent.name))
    return out


def test_build_opens_its_stages_inside_it():
    assert _spans(lambda: _build(_scene())) == (
        [("layer.build", None)]
        + [(s, "layer.build") for s in BUILD_STAGES])


@pytest.mark.parametrize("case", SCANS)
def test_scan_opens_its_stages_inside_it(case):
    opts, extra = SCANS[case]
    state = _build(_scene())
    stages = [s for s in ("scan.nested", "scan.pass1", "scan.prep",
                          "scan.expand", "scan.compact", "scan.canonical")
              if s in extra or s in ("scan.pass1", "scan.prep",
                                     "scan.expand")]
    assert _spans(lambda: _scan(state, opts)) == (
        [("layer.scan", None)] + [(s, "layer.scan") for s in stages])


@pytest.mark.parametrize("case", SCANS)
def test_every_span_opened_is_registered(monkeypatch, case):
    opened = []
    real = torch.profiler.record_function

    def recording(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", recording)
    scene = _scene()
    with profiling.tracing():
        state = _build(scene)
        _scan(state, SCANS[case][0])
        empty = layer.make_layer(SPEC, TREE, device="cpu")
        grown = layer.extend(SPEC, empty, *scene)
        layer.merge(SPEC, state, grown)
        layer.merge(SPEC, state, _build(_scene(seed=1)))
        layer.scan_auto(SPEC, state, initial_capacity=1024)
    assert opened and set(opened) <= set(profiling.SPANS)
    assert set(profiling.counters()) <= set(profiling.COUNTERS)


@pytest.mark.parametrize("case", SCANS)
def test_tracing_off_opens_no_span_and_keeps_no_counter(monkeypatch, case):
    def refuse(name):
        raise AssertionError(f"span {name!r} opened with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    state = _build(_scene())
    res = _scan(state, SCANS[case][0])
    assert int(res.count) > 0
    assert profiling.counters() == {}


@pytest.mark.parametrize("case", SCANS)
def test_scan_counters_equal_the_result_and_the_prep_total(case):
    opts = SCANS[case][0]
    state = _build(_scene(seed=3))
    with profiling.tracing():
        res = _scan(state, opts)
    got = profiling.counters()
    keys, ids, count = state.keys, state.ids, state.count
    if opts.get("nested_ids"):
        keys, ids, count = layer._drop_nested_same_id(SPEC, keys, ids, count)
    v3 = opts.get("expand", "v3") == "v3"
    aux = state.aux if v3 and not opts.get("nested_ids") else None
    e, _, bmeta = scan_pass1(SPEC, keys, aux, rules=v3)
    total = prep_runs(e, ids, bmeta, count)[5]
    want = {"scan.emitted": int(total), "scan.pairs": int(res.count)}
    if opts.get("canonical", True):
        # the pair sort's passes: the digits of the packed pairs, 2 x 11
        # bits for ids below 1500, that vary over the pairs
        w = int(ids[:int(count)].max()).bit_length()
        n = int(res.count)
        want["scan.sort_passes"] = int(pairsort.plan_passes(
            (res.pairs_a[:n] << w) | res.pairs_b[:n], w))
        assert want["scan.sort_passes"] == 3
        # a few thousand pairs: every bucket fits in shared memory
        want["scan.sort_spilled"] = 0
    assert got == want
    assert 0 < got["scan.pairs"] <= got["scan.emitted"]


@pytest.mark.parametrize("case", SCANS)
def test_tracing_changes_no_output(case):
    opts = SCANS[case][0]
    scene = _scene(seed=5)
    outs = []
    for on in (False, True, False):
        with profiling.tracing(on):
            state = _build(scene)
            outs.append((state, _scan(state, opts)))
    (s0, r0), (s1, r1), (s2, r2) = outs
    for a, b in ((s0, s1), (s0, s2)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for a, b in ((r0, r1), (r0, r2)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def _merge_pair(case):
    """(a static layer at twice the tree's capacity, the layer merged into
    it, made as ``MERGES[case]`` says), of two scenes."""
    target = layer.build(SPEC, *_scene(seed=7), out_capacity=2 * TREE,
                         device="cpu")
    other = _scene(seed=8)
    if MERGES[case][0] == "build":
        return target, _build(other)
    empty = layer.make_layer(SPEC, TREE, device="cpu")
    return target, layer.extend(SPEC, empty, *other)


@pytest.mark.parametrize("case", MERGES)
def test_merge_opens_its_stages_inside_it(case):
    target, other = _merge_pair(case)
    assert _spans(lambda: layer.merge(SPEC, target, other)) == (
        [("layer.merge", None)]
        + [(s, "layer.merge") for s in MERGES[case][1]])


@pytest.mark.parametrize("case", MERGES)
def test_merge_entries_equal_the_merged_count(case):
    target, other = _merge_pair(case)
    with profiling.tracing():
        merged = layer.merge(SPEC, target, other)
    got = profiling.counters()
    # the CPU runs k6's plain version, which counts no launch
    assert got == {"merge.entries": int(merged.count)}
    assert int(merged.count) == int(target.count) + int(other.count)


@pytest.mark.parametrize("case", MERGES)
def test_merge_with_tracing_off_opens_no_span_and_changes_no_output(
        monkeypatch, case):
    target, other = _merge_pair(case)
    with profiling.tracing():
        traced = layer.merge(SPEC, target, other)
    profiling.counters()

    def refuse(name):
        raise AssertionError(f"span {name!r} opened with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    plain = layer.merge(SPEC, target, other)
    assert profiling.counters() == {}
    assert all(torch.equal(a, b) for a, b in zip(traced, plain))


def _tracked_move(name):
    """(spec, a tracked scene of N objects, the next frame's system box and
    bounds, with a tenth of the objects moved across cells)."""
    spec = getattr(tidx, name)
    smin, smax, bmin, bmax, ids = bench_caps.bench_scene(spec.dim, N,
                                                         seed=9)
    tracked = update.build_tracked(spec, smin, smax, bmin, bmax,
                                   ids.astype(np.int64),
                                   out_capacity=N * spec.fanout,
                                   device="cpu")
    rng = np.random.default_rng(4)
    jump = (rng.uniform(-5.0, 5.0, bmin.shape).astype(np.float32)
            * (rng.random(N) < 0.1)[:, None])
    return spec, tracked, (smin, smax, bmin + jump, bmax + jump)


def _update(spec, tracked, frame):
    return update.update(spec, tracked, *frame, 8 * N)


@pytest.mark.parametrize("name", ["Index64_3D", "Index32_2D"])
def test_update_opens_its_stages_inside_it(name):
    spec, tracked, frame = _tracked_move(name)
    assert _spans(lambda: _update(spec, tracked, frame)) == (
        [("layer.update", None)]
        + [(s, "layer.update") for s in UPDATE_STAGES])


@pytest.mark.parametrize("name", ["Index64_3D", "Index32_2D"])
def test_update_with_tracing_off_opens_no_span_and_changes_no_output(
        monkeypatch, name):
    spec, tracked, frame = _tracked_move(name)
    with profiling.tracing():
        traced = _update(spec, tracked, frame)
    profiling.counters()

    def refuse(name):
        raise AssertionError(f"span {name!r} opened with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    plain = _update(spec, tracked, frame)
    assert profiling.counters() == {}
    assert not bool(plain.state.overflow)
    assert not torch.equal(plain.state.keys, tracked.state.keys)
    assert all(torch.equal(a, b) for a, b in zip(traced.state, plain.state))
    assert all(torch.equal(a, b) for a, b in zip(traced[1:], plain[1:]))


def _reference_cells(name, smin, smax, bmin, bmax, ids) -> set:
    """{(id, key)} of the NumPy reference's tree of one frame's bounds."""
    tree = ref.build(ref.SPECS[name], smin, smax, bmin, bmax, ids, 2, 0,
                     1 << 30)
    assert not tree.overflow
    return set(zip(tree.ids.tolist(), tree.keys.tolist()))


@pytest.mark.parametrize("name", ["Index64_3D", "Index32_2D"])
def test_update_counts_its_changed_objects_and_churn_entries(monkeypatch,
                                                             name):
    """``update.changed`` is the objects whose cells (a function of their
    signature, and telling it apart) differ between the two frames, found
    from the reference's trees; ``update.churn_entries`` is their old
    cells (tombstones) and new cells (inserts), the count k6 is handed.
    Neither is kept with tracing off, and the outputs do not change."""
    spec, tracked, frame = _tracked_move(name)
    handed = []
    real = update.merge_cancel_compact

    def merge(*args):
        handed.append(int(args[4]))
        return real(*args)

    monkeypatch.setattr(update, "merge_cancel_compact", merge)
    with profiling.tracing():
        traced = _update(spec, tracked, frame)
    got = profiling.counters()
    plain = _update(spec, tracked, frame)
    assert profiling.counters() == {}
    assert all(torch.equal(a, b) for a, b in zip(traced.state, plain.state))
    assert all(torch.equal(a, b) for a, b in zip(traced[1:], plain[1:]))

    ids = tracked.ids.numpy()
    old = _reference_cells(name, frame[0], frame[1],
                           tracked.bounds_min.numpy(),
                           tracked.bounds_max.numpy(), ids)
    new = _reference_cells(name, *frame, ids)
    changed = {i for i, _ in old ^ new}
    entries = sum(i in changed for i, _ in old) + sum(
        i in changed for i, _ in new)
    assert got == {"update.changed": len(changed),
                   "update.churn_entries": entries}
    assert handed == [entries, entries]
    assert 0 < len(changed) < N and not bool(plain.state.overflow)


@pytest.mark.parametrize("traced", [True, False])
def test_build_counts_its_sort_passes_only_under_tracing(traced):
    """On the CPU the tree sort's plain version counts the radix passes
    that would work (``build.sort_passes``) under tracing, and nothing
    outside it; no launch is counted."""
    scene = _scene(seed=2)
    with profiling.tracing(traced):
        state = _build(scene)
    got = profiling.counters()
    if not traced:
        assert got == {}
        return
    # the emission is in (id, aux) order: the passes are the key digits
    # that vary over the live entries
    live = state.keys[:int(state.count)]
    want = treesort.digits_that_work(live, treesort.key_digits(SPEC))
    assert got == {"build.sort_passes": want}
    assert 0 < want < treesort.key_digits(SPEC)


def test_counters_sum_host_and_device_values_and_clear():
    with profiling.tracing():
        profiling.count("k5.launches", 1)
        profiling.count("k5.launches", 2)
        profiling.count("scan.pairs", torch.tensor(7))
        profiling.count("scan.pairs", torch.tensor([5], dtype=torch.int32))
        profiling.count("scan.emitted", torch.tensor(np.int64(2 ** 40)))
        profiling.count("k8.launches", 1)
        profiling.count("scan.sort_passes", torch.tensor(5))
        profiling.count("scan.sort_passes", torch.tensor(8))
        profiling.count("k9.launches", 1)
        profiling.count("build.sort_passes", torch.tensor(5))
        profiling.count("build.sort_passes", 3)
    profiling.count("scan.emitted", 1)       # tracing off: not kept
    assert profiling.counters() == {"k5.launches": 3, "scan.pairs": 12,
                                    "scan.emitted": 2 ** 40,
                                    "k8.launches": 1,
                                    "scan.sort_passes": 13,
                                    "k9.launches": 1,
                                    "build.sort_passes": 8}
    assert profiling.counters() == {}


def test_tracing_restores_the_state_and_a_bare_call_sets_it():
    assert profiling.span("layer.build") is profiling.span("layer.scan")
    with profiling.tracing():
        with profiling.tracing(False):
            assert profiling.span("layer.build") is profiling._NO_SPAN
        assert profiling.span("layer.build") is not profiling._NO_SPAN
    assert profiling.span("layer.build") is profiling._NO_SPAN
    profiling.tracing(True)
    try:
        assert profiling.span("layer.build") is not profiling._NO_SPAN
    finally:
        profiling.tracing(False)
    assert profiling.span("layer.build") is profiling._NO_SPAN


def test_registered_names_are_unique_and_stages_follow_their_layer():
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)
    assert len(set(profiling.COUNTERS)) == len(profiling.COUNTERS)
    assert {"k8.launches", "scan.sort_passes", "merge.entries",
            "k9.launches", "build.sort_passes", "scan.sort_spilled",
            "update.changed", "update.churn_entries"
            } <= set(profiling.COUNTERS)
    assert {"layer.merge", "merge.cols", "merge.kernel",
            "merge.unpack"} <= set(profiling.SPANS)
    assert {"layer.update", *UPDATE_STAGES} <= set(profiling.SPANS)
    for name in profiling.SPANS:
        group, _ = name.split(".")
        if group != "layer":
            assert f"layer.{group}" in profiling.SPANS
