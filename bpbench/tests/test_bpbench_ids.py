"""Ids that are not rows: the handles scene (``scenes/handles.py``) and
the check that takes the scene's own ids (``check.py``).  On the CPU at
3,000 objects: the scene is ``boxes``' draw with handles for ids, the
wide cell runs and is correct with the program returning the handles,
a program that drops the version bits is not, and the pick's gap maps
an id to its row."""

import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bpbench import check, harness, traffic
from bpbench.reference import broadphase as ref
from bpbench.scenes import boxes, handles
from broadphase_tpu_torch import layer

from conftest import all_cells, tiny
from test_bpbench_control import _version_bits_dropped

CELL = "boxes3d_1M_wide.rebuild"
SEED = 2 ** 31 + 17


def _config():
    bench = all_cells()
    return {**harness.config_of(bench, harness.workload(bench, CELL)),
            **tiny(CELL)}


def _run(monkeypatch=None, trace=False):
    if monkeypatch is not None:
        monkeypatch.setattr(sys, "argv", [
            "bpbench/run.py", "--workload", CELL, "--seed", str(SEED),
            "--seconds", "1.0", "--trace", str(int(trace))])
    return harness.run_cell(CELL, SEED, 1.0, trace, "cpu",
                            time.perf_counter(), all_cells(),
                            config_overrides=tiny(CELL))


def test_the_handles_scene_is_the_boxes_draw_with_handles_for_ids():
    config = _config()
    scene = handles.make(config, traffic.generator(SEED, "cpu"), "cpu")
    plain = boxes.make(config, traffic.generator(SEED, "cpu"), "cpu")
    assert torch.equal(scene.bounds_min, plain.bounds_min)
    assert torch.equal(scene.bounds_max, plain.bounds_max)
    ids = scene.ids.numpy()
    row = np.arange(config["objects"])
    version = ids >> 20
    assert np.array_equal(ids & 0xF_FFFF, row)
    assert np.array_equal(version,
                          handles.versions(config, SEED, "cpu").numpy())
    assert len(np.unique(ids)) == len(ids)
    assert ids.max() < layer.PAD_ID and ids.min() >= 2 ** 28
    # four hours of lives of 10 to 50 s: each slot died between
    # age / 5000 frames and age / 1001 times, about age / 3000.5 on average
    h = config["handles"]
    assert version.min() >= (h["age_frames"] - 999) // 5000
    assert version.max() <= h["age_frames"] // 1001
    assert abs(version.mean() / (h["age_frames"] / 3000.5) - 1) < 0.02
    # a band, not an even spread over the 12 bits
    assert version.max() - version.min() < 128


def test_the_versions_count_each_slots_deaths():
    # lives of exactly 1001 frames: slot r, first filled in frame r // 3
    # (3,000 slots, a cap of 3,000 x 0.01 / 10 = 3 a frame), dies every
    # 1001 frames from then
    config = {**_config(), "handles": {
        **_config()["handles"], "lifetime_s": [10.0, 10.01],
        "age_frames": 10_000}}
    got = handles.versions(config, SEED, "cpu").numpy()
    born = np.arange(3000) // 3
    assert np.array_equal(got, (10_000 - born) // 1001)


def test_handles_that_do_not_fit_32_bits_are_refused():
    config = _config()
    with pytest.raises(ValueError):
        handles.make({**config, "objects": 2 ** 20 + 1},
                     traffic.generator(1, "cpu"), "cpu")
    with pytest.raises(ValueError):
        handles.make({**config, "handles": {**config["handles"],
                                            "version_bits": 13}},
                     traffic.generator(1, "cpu"), "cpu")
    # a world so old that the versions reach the tombstone, 4095
    with pytest.raises(ValueError):
        handles.make({**config, "handles": {**config["handles"],
                                            "age_frames": 13_000_000}},
                     traffic.generator(1, "cpu"), "cpu")


def test_the_wide_cell_is_correct_and_the_program_returns_the_handles():
    r = _run()
    assert r["correct"] is True and r["failed"] == 0, r["checks"]
    assert r["checks"]["tree_diff"]["value"] == 0
    assert r["checks"]["pairs_diff"]["value"] == 0
    # the frame's tree and pairs hold handles, not rows
    bench = all_cells()
    w = harness.workload(bench, CELL)
    cell = harness.Cell(_config(), traffic.load_json("traffic", w["traffic"]),
                        SEED, "cpu")
    _, out, _ = harness.run_frame(cell, 1, harness._no_span)
    tree = out["tree"]
    got = tree.ids[:int(tree.count)]
    assert bool(torch.isin(got, cell.scene.ids).all())
    assert int(got.min()) >= 2 ** 28
    pairs = out["pairs"]
    a = pairs.pairs_a[:int(pairs.count)]
    assert bool(torch.isin(a, cell.scene.ids).all())
    assert int(a.min()) >= 2 ** 28


def test_dropping_the_version_bits_makes_the_run_incorrect(monkeypatch):
    _version_bits_dropped(monkeypatch)
    r = _run()
    assert r["correct"] is False
    assert r["checks"]["tree_diff"]["value"] > 0


def test_the_reference_takes_the_scenes_ids():
    bench = all_cells()
    w = harness.workload(bench, CELL)
    cell = harness.Cell(_config(), traffic.load_json("traffic", w["traffic"]),
                        SEED, "cpu")
    inputs = check.FrameInputs(cell, traffic.frame(cell.ring, 1))
    tree = check.FrameRef(cell, inputs).tree()
    assert set(tree.ids.tolist()) <= set(cell.scene.ids.tolist())
    # copied to the host once a cell
    assert check.scene_ids(cell) is check.scene_ids(cell)
    # a scene of rows gives the reference the rows, as before
    rows = harness.workload(bench, "boxes3d_1M.rebuild")
    plain = harness.Cell({**harness.config_of(bench, rows),
                          **tiny("boxes3d_1M.rebuild")},
                         traffic.load_json("traffic", rows["traffic"]),
                         SEED, "cpu")
    assert np.array_equal(check.scene_ids(plain), np.arange(3000))


def test_the_pick_gap_maps_an_id_to_its_row():
    ids = np.array([7_340_032, 5, 4_294_000_000, 1_048_577], np.int64)
    distances = np.array([3.0, 1.0, 2.0, 4.0], np.float32)
    want = ref.Pick(True, 1.0, 5, False)
    assert check.pick_gap(ref.Pick(True, 1.0, 5, False), want, distances,
                          ids) == 0.0
    # the ball of id 4,294,000,000 is row 2, 1.0 behind the nearest
    assert check.pick_gap(ref.Pick(True, 2.0, 4_294_000_000, False), want,
                          distances, ids) == pytest.approx(1.0)
    # an id that no object has, or a row number taken for an id
    assert check.pick_gap(ref.Pick(True, 1.0, 6, False), want, distances,
                          ids) == check.MISS
    assert check.pick_gap(ref.Pick(True, 1.0, 1, False), want, distances,
                          ids) == check.MISS
    assert check.row_of(ids, 1_048_577) == 3 and check.row_of(ids, 0) == -1
    # over rows, as every scene but the handles has
    rows = np.arange(4)
    assert check.pick_gap(ref.Pick(True, 1.0, 1, False), want, distances,
                          rows) == 0.0
    assert check.pick_gap(ref.Pick(True, 1.0, 4, False), want, distances,
                          rows) == check.MISS


def test_a_traced_run_sorts_full_width_keys(monkeypatch, capfd):
    r = _run(monkeypatch, trace=True)
    assert r["correct"] is True
    # no device here: the host quantities alone
    assert sorted(r["metrics"]) == ["build.host_ms", "scan.host_ms",
                                    "scan.kept_share", "scan.spilled_share"]
    assert 0 <= r["metrics"]["scan.spilled_share"]["value"] <= 100
    err = capfd.readouterr().err
    counters = [line for line in err.splitlines()
                if line.strip().startswith("counters:")]
    assert counters
    # k8's keys hold both ids whole, 2 x 30 bits: their low seven 8-bit
    # digits vary, and the top one (the versions' bits 6-9) where the
    # versions' band crosses a multiple of 64; rows would vary in three
    passes = int(counters[-1].split("'scan.sort_passes': ")[1].split(",")[0])
    assert passes in (7 * _traced_frames(err), 8 * _traced_frames(err))


def _traced_frames(err: str) -> int:
    line = next(x for x in err.splitlines() if x.startswith("stages ("))
    return int(line.split("(")[1].split()[0])


def test_the_spilled_share_reads_nothing_without_a_canonical_scan():
    read = harness._reader("scan.spilled_share")
    st = SimpleNamespace(counters={"scan.emitted": 10, "scan.pairs": 5})
    assert read(SimpleNamespace(stages=st)) is None
    st = SimpleNamespace(counters={"scan.emitted": 0, "scan.sort_spilled": 0})
    assert read(SimpleNamespace(stages=st)) is None
    st = SimpleNamespace(counters={"scan.emitted": 8, "scan.sort_spilled": 2})
    assert read(SimpleNamespace(stages=st)) == pytest.approx(25.0)
