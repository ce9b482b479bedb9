"""The control and the faults come out as not correct.

The control is the reference computed in bfloat16 in the program's
place; each fault breaks the timed path underneath a run that skips the
look for a card: a step that returns its state unchanged, half of the
batch left out, an answer altered where it is produced, and where the
ids are handles, the handles' version bits dropped.  (No cell runs on
more than one card, so no exchange between cards can be left out.)"""

import time

import pytest
import torch

from bpbench import check, control, harness
from broadphase_tpu_torch import layer, query, update
from broadphase_tpu_torch.layer import PAD_ID

from conftest import CELLS, all_cells, tiny


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_number(cell):
    nums = control.control_numbers(cell, 11, "cpu", all_cells(),
                                   config_overrides=tiny(cell))
    ok, checks = check.verdict(nums, 1)
    assert not ok, checks


def _run(cell):
    return harness.run_cell(cell, 23, 0.3, False, "cpu",
                            time.perf_counter(), all_cells(),
                            config_overrides=tiny(cell))


def _stale_build(monkeypatch):
    """Each build hands back the tree of the build before it: the state
    unchanged by the frame.  (Consecutive frames play different ring
    frames, so the check sees it whichever frame it samples; a tree
    frozen at the first build would pass where the sample lands on a
    frame that replays the first.)"""
    real, states = layer.build, []

    def build(*a, **k):
        states.append(real(*a, **k))
        return states.pop(0) if len(states) > 1 else states[0]
    monkeypatch.setattr(layer, "build", build)


def _stale_update(monkeypatch):
    monkeypatch.setattr(update, "update", lambda spec, tracked, *a, **k:
                        tracked)


def _half_the_pairs(monkeypatch):
    real = layer.scan

    def scan(*a, **k):
        state, res = real(*a, **k)
        return state, res._replace(count=res.count // 2)
    monkeypatch.setattr(layer, "scan", scan)


def _half_the_objects(monkeypatch):
    real = layer.build

    def build(spec, smin, smax, bmin, bmax, ids, **k):
        h = ids.shape[0] // 2
        return real(spec, smin, smax, bmin[:h], bmax[:h], ids[:h], **k)
    monkeypatch.setattr(layer, "build", build)


def _altered_pair(monkeypatch):
    real = layer.scan

    def scan(*a, **k):
        state, res = real(*a, **k)
        a_col = res.pairs_a.clone()
        a_col[0] += 1
        return state, res._replace(pairs_a=a_col)
    monkeypatch.setattr(layer, "scan", scan)


def _altered_pick(monkeypatch):
    real = query.pick_ray

    def pick_ray(*a, **k):
        state, p = real(*a, **k)
        return state, p._replace(obj_id=torch.where(p.found, p.obj_id + 1,
                                                    p.obj_id))
    monkeypatch.setattr(query, "pick_ray", pick_ray)


def _version_bits_dropped(monkeypatch):
    """The tree's ids cut to the handles' 20 index bits, the rows: a
    program that takes ids for rows."""
    real = layer.build

    def build(*a, **k):
        state = real(*a, **k)
        ids = torch.where(state.ids != PAD_ID, state.ids & 0xF_FFFF,
                          state.ids)
        return state._replace(ids=ids)
    monkeypatch.setattr(layer, "build", build)


FAULTS = [
    ("boxes3d_1M.rebuild", _stale_build),
    ("boxes3d_1M.rebuild", _half_the_pairs),
    ("boxes3d_1M.rebuild", _half_the_objects),
    ("boxes3d_1M.rebuild", _altered_pair),
    ("boxes3d_1M_wide.rebuild", _stale_build),
    ("boxes3d_1M_wide.rebuild", _half_the_pairs),
    ("boxes3d_1M_wide.rebuild", _half_the_objects),
    ("boxes3d_1M_wide.rebuild", _altered_pair),
    ("boxes3d_1M_wide.rebuild", _version_bits_dropped),
    ("boxes3d_1M.rebuild_unsorted", _half_the_pairs),
    ("boxes3d_1M.rebuild_unsorted", _altered_pair),
    ("boxes3d_1M.update_1pct", _stale_update),
    ("boxes3d_1M.update_1pct", _half_the_pairs),
    ("boxes3d_1M.update_1pct", _altered_pair),
    ("ballpit2d_10k.frame", _stale_build),
    ("ballpit2d_10k.frame", _half_the_objects),
    ("ballpit2d_10k.frame", _half_the_pairs),
    ("ballpit2d_10k.frame", _altered_pick),
]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_fault_makes_the_run_incorrect(monkeypatch, cell, fault):
    fault(monkeypatch)
    r = _run(cell)
    assert r["correct"] is False, r["checks"]
