"""The benchmark's own tests (``python -m pytest bpbench/tests``): on the
CPU through the program's plain kernels at tiny sizes; the tests marked
``card`` need a CUDA card and skip without one (decided in a fixture)."""

import copy
import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# tiny sizes of each configuration for the CPU.  The boxes' system box is
# 505.5 wide, about half the 1M scene's 1005.5, so that boxes of the same
# sizes meet about the same grid of cells and emit about as many cells an
# object (3.3 of the 3.7 the capacity allows)
TINY = {
    "boxes3d_1M": {"objects": 3000,
                   "scene": {"kind": "boxes", "density": 2.4e-5,
                             "size_min": 1.0, "size_max": 10.0}},
    "boxes3d_1M_wide": {"objects": 3000,
                        "scene": {"kind": "handles", "density": 2.4e-5,
                                  "size_min": 1.0, "size_max": 10.0}},
    "ballpit2d_10k": {"objects": 600},
}
CELLS = ["boxes3d_1M.rebuild", "ballpit2d_10k.frame",
         "boxes3d_1M.update_1pct", "boxes3d_1M.rebuild_unsorted",
         "boxes3d_1M_wide.rebuild"]


# cells the harness runs that BENCHMARK.json leaves out for now (their
# frame times spread too widely between processes on the card's host;
# PERF.md, Open questions): the tests run them from these entries
EXTRA = {
    "configs": [{"name": "ballpit2d_10k",
                 "file": "bpbench/configs/ballpit2d_10k.json"}],
    "workloads": [
        {"name": "ballpit2d_10k.frame", "config": "ballpit2d_10k",
         "traffic": "frame", "chips": 1},
        {"name": "boxes3d_1M.update_1pct", "config": "boxes3d_1M",
         "traffic": "update_1pct", "chips": 1}],
}


def all_cells() -> dict:
    """BENCHMARK.json with the cells it leaves out for now."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for key, extra in EXTRA.items():
        names = {e["name"] for e in bench[key]}
        bench[key] += [copy.deepcopy(e) for e in extra
                       if e["name"] not in names]
    return bench


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda:0"


def tiny(cell: str) -> dict:
    return TINY[cell.split(".")[0]]
