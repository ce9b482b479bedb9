"""Readings for the limits of ``check.py``: the program's numbers over
many seeds (the lower readings) and the control's (the upper readings),
in one process on the card.

    python3 bpbench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 3]

For each of ``--seeds`` a run of the cell with a short window, its
numbers as a run computes them.  For each of ``--control-seeds`` the
control: the reference computed in bfloat16, the precision below the
f32 the configurations state, put in the program's place for the frames
a run of that seed would check, through the same comparisons.  One JSON
line a seed, then a summary: each number's largest program reading and
smallest control reading.  Not part of a benchmark run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

# the checkout's root in place of this script's folder, whose modules
# would otherwise shadow the standard library's (``trace``)
sys.path[0] = str(Path(__file__).resolve().parent.parent)

import numpy as np  # noqa: E402

from bpbench import check, harness, traffic  # noqa: E402
from bpbench.reference import broadphase as ref  # noqa: E402


def control_numbers(name: str, seed: int, device, bench=None,
                    config_overrides=None) -> dict:
    """The control's numbers for cell ``name`` at ``seed``: the
    reference in bfloat16 against the reference in f32, on as many frames
    as a run checks, numbered as a run would sample them."""
    bench = bench or harness.load_bench()
    w = harness.workload(bench, name)
    config = {**harness.config_of(bench, w), **(config_overrides or {})}
    mix = traffic.load_json("traffic", w["traffic"])
    cell = harness.Cell(config, mix, seed, device)
    _, out, _ = harness.run_frame(cell, 1, harness._no_span)
    kinds = dict.fromkeys(out)
    rng = np.random.default_rng([seed % 2 ** 64, 1])
    numbers = sorted(1 + rng.choice(1000, size=mix["check_frames"],
                                    replace=False))
    held = [(check.FrameInputs(cell, traffic.frame(cell.ring, n)), kinds)
            for n in numbers]
    return check.check_frames(cell, held, ref.bf16)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    low, high = {}, {}
    for seed in seeds:
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             "cuda:0", time.perf_counter())
        nums = {k: c["value"] for k, c in r["checks"].items()}
        print(json.dumps({"seed": seed, "side": "program",
                          "correct": r["correct"], "numbers": nums,
                          "metrics": r["metrics"]}), flush=True)
        for k, v in nums.items():
            low[k] = max(low.get(k, v), v)
    for seed in controls:
        nums = control_numbers(args.workload, seed, "cuda:0")
        print(json.dumps({"seed": seed, "side": "control",
                          "numbers": nums}), flush=True)
        for k, v in nums.items():
            high[k] = min(high.get(k, v), v)
    print(json.dumps({"workload": args.workload, "lower": low,
                      "upper": high}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
