"""The benchmark's command: one run of one cell on the CUDA card.

    python3 bpbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints details on stderr, the result as
the last line of stdout (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``), then the numbers compared beside their limits as the last
lines of stderr.  Exits 2 with no result where there is no card, or
fewer cards than the cell asks for, and 3 where a module of JAX or of
the JAX package was loaded; 0 once the result is printed, ``correct``
true or false.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root in place of this script's folder, whose modules
# would otherwise shadow the standard library's (``trace``)
ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

# the bytecode of every module the run imports, torch's 2,000 files among
# them, cached at a fixed path inside the checkout: where the environment
# sets PYTHONDONTWRITEBYTECODE and no bytecode lies beside the packages,
# every run would otherwise compile them all again (6-8 s on the H100's
# host)
sys.pycache_prefix = str(ROOT / ".bpbench_pycache")
sys.dont_write_bytecode = False

T_TORCH = time.perf_counter()
import torch  # noqa: E402

T_TORCH = time.perf_counter() - T_TORCH

from bpbench import check, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.log(f"import torch took {T_TORCH:.3f} s")
    bench = harness.load_bench()
    chips = harness.workload(bench, args.workload)["chips"]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        harness.log(f"needs {chips} CUDA card(s); found {cards}")
        return 2
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), "cuda:0", T_START, bench)
    except harness.ForeignModules as e:
        harness.log(str(e))
        return 3
    print(json.dumps(result), flush=True)
    for line in check.describe(result["checks"]):
        harness.log(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
