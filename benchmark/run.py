"""Run one cell of the benchmark once and print its result as the last line
of standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, their configurations and metrics are in BENCHMARK.json at the
root of the checkout; README.md beside this file says how they are found.
Exits with code 2 and prints no result when there is no CUDA card (or fewer
than the cell asks for), when the measured package is missing, or when a
JAX module is loaded in this process once the window has closed.
"""

import time

CLOCK0 = time.perf_counter()    # set-up is timed from here, before any import

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
for _p in (HERE.parent, HERE, HERE / "reference"):
    sys.path.insert(0, str(_p))

import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.env_for_checkout()
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  CLOCK0)
    except (harness.BenchError, ImportError) as e:
        traceback.print_exc()
        print(f"benchmark: no result: {e}", file=sys.stderr, flush=True)
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
