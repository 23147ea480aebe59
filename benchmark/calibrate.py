"""Readings that a cell's correctness limits are set from (the cells of
BENCHMARK.json and of pending/): for each seed, the cell's set-up and a
short window of its own traffic at its own sizes (the fleet: one batched
frame; the frontend: until every frame the check keeps has run), then the
cell's checks twice: on what the package produced (the sound reading) and
with the reference computed in TF32 in the package's place (the control).
One JSON line a seed:

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 [--out FILE]

The benchmark's own runs never run this. Needs the card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for _p in (HERE.parent, HERE, HERE / "reference"):
    sys.path.insert(0, str(_p))

import harness  # noqa: E402


def readings(cell: str, seed: int, device: str = "cuda", log=None, **driver_kw) -> dict:
    """{"program": {name: value}, "control": {name: value}, "limits": ...}
    of one seed."""
    import torch

    log = log or (lambda *a: None)
    spec = harness.with_pending(harness.load_spec())
    _, config, workload = harness.find_cell(cell, spec)
    mod = harness.load_module("drivers", workload["driver"])
    drv = mod.Driver(config=config, workload=workload, seed=seed, device=torch.device(device),
                     trace=harness.TraceWindow(False), spans=harness.Spans(), bench=harness.BENCH,
                     log=log, **driver_kw)
    t0 = time.perf_counter()
    drv.setup()
    for _ in range(drv.calibration_steps()):
        drv.step()
    drv.release()
    prog = drv.check()
    ctl = drv.check("control")
    return {"seed": seed, "seconds": time.perf_counter() - t0,
            "program": {c["name"]: c["value"] for c in prog},
            "control": {c["name"]: c["value"] for c in ctl},
            "limits": {c["name"]: c["limit"] for c in prog}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.env_for_checkout()
    out = open(args.out, "a") if args.out else sys.stdout
    try:
        for s in args.seeds.split(","):
            row = readings(args.workload, int(s),
                           log=lambda *a: print(*a, file=sys.stderr, flush=True))
            out.write(json.dumps(row) + "\n")
            out.flush()
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
