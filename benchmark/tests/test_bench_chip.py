"""On the card: each cell runs from the command line, short, and comes out
correct; the control at the cell's own size comes out not correct. Skips
without a card (the `cuda` fixture)."""

import json
import subprocess
import sys

import pytest

import calibrate
import harness

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell, cuda):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          "2147483653", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=1200, cwd=str(harness.ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu", res


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell, cuda):
    r = calibrate.readings(cell, 2147483655)
    assert any(v > r["limits"][n] for n, v in r["control"].items()), r
