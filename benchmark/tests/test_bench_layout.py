"""The harness finds every configuration, cell, traffic generator, driver,
metric reader, kernel map and work count by name, so one of each can be
added as new files without editing any."""

import json
import re
import shutil

import pytest

import bench_tiny
import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [e["name"] for g in ("configs", "workloads", "end_to_end", "per_layer")
             for e in SPEC[g]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(e["name"] for e in SPEC["end_to_end"] + SPEC["per_layer"])) == \
        len(SPEC["end_to_end"]) + len(SPEC["per_layer"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]


ALL = harness.with_pending(SPEC)


@pytest.mark.parametrize("cell", [w["name"] for w in ALL["workloads"]])
def test_cell_files_found_by_name(cell):
    """Every cell, of BENCHMARK.json and of pending/."""
    entry, config, workload = harness.find_cell(cell, ALL)
    assert config["name"] == entry["config"]
    harness.load_module("traffic", workload["traffic_generator"])
    assert hasattr(harness.load_module("drivers", workload["driver"]), "Driver")
    for trace in (False, True):
        metrics = harness.metrics_for(cell, ALL, trace)
        assert metrics, (cell, trace)
        for m in metrics:
            assert hasattr(harness.load_module("metrics", m["name"]), "read")
    assert set(workload["limits"]) >= {"pose_err_max"} or cell != "geo16k-fleet32"


def test_kernel_maps_name_the_layers():
    km = harness.KernelMap()
    assert km.layer_of("void select_kernel<8, 4, true>(Args)") == "select_lanes"
    assert km.layer_of("void flow_kernel<false, true, false, 32, 4, true>(FlowArgs)") \
        == "ell_consume"
    assert km.layer_of("void step_kernel<true, false, false, 32, true>(StepArgs)") \
        == "ell_consume"
    assert km.layer_of("void sgm_scan_kernel<8, 4>(int const*, int*)") == "sgm_scan"
    assert km.layer_of("void at::native::vectorized_elementwise_kernel<4>") is None


def test_new_files_are_found_without_edits(tmp_path):
    """A new configuration, cell, metric reader and kernel map, added as
    new files (and entries in BENCHMARK.json), are found: the harness runs
    the new cell and reports the new metric."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.with_pending(json.loads((harness.ROOT / "BENCHMARK.json").read_text()))
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "kitti_geo_16k.json").read_text())
    cfg.update(name="kitti_geo_16k_tight", eps_2=6e-6)
    (bench / "configs" / "kitti_geo_16k_tight.json").write_text(json.dumps(cfg))
    wl = json.loads((bench / "workloads" / "geo16k-fleet32.json").read_text())
    wl.update(traffic_name="fleet8", why="eight drives")
    wl["traffic"]["drives"] = 8
    (bench / "workloads" / "geo16k-tight-fleet8.json").write_text(json.dumps(wl))
    (bench / "metrics" / "frames_run.fleet.py").write_text(
        '"""Frames the window ran."""\n\n\ndef read(ctx):\n    return ctx.counters["frames"]\n')
    (bench / "kernels" / "zz_fused_consume.json").write_text(json.dumps(
        {"layer": "ell_consume", "patterns": ["fused_consume_kernel"]}))
    spec["configs"].append({"name": "kitti_geo_16k_tight", "source": "x",
                            "file": "benchmark/configs/kitti_geo_16k_tight.json",
                            "reduced": ["MAX_ITER"], "why": "a tighter step"})
    spec["workloads"].append({"name": "geo16k-tight-fleet8", "config": "kitti_geo_16k_tight",
                              "traffic": "fleet8", "chips": 1, "why": "eight drives"})
    next(m for m in spec["end_to_end"] if m["name"] == "pairs_per_s")["workloads"].append(
        "geo16k-tight-fleet8")
    spec["per_layer"].append({"name": "frames_run.fleet", "unit": "frames", "better": "higher",
                              "source": "program_counter", "layer": "solve loop",
                              "moves": "pairs_per_s", "workloads": ["geo16k-tight-fleet8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    new = harness.load_spec(root)
    _, config, workload = harness.find_cell("geo16k-tight-fleet8", new, root)
    assert config["eps_2"] == 6e-6 and workload["traffic"]["drives"] == 8
    assert harness.KernelMap(bench).layer_of("void fused_consume_kernel<32>") == "ell_consume"
    res = harness.run_cell("geo16k-tight-fleet8", 7, 0.0, False, 0.0, device="cpu", root=root,
                           bench=bench, driver_kw=bench_tiny.FLEET, log=lambda *a: None)
    assert res["correct"] and set(res["metrics"]) == {"pairs_per_s", "setup_s"}
    assert res["attempted"] == 2
    ctx = harness.Context(counters={"frames": 1})
    assert harness.load_module("metrics", "frames_run.fleet", bench).read(ctx) == 1
