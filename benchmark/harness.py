"""The benchmark's machinery, driven by data: it reads BENCHMARK.json and
finds everything that belongs to one cell by name.

    configs/<config>.json      a configuration (a deployment of the system)
    workloads/<cell>.json      a cell's traffic mix: which generator and
                               driver, their parameters, the limits of its
                               correctness checks
    traffic/<name>.py          a generator of inputs from the seed
    drivers/<name>.py          how a kind of cell drives the measured
                               package (`Driver`: setup, step, check)
    metrics/<metric>.py        a reader of one metric (`read(ctx)`)
    kernels/<map>.json         device kernel names -> the layer they belong to
    work/<name>.py             the work (bytes, operations) a layer needs
    peaks.json                 the chip's published peaks

A run: set-up (imports, inputs from the seed, the cell `Driver`'s warm
pass) is `setup_s`; then its steps run back to back (a closed loop) until
`--seconds` have passed and the step in flight ends; then the peak memory
is read, the package's state freed, and `Driver.check` compares what the
timed steps produced with the plain reference in `reference/`. With
`--trace 1` the `Driver` opens a profiled sub-window (`TraceWindow`) once
`trace_after_s` of the window have passed (the steps before it give the
host-clock readings, untouched by the tracer), the window runs on until
that sub-window has closed, and the per-layer metrics are read; with
`--trace 0` the end-to-end ones.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import statistics
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
# top-level module names that may not be loaded where the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "unified_cvo_tpu")
# how long a traced run's window may run on past --seconds for its profiled
# sub-window to close
TRACE_GRACE_S = 150.0


class BenchError(RuntimeError):
    """A run that cannot produce a result (exit code 2, nothing printed)."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def with_pending(spec: dict, bench: Path = BENCH) -> dict:
    """`spec` with the entries of every pending/*.json appended: cells that
    are written and proved but not in BENCHMARK.json (each file says why).
    calibrate.py and the tests read them; run.py runs BENCHMARK.json's
    cells alone."""
    out = {k: list(v) if isinstance(v, list) else v for k, v in spec.items()}
    for path in sorted((bench / "pending").glob("*.json")):
        extra = load_json(path)
        for group in ("configs", "workloads", "end_to_end", "per_layer"):
            out[group] += extra.get(group, [])
    return out


def load_module(kind: str, name: str, bench: Path = BENCH) -> ModuleType:
    """benchmark/<kind>/<name>.py, loaded by path (names may hold dots)."""
    path = bench / kind / f"{name}.py"
    if not path.exists():
        raise BenchError(f"no {kind} module {path}")
    key = f"_bench_{kind}_{re.sub(r'[^0-9A-Za-z_]', '_', name)}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def find_cell(name: str, spec: dict, root: Path = ROOT):
    """(cell entry, configuration dict, workload dict) of cell `name`."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise BenchError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    workload = load_json(root / "benchmark" / "workloads" / f"{name}.json")
    if workload.get("traffic_name", cell["traffic"]) != cell["traffic"]:
        raise BenchError(f"workloads/{name}.json is not traffic {cell['traffic']!r}")
    return cell, config, workload


def metrics_for(cell_name: str, spec: dict, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on): those whose `workloads` list it, or that have none."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


class KernelMap:
    """Every kernels/*.json: {"layer": key, "patterns": [regex, ...]}. A
    device event belongs to the layer of the first map (in file-name order)
    one of whose patterns it matches; new maps are added, never edited."""

    def __init__(self, bench: Path = BENCH):
        self.maps = []
        for path in sorted((bench / "kernels").glob("*.json")):
            m = load_json(path)
            self.maps.append((m["layer"], [re.compile(p) for p in m["patterns"]]))

    def layer_of(self, name: str) -> Optional[str]:
        for layer, pats in self.maps:
            if any(p.search(name) for p in pats):
                return layer
        return None


class TraceWindow:
    """A profiled sub-window of the timed window: torch.profiler recording
    device activity alone (host events slow a launch-bound loop), opened
    and closed by the cell `Driver` at points of its choosing. Keeps the device
    events as (name, start_us, duration_us) and the window's wall time."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.events: List[tuple] = []
        self.window_s = 0.0
        self.units = 0          # driver units (iterations, frames) inside it
        self._t0 = 0.0
        self.done = False

    def start(self) -> None:
        if not self.enabled or self.prof is not None or self.done:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self._t0 = time.perf_counter()

    @property
    def active(self) -> bool:
        return self.prof is not None

    @property
    def started(self) -> bool:
        """Whether the profiler has run in this process: from its first
        start on, the tracer stays attached and every launch costs more, so
        host-clock readings are taken before it."""
        return self.prof is not None or self.done

    def stop(self) -> None:
        if self.prof is None:
            return
        import torch

        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()
        evs = []
        for e in self.prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                evs.append((e.name, float(e.time_range.start), float(e.time_range.elapsed_us())))
        evs.sort(key=lambda t: t[1])
        self.events = evs
        self.prof = None
        self.done = True

    def busy_us(self) -> float:
        """Union of the device events' intervals."""
        busy, end = 0.0, -math.inf
        for _, s, d in self.events:
            e = s + d
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy

    def breakdown(self, top: int = 10) -> dict:
        per = {}
        for name, _, d in self.events:
            per[name] = per.get(name, 0.0) + d
        ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        end, prev = None, None
        for name, s, d in self.events:
            if end is not None and s > end:
                gaps.append((f"after {prev[:120]}", (s - end) * 1e-6))
            if end is None or s + d > end:
                end, prev = s + d, name
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[n[:160], us * 1e-6] for n, us in ops],
                "idle_gaps": [[n, s] for n, s in gaps[:top]]}


class Spans:
    """Named spans of the benchmark's own: CUDA event pairs around calls
    into the package's stages, read once the window closes."""

    def __init__(self):
        self.pending: Dict[str, list] = {}

    def device(self, name: str, fn: Callable, *a, **kw):
        import torch

        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn(*a, **kw)
        e.record()
        self.pending.setdefault(name, []).append((s, e))
        return out

    def ms(self, name: str) -> List[float]:
        return [s.elapsed_time(e) for s, e in self.pending.get(name, [])]


class Context:
    """What a metric reader sees."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def work(self, name: str) -> ModuleType:
        return load_module("work", name, self.bench)

    def layer_time_us(self, layer: str) -> float:
        return sum(d for n, _, d in self.trace.events if self.kernels.layer_of(n) == layer)

    def unmapped_time_us(self) -> float:
        return sum(d for n, _, d in self.trace.events if self.kernels.layer_of(n) is None)


def rate(ctx) -> float:
    """Units of work completed over the whole window."""
    return sum(r["units"] for r in ctx.records) / ctx.window_s


def percentile(values, q: float) -> float:
    """The q-th percentile of all values (linear between order statistics)."""
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    x = (len(v) - 1) * q / 100.0
    lo = int(math.floor(x))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, clock0: float,
             device: Optional[str] = None, root: Path = ROOT, bench: Path = BENCH,
             driver_kw: Optional[dict] = None, log=None, spec: Optional[dict] = None) -> dict:
    """One run of cell `name` of `spec` (BENCHMARK.json by default);
    returns the result object. `device` None means the card (and requires
    one); the CPU tests pass "cpu"."""
    import torch

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    spec = spec or load_spec(root)
    cell, config, workload = find_cell(name, spec, root)
    if device is None:
        if not torch.cuda.is_available():
            raise BenchError("CUDA is not available")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise BenchError(f"cell {name} needs {cell['chips']} cards, "
                             f"{torch.cuda.device_count()} visible")
        device = "cuda"
    dev = torch.device(device)
    log(f"imports and CUDA {time.perf_counter() - clock0:.3f} s")
    tw = TraceWindow(trace and dev.type == "cuda")
    spans = Spans()
    drv_mod = load_module("drivers", workload["driver"], bench)
    drv = drv_mod.Driver(config=config, workload=workload, seed=seed, device=dev,
                         trace=tw, spans=spans, bench=bench, log=log, **(driver_kw or {}))
    drv.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - clock0
    log(f"set-up {setup_s:.3f} s")
    records = []
    t0 = time.perf_counter()
    while True:
        records.append(drv.step())
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds and (not tw.enabled or tw.done
                                   or elapsed >= seconds + TRACE_GRACE_S):
            break
    tw.stop()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    lat = [r["latency_s"] for r in records]
    log(f"window {window_s:.3f} s, {len(records)} steps, step seconds min {min(lat):.4f} "
        f"median {statistics.median(lat):.4f} max {max(lat):.4f}; host load "
        f"{os.getloadavg() if hasattr(os, 'getloadavg') else 'n/a'}")
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise BenchError(f"modules loaded in the measuring process: {found}")
    counters = drv.counters()
    drv.release()
    t_check = time.perf_counter()
    checks = drv.check()
    log(f"checks {time.perf_counter() - t_check:.3f} s")
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks)
    ctx = Context(records=records, window_s=window_s, setup_s=setup_s, seconds=seconds,
                  trace=tw, spans=spans, counters=counters, config=config,
                  workload=workload, cell=cell, kernels=KernelMap(bench), bench=bench,
                  peaks=load_json(bench / "peaks.json"), memory_peak=memory_peak)
    metrics = {}
    for m in metrics_for(name, spec, trace):
        value = load_module("metrics", m["name"], bench).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "count": int(cell["chips"]), "memory_peak_bytes": int(memory_peak)}
    if trace:
        dev_info["busy_s"] = tw.busy_us() * 1e-6
        dev_info["window_s"] = tw.window_s
    result = {"correct": correct, "attempted": sum(r["units"] for r in records),
              "failed": sum(r.get("failed", 0) for r in records), "metrics": metrics,
              "device": dev_info}
    if trace and tw.events:
        result["breakdown"] = tw.breakdown()
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    found = forbidden_modules()
    if found:
        raise BenchError(f"modules loaded in the measuring process: {found}")
    for c in checks:
        log(f"check {c['name']} {c['value']!r} limit {c['limit']!r}")
    return result


def env_for_checkout(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout, and no
    library loading JAX on its own."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one process, few threads: the host work is launches and small reads
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
