"""Measurement builds of L2 (csrc/lidar.cu's loam_features_kernel) on the
card: the block size (LOAM_THREADS, one block a ring) at 128, 256, 512
(as built) and 1024 threads, each checked against the plain version
(torch.equal), and builds that stop early, for where a ring's time goes
(times only: their outputs are not final): the launch alone (the kernel
returns at once), the prologue alone (compaction, curvature, marks; no
sector), and the sectors without their rounds. Each build is timed as one
launch and as each ring launched alone (the slowest is the latency
floor), on phase 13's frame 0 (64 x 1800) and on chip_smoke.py's L2 rings
(`loam_rings`) at 64 x 3400. Each variant is a copy of the sources under
build/loam_ablation/ with `-D` flags or one piece of text replaced, built
by nvcc with the package's flags (all at once) and loaded with ctypes.

    python3 tests/torch_loam_ablation.py      # on a machine with the card

Prints the card, each build's registers and spills and one JSON line per
input (ms a launch and latency floor per build); exits 1 if a build that
is not times-only disagrees with the plain version.
"""

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from unified_cvo_tpu_torch.frontend import lidar as fl  # noqa: E402
from unified_cvo_tpu_torch.ops import cuda_lib  # noqa: E402
from unified_cvo_tpu_torch.ops import lidar as lops  # noqa: E402
from unified_cvo_tpu_torch.utils import synth  # noqa: E402

CSRC = ROOT / "unified_cvo_tpu_torch" / "csrc"
OUT = ROOT / "build" / "loam_ablation"

SECTORS = "  for (int s = 0; s < N_SECTORS; ++s) {\n"
ROUNDS = "round < MAX_CORNERS; ++round) {"
BODY = "  extern __shared__ __align__(16) unsigned char smem[];\n"
BARRIERS_ONLY = "\n      __syncthreads();\n      continue;"     # no candidate decided: 20 rounds
# name: (-D flags, [(text in lidar.cu, replacement)])
VARIANTS = {
    "512 threads (as built)": ((), []),
    "128 threads": (("-DLOAM_THREADS=128",), []),
    "256 threads": (("-DLOAM_THREADS=256",), []),
    "1024 threads": (("-DLOAM_THREADS=1024",), []),
    "launch alone": ((), [(BODY, BODY + "  if (cols > 0) return;\n")]),
    "prologue alone": ((), [(SECTORS, SECTORS.replace("N_SECTORS", "0"))]),
    "sectors without rounds": ((), [(ROUNDS, ROUNDS.replace("MAX_CORNERS", "0"))]),
    "20 rounds of barriers alone a sector": ((), [(ROUNDS, ROUNDS + BARRIERS_ONLY)]),
}
TIMES_ONLY = ("launch alone", "prologue alone", "sectors without rounds",
              "20 rounds of barriers alone a sector")


def build_all():
    """Every variant's lidar.cu (a copy, edited) built by nvcc at once;
    {name: CDLL}."""
    procs = {}
    for name, (flags, edits) in VARIANTS.items():
        d = OUT / re.sub(r"\W+", "_", name)
        d.mkdir(parents=True, exist_ok=True)
        text = (CSRC / "lidar.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: the text to replace is not in lidar.cu: {old!r}")
            text = text.replace(old, new)
        (d / "lidar.cu").write_text(text)
        (d / "cc.cuh").write_text((CSRC / "cc.cuh").read_text())
        procs[name] = (d, subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.flags_for("lidar", flags), "-I", str(d), "-o",
             str(d / "liblidar.so"), str(d / "lidar.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        for entry, (regs, spill) in chip_smoke.register_counts(log).items():
            if "loam_features" in entry:
                print(f"{name}: {regs} registers, {spill} bytes spill stores", flush=True)
        libs[name] = ctypes.CDLL(str(d / "liblidar.so"))
    return libs


def launcher(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.cvo_lidar_loam_features
    fn.argtypes = [P, P, P, P, I, I, ctypes.c_double, P]
    fn.restype = I

    def run(ri, keep):
        rows, cols = ri.shape
        kind = torch.empty((rows, cols), dtype=torch.uint8, device=ri.device)
        rest = torch.empty((rows, lops.N_SECTORS), dtype=torch.int32, device=ri.device)
        cuda_lib.check(fn(ri.data_ptr(), keep.data_ptr(), kind.data_ptr(), rest.data_ptr(), rows,
                          cols, 0.1, torch.cuda.current_stream().cuda_stream), "loam_features")
        return kind, rest
    return run


def inputs(dev):
    traj = synth.corridor_trajectory(1, step=0.15, yaw_rate=0.02, bob=0.0)
    scene = synth.room_scene(11, half=8.0, floor_y=1.8, ceil_y=-3.0, n_pillars=4)
    scan = synth.render_lidar_scan(scene, traj[0], n_beams=chip_smoke.LIDAR_BEAMS,
                                   n_az=chip_smoke.LIDAR_AZ, fov_deg=chip_smoke.LIDAR_FOV,
                                   noise=0.005, seed=0)
    x = torch.from_numpy(np.ascontiguousarray(scan[:, :3])).to(dev)
    ri, ii = fl.project_range_image(x)
    keep = fl.segment_range_image(ri, fl.ground_mask_range_image(x, ii)) & (ii >= 0)
    out = {"phase 13 frame 0 64x1800": (ri, keep)}
    for case in ("dense", "ramp", "random"):
        r, i, seg = chip_smoke.loam_rings(case, chip_smoke.LOAM_ROWS, 3400)
        out[f"{case} 64x3400"] = (torch.from_numpy(r).to(dev),
                                  torch.from_numpy(seg & (i >= 0)).to(dev))
    return out


def main():
    if not torch.cuda.is_available():
        print("torch_loam_ablation: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    runs = {name: launcher(lib) for name, lib in build_all().items()}
    bad = 0
    for what, (ri, keep) in inputs(dev).items():
        plain = lops.loam_features_plain(ri, keep)
        row = {"input": what, "ms": {}, "latency_floor_ms": {}, "equal": {}}
        for name, run in runs.items():
            a, b = run(ri, keep), run(ri, keep)
            torch.cuda.synchronize()
            if name not in TIMES_ONLY:
                same = all(torch.equal(x, y) and torch.equal(x, z) for x, y, z in zip(a, b, plain))
                row["equal"][name] = same
                bad += not same
            row["ms"][name] = chip_smoke.device_ms(lambda: run(ri, keep))
            row["latency_floor_ms"][name] = max(
                chip_smoke.device_ms(lambda i=i: run(ri[i:i + 1], keep[i:i + 1]), reps=10,
                                     trials=1) for i in range(ri.shape[0]))
        print(json.dumps(row), flush=True)
    print(json.dumps({"launch_floor_ms": chip_smoke.launch_floor_ms()}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
