"""Measurement builds of the union-find kernels (csrc/cc.cuh through
csrc/lidar.cu's L1 and csrc/image.cu's components8) on the card: the
design as built beside variants that each undo one of its choices, timed
on chip_smoke.py's `cc_inputs` (the main paths' inputs and the fixed cases)
and checked against the plain versions.

Variants: the tile height (32 x 8 and 32 x 32 tiles against the built
32 x 16); finds in the tile pass that do not halve their paths; compress
with every thread halving (no one-atomic-per-node election in the warp);
compress halving by plain stores (a race: a store can land on a cell after
its own thread wrote its root, so this one is expected to give wrong
labels); the tile pass alone and the tile and border passes alone (the
labels are then not final: times only). Each variant is a copy of the
sources under build/cc_ablation/ with one piece of text replaced, built by
nvcc with the package's flags and loaded with ctypes.

    python3 tests/torch_cc_ablation.py      # on a machine with the card

Prints the card, each variant's ptxas lines, one JSON line per input (ms
and whether the labels equal the plain version's, per variant) and the
launch floor; exits 1 if the build as it stands disagrees with the plain
versions or a replaced text is not found.
"""

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from unified_cvo_tpu_torch.ops import canny, cuda_lib  # noqa: E402
from unified_cvo_tpu_torch.ops import lidar as lops  # noqa: E402

CSRC = ROOT / "unified_cvo_tpu_torch" / "csrc"
OUT = ROOT / "build" / "cc_ablation"

ELECTED = """    const unsigned peers = __match_any_sync(__activemask(), x);
    if ((int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicMin(parent + x, g);
"""
HALVING_FIND = """    const int g = vs[p];
    if (g == p) return p;
    atomicMin(s + x, g);
    x = g;
"""
PLAIN_FIND = """    x = p;
"""
# (file, text in it, replacement) for each variant
VARIANTS = {
    "as built": [],
    "tiles 32 x 8": [("cc.cuh", "constexpr int TILE_H = 16;", "constexpr int TILE_H = 8;")],
    "tiles 32 x 32": [("cc.cuh", "constexpr int TILE_H = 16;", "constexpr int TILE_H = 32;")],
    "tile finds without halving": [("cc.cuh", HALVING_FIND, PLAIN_FIND)],
    "compress: every thread halves": [("cc.cuh", ELECTED, "    atomicMin(parent + x, g);\n")],
    "compress: halving by plain stores": [("cc.cuh", ELECTED, "    parent[x] = g;\n")],
    "tile pass alone": [("lidar.cu", "  cc_border4<<<", "  if (0) cc_border4<<<"),
                        ("lidar.cu", "  cc::compress<<<", "  if (0) cc::compress<<<"),
                        ("image.cu", "  cc_border8<<<", "  if (0) cc_border8<<<"),
                        ("image.cu", "  cc::compress<<<", "  if (0) cc::compress<<<")],
    "tile and border passes alone": [("lidar.cu", "  cc::compress<<<", "  if (0) cc::compress<<<"),
                                     ("image.cu", "  cc::compress<<<", "  if (0) cc::compress<<<")],
}
TIMES_ONLY = ("tile pass alone", "tile and border passes alone")


def build(name, edits):
    """Copies of cc.cuh, lidar.cu and image.cu with `edits` applied, each .cu
    built by nvcc (all at once); {"lidar": CDLL, "image": CDLL}."""
    d = OUT / re.sub(r"\W+", "_", name)
    d.mkdir(parents=True, exist_ok=True)
    texts = {f: (CSRC / f).read_text() for f in ("cc.cuh", "lidar.cu", "image.cu")}
    for f, old, new in edits:
        if old not in texts[f]:
            raise SystemExit(f"{name}: the text to replace is not in {f}: {old!r}")
        texts[f] = texts[f].replace(old, new)
    for f, text in texts.items():
        (d / f).write_text(text)
    procs = {src: subprocess.Popen(
        [cuda_lib._nvcc(), *cuda_lib.flags_for(src), "-I", str(d), "-o", str(d / f"lib{src}.so"),
         str(d / f"{src}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in ("lidar", "image")}
    libs = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for src, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed on {src}.cu\n{log}")
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"{name}: {src}.cu: {line.strip()}")
        lib = ctypes.CDLL(str(d / f"lib{src}.so"))
        if src == "lidar":
            lib.cvo_lidar_components.argtypes = [P, P, P, I, I, P]
        else:
            lib.cvo_image_components8.argtypes = [P, P, I, I, P]
        libs[src] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_cc_ablation: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    libs = {name: build(name, edits) for name, edits in VARIANTS.items()}
    plain = {"L1": lops.components_plain, "components8": canny.components8_plain}
    bad = False
    for case, (kind, ts) in chip_smoke.cc_inputs(dev).items():
        ts = tuple(t.to(dev) for t in ts)
        rows, cols = ts[-1].shape
        want = plain[kind](*ts)
        row = {}
        for name, lib in libs.items():
            labels = torch.empty((rows, cols), dtype=torch.int32, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            if kind == "L1":
                args = (ts[0].data_ptr(), ts[1].data_ptr(), labels.data_ptr(), rows, cols, stream)
                fn = lib["lidar"].cvo_lidar_components
            else:
                args = (ts[0].data_ptr(), labels.data_ptr(), rows, cols, stream)
                fn = lib["image"].cvo_image_components8

            def run(fn=fn, args=args):
                if fn(*args) != 0:
                    raise SystemExit(f"{name}: launch failed on {case}")

            run()
            torch.cuda.synchronize()
            equal = None if name in TIMES_ONLY else bool(torch.equal(labels, want))
            row[name] = {"ms": chip_smoke.device_ms(run), "equal_to_plain": equal}
            bad |= name == "as built" and not equal
        print(json.dumps({"input": case, "kernel": kind, "variants": row}), flush=True)
    print(json.dumps({"launch_floor_ms": chip_smoke.launch_floor_ms()}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
