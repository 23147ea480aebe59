"""Build and load the port's CUDA sources (csrc/*.cu) as plain-C shared
libraries through ctypes.

Each source is compiled by nvcc for sm_90a into `build/unified_cvo_tpu_torch/`
beside the package, under a name keyed by a hash of the sources and of the
source's own compiler flags, at first use. `build_all` starts one nvcc per source at once. Nothing here
runs at import time, so the CPU tests import every module without a CUDA
toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "unified_cvo_tpu_torch"
SOURCES = ("select", "ell", "dense", "lidar", "image", "sgm")

# -fmad=false: every multiply and add rounds on its own, as the plain
# PyTorch versions' separate ops do (no --use_fast_math, ever)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas=-v")

# dense.cu writes the chain that decides a gate with __fmul_rn / __fadd_rn,
# which are never contracted, and lets everything else fuse
SOURCE_FLAGS = {"dense": tuple(f for f in NVCC_FLAGS if f != "-fmad=false")}

_loaded: Dict[str, ctypes.CDLL] = {}


def flags_for(name: str, extra: Iterable[str] = ()) -> tuple:
    """nvcc flags of csrc/<name>.cu, then `extra` (a measurement build's
    -D switches)."""
    return (*SOURCE_FLAGS.get(name, NVCC_FLAGS), *extra)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def lib_path(name: str, extra: Iterable[str] = ()) -> Path:
    h = hashlib.sha256(" ".join(flags_for(name, extra)).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None,
              extra: Iterable[str] = ()) -> Dict[str, str]:
    """Compile every source not yet built, all nvcc processes at once.
    Returns the compiler's resource report (ptxas -v) per source built now;
    raises RuntimeError with the compiler output if any build fails."""
    extra = tuple(extra)
    todo = [n for n in (SOURCES if names is None else names)
            if not lib_path(n, extra).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        out = lib_path(name, extra)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *flags_for(name, extra), "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        report_path(name, extra).write_text(log)
        reports[name] = log
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return reports


def report_path(name: str, extra: Iterable[str] = ()) -> Path:
    """Where the compiler's resource report (ptxas -v) of a build is kept,
    beside its library."""
    return lib_path(name, extra).with_suffix(".ptxas.txt")


def build_report(name: str, extra: Iterable[str] = ()) -> str:
    """The resource report of a build of csrc/<name>.cu, built now or
    earlier; empty if it was never built here."""
    path = report_path(name, tuple(extra))
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _loaded[name] = lib
    return lib


def load_variant(name: str, extra: Iterable[str]) -> ctypes.CDLL:
    """A measurement build of csrc/<name>.cu with `extra` flags appended,
    loaded beside the package's own build and never returned by `load`."""
    extra = tuple(extra)
    build_all([name], extra)
    return ctypes.CDLL(str(lib_path(name, extra)))


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def check_tensor(t, name: str, dtype, shape, device, who: str) -> None:
    """Raise unless `t` is what a kernel takes: a contiguous tensor of this
    dtype and shape on this device (kernels read raw pointers)."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{who}: {name} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")
