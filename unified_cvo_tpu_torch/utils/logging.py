"""Structured observability: jsonl metrics and phase timers (port of
unified_cvo_tpu/utils/logging.py).

Replaces the reference's per-iteration text-file dumps (ell_history.txt,
transformation_history.txt, nonzeros.txt ... CvoGPU.cu:1350-1361,
IRLS.cpp:83-84) with structured jsonl rows, and the CUDA-event timing
brackets (CvoGPU.cu:1368-1371) with synchronised phase timers, a
torch.profiler trace context and a NaN check on every op (the JAX package's
jax.profiler trace and jax_debug_nans).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from unified_cvo_tpu_torch.device import resolve_device


class MetricsLogger:
    """Append-only jsonl metrics stream."""

    def __init__(self, path: Optional[str]):
        self._f = open(path, "a") if path else None

    def log(self, **row):
        if self._f is None:
            return
        row.setdefault("t", time.time())
        self._f.write(json.dumps(row, default=float) + "\n")
        self._f.flush()

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


def _sync_of(sync):
    """A callable that waits for the phase's device work: `sync` itself when
    it is callable, the tensor's device when it is a tensor."""
    if sync is None or callable(sync):
        return sync
    if isinstance(sync, torch.Tensor):
        if sync.is_cuda:
            return lambda: torch.cuda.synchronize(sync.device)
        return None
    raise TypeError(f"sync must be a callable or a tensor, not {type(sync).__name__}")


@contextlib.contextmanager
def phase_timer(name: str, logger: Optional[MetricsLogger] = None, sync=None):
    """Wall-clock bracket. `sync` waits for the phase's device work before
    the clock stops: a callable (typically `torch.cuda.synchronize`) or a
    tensor the phase produced (its device is synchronised; a CPU tensor is
    ready already)."""
    wait = _sync_of(sync)
    t0 = time.time()
    yield
    if wait is not None:
        wait()
    dt = time.time() - t0
    if logger:
        logger.log(phase=name, seconds=dt)


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str], device=None):
    """torch.profiler trace of the block (JAX: jax.profiler), written as a
    Chrome trace `trace-<ns>.json` into `log_dir` on exit; CPU activity, and
    the card's where `device` (None means the card) is CUDA. Yields the
    trace's path; a no-op yielding None when `log_dir` is None."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace-{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield path
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(path)


_nan_checks = [False]


class _NanCheck(TorchDispatchMode):
    """Raises FloatingPointError where an op's floating output holds a NaN
    (one device sync an op: a debugging aid, never on a measured path)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _nan_checks[0]:
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
                        and bool(torch.isnan(t).any())):
                    raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """jax_debug_nans for torch: inside the context, any op that produces a
    NaN in a floating output raises FloatingPointError (an Inf alone does
    not, as in JAX). `enable=False` turns an enclosing check off; leaving
    the context restores the previous state."""
    prev = _nan_checks[0]
    _nan_checks[0] = bool(enable)
    try:
        if enable and not prev:
            with _NanCheck():
                yield
        else:
            yield
    finally:
        _nan_checks[0] = prev
