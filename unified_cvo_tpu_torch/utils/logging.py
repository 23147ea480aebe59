"""Structured observability: jsonl metrics and phase timers (port of
unified_cvo_tpu/utils/logging.py).

Replaces the reference's per-iteration text-file dumps (ell_history.txt,
transformation_history.txt, nonzeros.txt ... CvoGPU.cu:1350-1361,
IRLS.cpp:83-84) with structured jsonl rows, and the CUDA-event timing
brackets (CvoGPU.cu:1368-1371) with synchronised phase timers.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Optional

import torch


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
