"""Threaded file prefetcher and npy reader (port of the loader and read_npy
of unified_cvo_tpu/native/__init__.py).

The JAX package binds a C++ thread pool (native/cvo_io.cpp) that reads raw
float32 `.bin` scans and `.npy` arrays while the chip registers the frame
before. Here a Python thread pool does the same with `np.fromfile` and
`np.load`, which release the GIL while they read: the same API (`RAW_F32`,
`NPY`, `submit(path, kind) -> ticket`, `get(ticket)`, `close()`), no ctypes
and no C++ at run time. The readers of `datasets/kitti.py` (velodyne scans)
and `datasets/tartanair.py` (depth and segmentation arrays) use it where
JAX's use the native loader.
"""

from __future__ import annotations

import itertools
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def read_npy(path: str) -> np.ndarray:
    """An `.npy` array (the cnpy twin, reference thirdparty/cnpy/cnpy.cpp)."""
    return np.load(path)


class PrefetchLoader:
    """Reads files on `n_workers` threads; `get` waits for a ticket's array
    and hands it over once."""

    RAW_F32 = 0
    NPY = 1

    def __init__(self, n_workers: int = 2):
        self._pool = ThreadPoolExecutor(max_workers=n_workers,
                                        thread_name_prefix="prefetch")
        self._tickets = itertools.count()
        self._pending = {}

    def submit(self, path: str, kind: int) -> int:
        if kind == self.RAW_F32:
            fn = lambda: np.fromfile(path, np.float32)           # noqa: E731
        elif kind == self.NPY:
            fn = lambda: read_npy(path)                          # noqa: E731
        else:
            raise ValueError(f"unknown file kind {kind}")
        ticket = next(self._tickets)
        self._pending[ticket] = self._pool.submit(fn)
        return ticket

    def get(self, ticket: int) -> np.ndarray:
        fut = self._pending.pop(ticket, None)
        if fut is None:
            raise IOError(f"prefetch read failed (ticket {ticket})")
        try:
            return fut.result()
        except OSError as e:
            raise IOError(f"prefetch read failed (ticket {ticket}): {e}") from e

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
            self._pending.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
