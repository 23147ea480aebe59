"""Tiny sizes at which the CPU tests drive each cell: the package's plain
PyTorch versions of its kernels run on the CPU, the harness and the
reference are the ones the card runs."""

import time

import harness

# 4096 points is the smallest cloud the ELL backend takes (resolve_backend)
FLEET = dict(traffic=dict(drives=2, points=4096, pairs=2), max_iter=150)
# a quarter of the KITTI camera's focal length on a 320 x 180 crop
STEREO = dict(traffic=dict(pairs=2),
              camera=dict(fx=179.714, fy=179.714, cx=151.7982, cy=86.3039, cols=320, rows=180))
TINY = {"geo16k-fleet32": FLEET, "stereo-frontend": STEREO}


SPEC = harness.with_pending(harness.load_spec())


def run(cell, seed=1234567, seconds=0.0, **kw):
    """One run of `cell` (of BENCHMARK.json or pending/) on the CPU at its
    tiny size; returns the result."""
    return harness.run_cell(cell, seed, seconds, False, time.perf_counter(), device="cpu",
                            driver_kw=dict(TINY[cell], **kw), log=lambda *a: None, spec=SPEC)
