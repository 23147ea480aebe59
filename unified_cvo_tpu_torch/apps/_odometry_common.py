"""Shared frame-to-frame odometry loop of the app drivers (port of
unified_cvo_tpu/apps/_odometry_common.py).

The reference drivers (e.g. main_cvo_gpu_align_raw_image.cpp:73-163) run
front-end and registration strictly serialized. Here the constant-velocity
warm start chains on the device (the inverse of the previous result,
update_tf convention CvoGPU.cu:94-112) with no host round trip on the guess
path, and the frontend of the next frame is enqueued on the device behind
the current alignment.

Results are fetched in batches of `fetch_depth` frames: the trajectory rows
are flushed every `fetch_depth` frames instead of every frame, and the
reference's resume-from-any-index contract holds at that granularity. The
port's align reads one small flag tensor back each iteration
(`AlignInfo.host_reads`), so it returns once the device has finished the
pair: the blocking time of a pair is the align call's wall time plus its
share of the batch's fetch.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from unified_cvo_tpu_torch.device import resolve_device
from unified_cvo_tpu_torch.models.align import AlignInfo, align
from unified_cvo_tpu_torch.ops import lie


class PairRecord(NamedTuple):
    """What the drivers' run_frames keep of each aligned pair."""

    info: AlignInfo           # its tensors on the host
    ret: int                  # -1 after a degenerate flow
    frontend_seconds: float   # host time to read and enqueue the target's frontend
    wait_seconds: float       # time spent waiting on the device for the alignment


def _inv44(T: torch.Tensor) -> torch.Tensor:
    return lie.rt_to_mat44(*lie.invert_rt(*lie.mat44_to_rt(T)))


def _host(x):
    return x.cpu() if isinstance(x, torch.Tensor) else x


def run_pipelined(
    source,
    frame_indices,
    read_target,
    params,
    first_params,
    on_result,
    chunk: int = 4096,
    max_iter=None,
    align_kwargs=None,
    fetch_depth: int = 8,
    device=None,
):
    """Drive the odometry pipeline on `device` (None means the card).

    source: cloud of the first frame.
    frame_indices: iterable of pair indices i (align frame i -> i+1).
    read_target(i): advance the handler and return (PointCloud, aux) for
        frame i+1, or None at end of sequence.
    on_result(i, result_f64, ret, info, aux, t_frontend, t_block): called in
        frame order once each alignment's result is fetched. `info` arrives
        with its tensors on the host (fetched in the batch).
    fetch_depth: results fetched (and trajectory rows flushed) every this
        many frames.

    Returns (n_aligned, total_block_seconds): the wall time spent waiting on
    the device for the alignments (align calls and fetches)."""
    dev = resolve_device(device)
    align_kwargs = align_kwargs or {}
    guess = torch.eye(4, dtype=torch.float32, device=dev)
    pending = []
    n_aligned = 0
    total_block = 0.0
    first_i = None

    def resolve_batch():
        nonlocal n_aligned, total_block
        if not pending:
            return
        t0 = time.time()
        fetched = [(T.cpu(), int(ret), info._replace(**{
            k: _host(v) for k, v in info._asdict().items()}))
            for _, T, ret, info, _, _, _ in pending]
        per = (time.time() - t0) / len(pending)
        for (i, _, _, _, t_frontend, t_align, aux), (T, ret, info) in zip(pending, fetched):
            n_aligned += 1
            total_block += t_align + per
            on_result(i, T.numpy().astype(np.float64), ret, info, aux, t_frontend,
                      t_align + per)
        pending.clear()

    for i in frame_indices:
        if first_i is None:
            first_i = i
        t0 = time.time()
        ta = read_target(i)
        if ta is None:
            break
        target, aux = ta
        t_frontend = time.time() - t0
        p = first_params if i == first_i else params
        t0 = time.time()
        T_dev, ret_dev, info = align(source, target, guess, p, device=dev, chunk=chunk,
                                     max_iter=max_iter, **align_kwargs)
        t_align = time.time() - t0
        guess = _inv44(T_dev)  # device-resident constant-velocity warm start
        pending.append((i, T_dev, ret_dev, info, t_frontend, t_align, aux))
        if len(pending) >= max(fetch_depth, 1):
            resolve_batch()
        source = target
    resolve_batch()
    return n_aligned, total_block
