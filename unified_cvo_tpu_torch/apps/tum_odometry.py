"""TUM RGB-D frame-to-frame odometry, the cvo_align_gpu_rgbd twin (port of
unified_cvo_tpu/apps/tum_odometry.py).

Usage:
    python -m unified_cvo_tpu_torch.apps.tum_odometry SEQ_DIR PARAMS.yaml OUT.txt \
        [START_FRAME] [MAX_FRAMES] [--device-frontend]

Writes a TUM-format trajectory (timestamp tx ty tz qx qy qz qw) of
accumulated camera poses. Mirrors src/experiments/main_cvo_gpu_align_rgbd_raw_image.cpp.

Without `--device-frontend` (the JAX package's default) each cloud comes
from the host frontend's port, frontend/pipeline.py::pointcloud_from_rgbd
(FAST selection with the adaptive threshold, backprojection), on the card.
Its denoiser is OpenCV's, as in JAX: where OpenCV is absent (the card's
machine) pass `denoise=False`. `--device-frontend` builds each cloud with
frontend/device.py instead (NL-means, DSO selection, backprojection).

`run_frames` is the loop itself over an iterable of (rgb, depth,
timestamp); `run_sequence` reads the TUM layout and calls it.
"""

from __future__ import annotations

import itertools
import sys

import numpy as np

from unified_cvo_tpu_torch.apps._odometry_common import PairRecord, run_pipelined
from unified_cvo_tpu_torch.config import read_cvo_params_yaml
from unified_cvo_tpu_torch.datasets.tum import TumHandler, write_tum_pose_row
from unified_cvo_tpu_torch.device import resolve_device
from unified_cvo_tpu_torch.frontend.device import device_pointcloud_from_rgbd
from unified_cvo_tpu_torch.frontend.pipeline import pointcloud_from_rgbd

CAPACITY = 16384


def run_frames(
    frames,
    calib,
    params,
    first_params=None,
    out=None,
    start_frame: int = 0,
    denoise: bool = True,
    chunk: int = 4096,
    max_iter: int | None = None,
    device_frontend: bool = False,
    log=print,
    capacity: int = CAPACITY,
    device=None,
):
    """Register an iterable of (rgb, depth, timestamp) frame to frame.

    Writes one TUM row per frame (the first at the identity) to `out` when
    given, and returns (poses [N, 4, 4] float64, timestamps, a PairRecord
    for each pair). `device=None` means the card."""
    dev = resolve_device(device)
    first_params = params.first_frame() if first_params is None else first_params

    def build_cloud(rgb, depth):
        if device_frontend:
            return device_pointcloud_from_rgbd(rgb, depth, calib, capacity=capacity,
                                               denoise=denoise, device=dev)
        return pointcloud_from_rgbd(rgb, depth, calib, denoise=denoise, capacity=capacity,
                                    device=dev)

    it = iter(frames)
    first = next(it, None)
    if first is None:
        raise RuntimeError("empty sequence")
    source = build_cloud(first[0], first[1])
    accum = np.eye(4, dtype=np.float64)
    if out is not None:
        write_tum_pose_row(out, first[2], accum)
    poses, timestamps, records = [accum.copy()], [first[2]], []

    def read_target(i):
        frame = next(it, None)
        return None if frame is None else (build_cloud(frame[0], frame[1]), frame[2])

    def on_result(i, result, ret, info, ts, t_frontend, t_block):
        nonlocal accum
        accum = accum @ result
        poses.append(accum.copy())
        timestamps.append(ts)
        records.append(PairRecord(info, ret, t_frontend, t_block))
        if out is not None:
            write_tum_pose_row(out, ts, accum)
        log(f"frame {i}->{i+1}: iters={int(info.iterations)} "
            f"ell={float(info.final_ell):.3f} host_reads={info.host_reads} "
            f"wait={t_block:.2f}s")

    n_aligned, total_block = run_pipelined(
        source, itertools.count(start_frame), read_target, params, first_params,
        on_result, chunk=chunk, max_iter=max_iter, device=dev)
    log(f"Average registration time is {total_block / max(n_aligned, 1):.3f}")
    return np.asarray(poses), timestamps, records


def run_sequence(
    seq_dir: str,
    param_file: str,
    out_path: str,
    start_frame: int = 0,
    max_frames: int = 100000,
    denoise: bool = True,
    chunk: int = 4096,
    max_iter: int | None = None,
    device_frontend: bool = False,
    log=print,
    capacity: int = CAPACITY,
    device=None,
):
    """The JAX driver's signature. Returns (poses, timestamps)."""
    tum = TumHandler(seq_dir)
    calib = tum.calibration()
    params = read_cvo_params_yaml(param_file)
    tum.set_start_index(start_frame)
    n_frames = min(len(tum), start_frame + max_frames)

    def frames():
        while tum.curr_index < n_frames:
            pair = tum.read_next_rgbd()
            if pair is None:
                return
            yield pair[0], pair[1], tum.timestamp()
            tum.next()

    with open(out_path, "w") as out:
        poses, timestamps, _ = run_frames(
            frames(), calib, params, out=out, start_frame=start_frame, denoise=denoise,
            chunk=chunk, max_iter=max_iter, device_frontend=device_frontend, log=log,
            capacity=capacity, device=device)
    return poses, timestamps


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device_frontend = "--device-frontend" in argv
    argv = [a for a in argv if a != "--device-frontend"]
    if len(argv) < 3:
        print(__doc__)
        return 1
    run_sequence(
        argv[0], argv[1], argv[2],
        int(argv[3]) if len(argv) > 3 else 0,
        int(argv[4]) if len(argv) > 4 else 100000,
        device_frontend=device_frontend,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
