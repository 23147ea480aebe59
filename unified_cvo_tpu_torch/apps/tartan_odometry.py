"""TartanAir RGB-D frame-to-frame odometry — the cvo_align_gpu_rgbd_tartan
twin (port of unified_cvo_tpu/apps/tartan_odometry.py).

Usage:
    python -m unified_cvo_tpu_torch.apps.tartan_odometry TRAJ_DIR PARAMS.yaml OUT.txt \
        [START_FRAME] [MAX_FRAMES]

Mirrors src/experiments/main_cvo_gpu_align_tartan.cpp:22-144: per frame,
build an RGB-D point cloud, align against the previous frame with the
previous relative motion as the initial guess, accumulate, and write
`x y z qx qy qz qw` rows (main:55-58) starting with the identity pose.
The first pair uses the *_first_frame parameter swap (main:40-48).

Each cloud comes from the host frontend's port at its defaults (FAST
selection after OpenCV's NL-means, computed by its exact port,
ops/nlm_opencv.py) on `device` (None means the card), and the pairs run
over `_odometry_common.run_pipelined`. `records`, where given, collects a
PairRecord per pair.
"""

from __future__ import annotations

import sys

import numpy as np

from unified_cvo_tpu_torch.apps._ba_common import write_xyzq_traj
from unified_cvo_tpu_torch.apps._odometry_common import PairRecord, run_pipelined
from unified_cvo_tpu_torch.config import read_cvo_params_yaml
from unified_cvo_tpu_torch.datasets.tartanair import TartanAirHandler
from unified_cvo_tpu_torch.device import resolve_device
from unified_cvo_tpu_torch.frontend.pipeline import pointcloud_from_rgbd

CAPACITY = 32768


def run_sequence(traj_dir, param_file, out_path, start_frame=0, max_frames=100000,
                 chunk=4096, max_iter=None, capacity=CAPACITY, log=print, device=None,
                 records=None):
    dev = resolve_device(device)
    tartan = TartanAirHandler(traj_dir)
    calib = tartan.calibration()
    params = read_cvo_params_yaml(param_file)
    first_params = params.first_frame()
    tartan.set_start_index(start_frame)

    pair = tartan.read_next_rgbd()
    if pair is None:
        raise RuntimeError("empty sequence")
    source = pointcloud_from_rgbd(pair[0], pair[1], calib, capacity=capacity, device=dev)

    accum = np.eye(4, dtype=np.float64)
    poses = [accum.copy()]
    n_frames = min(len(tartan), start_frame + max_frames)

    def read_target(i):
        tartan.next()
        pair = tartan.read_next_rgbd()
        if pair is None:
            return None
        return pointcloud_from_rgbd(pair[0], pair[1], calib, capacity=capacity,
                                    device=dev), None

    def on_result(i, result, ret, info, aux, t_frontend, t_block):
        nonlocal accum
        accum = accum @ result
        poses.append(accum.copy())
        if records is not None:
            records.append(PairRecord(info, ret, t_frontend, t_block))
        write_xyzq_traj(out_path, [T[:3, :4] for T in poses])  # flush-style rewrite
        log(f"frame {i}->{i+1}: iters={int(info.iterations)} ret={int(ret)} "
            f"ell={float(info.final_ell):.3f}")

    n_aligned, total_block = run_pipelined(
        source, range(start_frame, n_frames - 1), read_target, params,
        first_params, on_result, chunk=chunk, max_iter=max_iter, device=dev,
    )
    log(f"Average registration time is {total_block / max(n_aligned, 1):.3f}")
    return np.asarray(poses)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        print(__doc__)
        return 1
    traj_dir, param_file, out_path = argv[:3]
    start = int(argv[3]) if len(argv) > 3 else 0
    max_frames = int(argv[4]) if len(argv) > 4 else 100000
    run_sequence(traj_dir, param_file, out_path, start, max_frames)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
