"""Lyft L5 lidar frame-to-frame odometry, the cvo_align_gpu_lidar_lyft twin
(port of unified_cvo_tpu/apps/lyft_lidar_odometry.py).

Usage:
    python -m unified_cvo_tpu_torch.apps.lyft_lidar_odometry DATA_DIR PARAMS.yaml \
        OUT.txt [START_FRAME] [MAX_FRAMES]

Mirrors src/experiments/main_cvo_gpu_lidar_lyft.cpp:20-144: per frame, build
an intensity-feature lidar cloud on the card, align frame-to-frame,
accumulate KITTI rows starting with the identity row. The reference
hardcodes a wide lengthscale for the sparse Lyft sweeps (ell_init=1.0,
ell_max=2.2, main:41-45); the same override is applied here, and the first
pair runs the same parameters as the others (no first-frame swap).
"""

from __future__ import annotations

import sys

from unified_cvo_tpu_torch.apps import kitti_lidar_odometry
from unified_cvo_tpu_torch.config import read_cvo_params_yaml
from unified_cvo_tpu_torch.datasets.lyft import LyftHandler
from unified_cvo_tpu_torch.device import resolve_device

CAPACITY = 16384


def run_sequence(data_dir, param_file, out_path, start_frame=0, max_frames=100000,
                 chunk=4096, max_iter=None, capacity=CAPACITY, log=print, device=None,
                 records=None):
    """Returns the poses; `records`, a list, receives each pair's PairRecord."""
    dev = resolve_device(device)
    lyft = LyftHandler(data_dir)
    params = read_cvo_params_yaml(param_file).replace(ell_init=1.0, ell_max=2.2)
    lyft.set_start_index(start_frame)
    n_frames = min(len(lyft), start_frame + max_frames)

    def scans():
        while lyft.curr_index < n_frames:
            pts = lyft.read_next_lidar()
            if pts is None:
                return
            yield pts
            lyft.next()

    with open(out_path, "w") as out:
        out.write("1 0 0 0 0 1 0 0 0 0 1 0\n")
        out.flush()
        poses, recs = kitti_lidar_odometry.run_frames(
            scans(), params, first_params=params, out=out, start_frame=start_frame,
            chunk=chunk, max_iter=max_iter, log=log, capacity=capacity, device=dev)
    if records is not None:
        records.extend(recs)
    return poses


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        print(__doc__)
        return 1
    data_dir, param_file, out_path = argv[:3]
    start = int(argv[3]) if len(argv) > 3 else 0
    max_frames = int(argv[4]) if len(argv) > 4 else 100000
    run_sequence(data_dir, param_file, out_path, start, max_frames)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
