"""KITTI lidar frame-to-frame odometry, the cvo_align_gpu_lidar_raw twin
(port of unified_cvo_tpu/apps/kitti_lidar_odometry.py).

Usage:
    python -m unified_cvo_tpu_torch.apps.kitti_lidar_odometry SEQ_DIR PARAMS.yaml OUT.txt \
        [START_FRAME] [MAX_FRAMES] [--semantic]

Mirrors src/experiments/main_cvo_gpu_align_raw_lidar.cpp: per frame, build
an intensity-feature lidar cloud (edge detection + LOAM-lite surfaces, on
the card: frontend/lidar.py), align frame-to-frame with constant-velocity
init, accumulate KITTI rows. With --semantic, per-point SemanticKITTI
labels (<seq>/labels/*.label) are attached as one-hot 19-class
distributions, the semantic-lidar twin (KittiHandler.cpp:154-193;
CvoPointCloud.cpp:1040-1136). `method="legoloam"` of run_frames and
run_sequence selects points with the LeGO-LOAM pipeline instead
(pointcloud_from_lidar's `method`; the JAX driver has no such argument).

Velodyne scans are read with numpy.fromfile, so the driver reads real
sequences on a machine without OpenCV. `run_frames` is the loop itself over
an iterable of scans; `run_sequence` reads the KITTI layout and calls it.
"""

from __future__ import annotations

import itertools
import sys

import numpy as np

from unified_cvo_tpu_torch.apps._odometry_common import PairRecord, run_pipelined
from unified_cvo_tpu_torch.config import read_cvo_params_yaml
from unified_cvo_tpu_torch.datasets.kitti import KittiHandler, write_kitti_pose_row
from unified_cvo_tpu_torch.device import resolve_device
from unified_cvo_tpu_torch.frontend.lidar import pointcloud_from_lidar

CAPACITY = 16384


def run_frames(
    scans,
    params,
    first_params=None,
    out=None,
    start_frame: int = 0,
    chunk: int = 4096,
    max_iter: int | None = None,
    log=print,
    semantic: bool = False,
    num_classes: int = 19,
    capacity: int = CAPACITY,
    method: str = "loam",
    device=None,
):
    """Register an iterable of lidar scans frame to frame: [N, 4] arrays
    (camera-style xyz + intensity), or (points, labels) pairs with
    `semantic`. Writes one KITTI row per aligned frame to `out` when given
    and returns (poses [N, 4, 4] float64, a PairRecord for each pair).
    `first_params` defaults to `params.first_frame()`; `device=None` means
    the card."""
    dev = resolve_device(device)
    first_params = params.first_frame() if first_params is None else first_params

    def build_cloud(scan):
        if semantic:
            pts, labels = scan
            return pointcloud_from_lidar(pts, semantics=labels, num_classes=num_classes,
                                         capacity=capacity, method=method, device=dev)
        return pointcloud_from_lidar(scan, capacity=capacity, method=method, device=dev)

    it = iter(scans)
    first = next(it, None)
    if first is None:
        raise RuntimeError("empty sequence")
    source = build_cloud(first)
    accum = np.eye(4, dtype=np.float64)
    poses, records = [accum.copy()], []

    def read_target(i):
        scan = next(it, None)
        return None if scan is None else (build_cloud(scan), None)

    def on_result(i, result, ret, info, aux, t_frontend, t_block):
        nonlocal accum
        accum = accum @ result
        poses.append(accum.copy())
        records.append(PairRecord(info, ret, t_frontend, t_block))
        if out is not None:
            write_kitti_pose_row(out, accum)
        log(f"frame {i}->{i+1}: iters={int(info.iterations)} ret={int(ret)} "
            f"ell={float(info.final_ell):.3f} frontend={t_frontend:.2f}s wait={t_block:.2f}s")

    n_aligned, total_block = run_pipelined(
        source, itertools.count(start_frame), read_target, params, first_params,
        on_result, chunk=chunk, max_iter=max_iter, device=dev)
    log(f"Average registration time is {total_block / max(n_aligned, 1):.3f}")
    return np.asarray(poses), records


def run_sequence(seq_dir, param_file, out_path, start_frame=0, max_frames=100000,
                 chunk=4096, max_iter=None, log=print, semantic=False,
                 num_classes=19, capacity=CAPACITY, method="loam", device=None,
                 records=None):
    """With semantic=True, per-point SemanticKITTI labels are read from
    <seq>/labels/*.label and attached as one-hot distributions, the
    semantic-lidar pipeline (KittiHandler.cpp read_next_lidar semantic
    overload; semantic CvoPointCloud ctor, CvoPointCloud.cpp:1040-1136).
    Returns the poses; `records`, a list, receives each pair's PairRecord."""
    dev = resolve_device(device)
    kitti = KittiHandler(seq_dir, "lidar")
    params = read_cvo_params_yaml(param_file)
    kitti.set_start_index(start_frame)
    n_frames = min(len(kitti), start_frame + max_frames)

    def scans():
        while kitti.curr_index < n_frames:
            scan = (kitti.read_next_lidar_semantic(num_classes) if semantic
                    else kitti.read_next_lidar())
            if scan is None:
                return
            yield scan
            kitti.next()

    with open(out_path, "w") as out:
        out.write("1 0 0 0 0 1 0 0 0 0 1 0\n")
        out.flush()
        poses, recs = run_frames(scans(), params, out=out, start_frame=start_frame,
                                 chunk=chunk, max_iter=max_iter, log=log, semantic=semantic,
                                 num_classes=num_classes, capacity=capacity, method=method,
                                 device=dev)
    if records is not None:
        records.extend(recs)
    return poses


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    semantic = "--semantic" in argv
    argv = [a for a in argv if a != "--semantic"]
    if len(argv) < 3:
        print(__doc__)
        return 1
    run_sequence(argv[0], argv[1], argv[2],
                 int(argv[3]) if len(argv) > 3 else 0,
                 int(argv[4]) if len(argv) > 4 else 100000,
                 semantic=semantic)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
