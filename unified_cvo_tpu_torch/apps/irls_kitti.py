"""KITTI multiframe IRLS BA over a frame graph — the cvo_irls_kitti twin
(port of unified_cvo_tpu/apps/irls_kitti.py).

Usage:
    python -m unified_cvo_tpu_torch.apps.irls_kitti SEQ_DIR PARAMS.yaml GRAPH_FILE \
        OUT_PREFIX [TRACKING_TRAJ.txt] [GT_TRAJ.txt]

Mirrors src/experiments/main_multi_frame_irls_kitti.cpp:185-425: load the
graph file's stereo frames, build voxel-downsampled edge (leaf/5) + surface
(leaf) clouds, initialise poses from the graph file (or rows of a tracking
trajectory), run multiframe IRLS, and write KITTI-format trajectories
<OUT_PREFIX>_before.txt / _after.txt. With GT_TRAJ the matching ground-truth
subset is written to <OUT_PREFIX>_gt.txt (the reference's gt_poses.txt).

Each frame's disparity (the native census-SGM) and both clouds are built on
`device` (None means the card), the voxel downsample runs on the host, as
in JAX. JAX computes the disparity once for each of the two clouds; here it
is computed once a frame and given to both (the same values).
"""

from __future__ import annotations

import sys

import numpy as np

from unified_cvo_tpu_torch.apps._ba_common import (
    downsample_edge_surface,
    read_pose_rows_subset,
    write_kitti_traj,
)
from unified_cvo_tpu_torch.config import read_cvo_params_yaml
from unified_cvo_tpu_torch.datasets.graph import read_graph_file
from unified_cvo_tpu_torch.datasets.kitti import KittiHandler
from unified_cvo_tpu_torch.device import resolve_device
from unified_cvo_tpu_torch.frontend import selector as sel
from unified_cvo_tpu_torch.frontend.pipeline import pointcloud_from_stereo
from unified_cvo_tpu_torch.frontend.stereo import compute_disparity
from unified_cvo_tpu_torch.models import irls


def build_frame_cloud(left, right, calib, voxel_edge, voxel_surface, bucket=1024,
                      device=None):
    """Stereo edge+surface BA cloud (main_multi_frame_irls_kitti.cpp:236-295:
    DSO_EDGES at leaf/5 + FULL at leaf), without denoising."""
    dev = resolve_device(device)
    disp = compute_disparity(left, right, device=dev)
    pc_edge = pointcloud_from_stereo(left, right, calib, method=sel.DSO_EDGES, denoise=False,
                                     bucket=64, disparity=disp, device=dev)
    pc_full = pointcloud_from_stereo(left, right, calib, method=sel.FULL, denoise=False,
                                     bucket=64, disparity=disp, device=dev)
    return downsample_edge_surface(pc_edge, pc_full, voxel_edge, voxel_surface, bucket,
                                   device=dev)


def main(argv=None, device=None, log=print):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 4:
        print(__doc__)
        return 1
    seq_dir, param_file, graph_file, out_prefix = argv[:4]
    tracking_file = argv[4] if len(argv) > 4 else None
    gt_file = argv[5] if len(argv) > 5 else None

    frame_inds, edges, init_poses = read_graph_file(graph_file)
    params = read_cvo_params_yaml(param_file)
    kitti = KittiHandler(seq_dir, "stereo")
    calib = kitti.calibration()

    voxel = params.multiframe_downsample_voxel_size
    clouds = []
    for fid in frame_inds:
        kitti.set_start_index(fid)
        pair = kitti.read_next_stereo()
        if pair is None:
            raise RuntimeError(f"frame {fid} unreadable")
        clouds.append(build_frame_cloud(pair[0], pair[1], calib, voxel / 5.0, voxel,
                                        device=device))
        log(f"frame {fid}: {int(clouds[-1].mask.sum())} points")

    F = len(frame_inds)
    if init_poses is not None:
        init = init_poses.astype(np.float32)
    elif tracking_file is not None:
        init = read_pose_rows_subset(tracking_file, frame_inds)
    else:
        init = np.tile(np.eye(3, 4, dtype=np.float32), (F, 1, 1))

    if gt_file is not None:
        write_kitti_traj(out_prefix + "_gt.txt", read_pose_rows_subset(gt_file, frame_inds))

    write_kitti_traj(out_prefix + "_before.txt", init)
    stacked = irls.stack_clouds(clouds)
    poses, hist = irls.irls_solve(
        stacked, init, edges, [True] + [False] * (F - 1), params,
        chunk=min(1024, stacked.xyz.shape[1]), log=log, device=device,
    )
    write_kitti_traj(out_prefix + "_after.txt", poses)
    log(f"wrote {out_prefix}_before.txt / _after.txt ({len(hist)} solve rounds)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
