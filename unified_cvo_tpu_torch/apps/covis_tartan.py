"""Co-visibility-map multiframe BA on TartanAir — the cvo_covis_tartan twin
(port of unified_cvo_tpu/apps/covis_tartan.py).

Usage:
    python -m unified_cvo_tpu_torch.apps.covis_tartan TRAJ_DIR PARAMS.yaml GRAPH_FILE \
        NUM_CONST_FRAMES OUT_DIR

Mirrors src/experiments/main_covisMap_test.cpp:220-565: load the co-visibility
graph's RGB-D frames, build voxel-downsampled edge (leaf/10) + surface (leaf)
clouds, export the stacked world-frame map before BA, run multiframe IRLS with
the first NUM_CONST_FRAMES poses held constant, and export the map after BA.
Outputs in OUT_DIR: before_BA.pcd / after_BA.pcd (merged world-frame clouds),
traj_before.txt / traj_after.txt (`x y z qx qy qz qw` rows), and one
<frame_id>.pcd per downsampled frame cloud (main:337 writes the same).
Clouds and the solve run on `device` (None means the card); the PCDs are
written by the port's `datasets/pcd.py`.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from unified_cvo_tpu_torch.apps._ba_common import (
    build_frame_cloud,
    merged_map_xyz_rgb,
    write_xyzq_traj,
)
from unified_cvo_tpu_torch.config import read_cvo_params_yaml
from unified_cvo_tpu_torch.datasets.graph import read_graph_file
from unified_cvo_tpu_torch.datasets.pcd import write_pcd
from unified_cvo_tpu_torch.datasets.tartanair import TartanAirHandler
from unified_cvo_tpu_torch.models import irls
from unified_cvo_tpu_torch.utils.pointcloud import to_numpy_valid


def main(argv=None, device=None, log=print):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 5:
        print(__doc__)
        return 1
    traj_dir, param_file, graph_file, n_const, out_dir = argv[:5]
    n_const = int(n_const)
    os.makedirs(out_dir, exist_ok=True)

    frame_inds, edges, init_poses = read_graph_file(graph_file)
    params = read_cvo_params_yaml(param_file)
    tartan = TartanAirHandler(traj_dir)
    calib = tartan.calibration()

    voxel = params.multiframe_downsample_voxel_size
    clouds = []
    for fid in frame_inds:
        tartan.set_start_index(fid)
        pair = tartan.read_next_rgbd()
        if pair is None:
            raise RuntimeError(f"frame {fid} unreadable")
        pc = build_frame_cloud(pair[0], pair[1], calib, voxel / 10.0, voxel, device=device)
        clouds.append(pc)
        d = to_numpy_valid(pc)
        rgb = None
        if d.get("features") is not None and d["features"].shape[1] >= 3:
            rgb = np.clip(d["features"][:, :3] * 255.0, 0, 255).astype(np.uint8)
        write_pcd(os.path.join(out_dir, f"{fid}.pcd"), d["xyz"], rgb)
        log(f"frame {fid}: {len(d['xyz'])} points")

    F = len(frame_inds)
    init = (
        init_poses.astype(np.float32)
        if init_poses is not None
        else np.tile(np.eye(3, 4, dtype=np.float32), (F, 1, 1))
    )

    write_xyzq_traj(os.path.join(out_dir, "traj_before.txt"), init)
    xyz, rgb = merged_map_xyz_rgb(clouds, init)
    write_pcd(os.path.join(out_dir, "before_BA.pcd"), xyz, rgb)

    pivots = [i < n_const for i in range(F)]
    stacked = irls.stack_clouds(clouds)
    poses, hist = irls.irls_solve(
        stacked, init, edges, pivots, params,
        chunk=min(1024, stacked.xyz.shape[1]), log=log, device=device,
    )

    write_xyzq_traj(os.path.join(out_dir, "traj_after.txt"), poses)
    xyz, rgb = merged_map_xyz_rgb(clouds, poses)
    write_pcd(os.path.join(out_dir, "after_BA.pcd"), xyz, rgb)
    log(f"wrote {out_dir}/before_BA.pcd, after_BA.pcd ({len(hist)} solve rounds)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
