"""TartanAir multiframe IRLS BA — the cvo_irls_tartan twin (port of
unified_cvo_tpu/apps/irls_tartan.py).

Usage:
    python -m unified_cvo_tpu_torch.apps.irls_tartan TRAJ_DIR PARAMS.yaml GRAPH_FILE \
        OUT_PREFIX [--translation-only]

Mirrors src/experiments/main_multi_frame_irls_tartan.cpp (and, with
--translation-only, main_multi_frame_irls_translation_only_tartan.cpp,
which freezes the rotation tangent dims): load the graph file's RGB-D
frames, build voxel-downsampled edge (leaf/5) + surface (leaf) clouds, run
multiframe IRLS, and write `x y z qx qy qz qw` trajectories
<OUT_PREFIX>_before.txt / _after.txt (the TartanAir drivers' row format,
main_cvo_gpu_align_tartan.cpp:55-58). Clouds and the solve run on `device`
(None means the card).
"""

from __future__ import annotations

import sys

import numpy as np

from unified_cvo_tpu_torch.apps._ba_common import build_frame_cloud, write_xyzq_traj
from unified_cvo_tpu_torch.config import read_cvo_params_yaml
from unified_cvo_tpu_torch.datasets.graph import read_graph_file
from unified_cvo_tpu_torch.datasets.tartanair import TartanAirHandler
from unified_cvo_tpu_torch.models import irls


def main(argv=None, device=None, log=print):
    argv = sys.argv[1:] if argv is None else argv
    translation_only = "--translation-only" in argv
    argv = [a for a in argv if a != "--translation-only"]
    if len(argv) < 4:
        print(__doc__)
        return 1
    traj_dir, param_file, graph_file, out_prefix = argv[:4]

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
        clouds.append(
            build_frame_cloud(pair[0], pair[1], calib, voxel / 5.0, voxel, device=device)
        )
        log(f"frame {fid}: {int(clouds[-1].mask.sum())} points")

    F = len(frame_inds)
    init = (
        init_poses.astype(np.float32)
        if init_poses is not None
        else np.tile(np.eye(3, 4, dtype=np.float32), (F, 1, 1))
    )

    write_xyzq_traj(out_prefix + "_before.txt", init)
    stacked = irls.stack_clouds(clouds)
    poses, hist = irls.irls_solve(
        stacked, init, edges, [True] + [False] * (F - 1), params,
        chunk=min(1024, stacked.xyz.shape[1]), log=log,
        translation_only=translation_only, device=device,
    )
    write_xyzq_traj(out_prefix + "_after.txt", poses)
    log(f"wrote {out_prefix}_before.txt / _after.txt ({len(hist)} solve rounds)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
