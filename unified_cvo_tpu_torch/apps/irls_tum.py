"""TUM multiframe IRLS BA over a co-visibility graph — the cvo_irls_tum twin
(port of unified_cvo_tpu/apps/irls_tum.py).

Usage:
    python -m unified_cvo_tpu_torch.apps.irls_tum TUM_DIR GRAPH_FILE PARAMS.yaml OUT_PREFIX

Mirrors src/experiments/main_multi_frame_irls_tum.cpp:210-550: load the
graph file's frames from the TUM sequence, build downsampled edge+surface
clouds (DSO-style edges at voxel ell/4 + surface points at voxel ell,
main:260-363), run multiframe IRLS, and write TUM-format trajectories
<OUT_PREFIX>_before.txt / <OUT_PREFIX>_after.txt.

The PNGs are read by the port's decoder, both clouds are built on `device`
(None means the card) and downsampled on the host, as in JAX; frames of
32768 points or more take the IRLS 'ell' backend (models/irls.py).
"""

from __future__ import annotations

import sys

import numpy as np

from unified_cvo_tpu_torch.apps._ba_common import build_frame_cloud
from unified_cvo_tpu_torch.config import read_cvo_params_yaml
from unified_cvo_tpu_torch.datasets.graph import read_graph_file
from unified_cvo_tpu_torch.datasets.tum import TumHandler, write_tum_pose_row
from unified_cvo_tpu_torch.models import irls


def main(argv=None, device=None, log=print):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 4:
        print(__doc__)
        return 1
    tum_dir, graph_file, param_file, out_prefix = argv[:4]

    frame_inds, edges, init_poses = read_graph_file(graph_file)
    params = read_cvo_params_yaml(param_file)
    tum = TumHandler(tum_dir)
    calib = tum.calibration()

    voxel = params.multiframe_downsample_voxel_size
    clouds, stamps = [], []
    for fid in frame_inds:
        tum.set_start_index(fid)
        pair = tum.read_next_rgbd()
        if pair is None:
            raise RuntimeError(f"frame {fid} unreadable")
        clouds.append(
            build_frame_cloud(pair[0], pair[1], calib, voxel / 4.0, voxel, device=device)
        )
        stamps.append(tum.timestamp())
        log(f"frame {fid}: {int(clouds[-1].mask.sum())} points")

    F = len(frame_inds)
    if init_poses is None:
        init = np.tile(np.eye(3, 4, dtype=np.float32), (F, 1, 1))
    else:
        init = init_poses.astype(np.float32)

    def dump(path, poses):
        with open(path, "w") as f:
            for ts, T in zip(stamps, poses):
                T44 = np.eye(4)
                T44[:3, :4] = T
                write_tum_pose_row(f, ts, T44)

    dump(out_prefix + "_before.txt", init)
    stacked = irls.stack_clouds(clouds)
    poses, hist = irls.irls_solve(
        stacked, init, edges, [True] + [False] * (F - 1), params,
        chunk=min(1024, stacked.xyz.shape[1]), log=log, device=device,
    )
    dump(out_prefix + "_after.txt", poses)
    log(f"wrote {out_prefix}_before.txt / _after.txt ({len(hist)} solve rounds)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
