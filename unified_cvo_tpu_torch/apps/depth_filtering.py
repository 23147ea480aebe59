"""Multi-view stereo depth filtering — the kitti_depth_filtering twin (port
of unified_cvo_tpu/apps/depth_filtering.py).

Usage:
    python -m unified_cvo_tpu_torch.apps.depth_filtering SEQ_DIR PARAMS.yaml \
        TRACKING_TRAJ.txt START_IND TOTAL_INDS DEPTH_DIR_ELL DEPTH_NORMAL_ELL \
        [OUT_DIR]

Mirrors src/experiments/main_depth_filtering.cpp:63-301: build the keyframe's
edge (leaf/4) + surface (leaf) cloud at START_IND and FULL clouds for the
following TOTAL_INDS-1 frames; for each temporal frame, compute the soft
association to the keyframe under a non-isotropic kernel
diag(normal_ell, normal_ell, dir_ell) at the tracked relative pose and
accumulate association-weighted depths; fuse each keyframe point's depth as
the weighted mean (with the original depth's self-weight, main:266-281) and
rescale the point along its viewing ray. Writes before/after clouds to
OUT_DIR (default '.') as before_depth_filtering.pcd / after_depth_filtering.pcd.

The clouds and the associations are computed on `device` (None means the
card); the depth sums and the fusion run on the host in float64, as in JAX.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from unified_cvo_tpu_torch.apps.irls_kitti import build_frame_cloud
from unified_cvo_tpu_torch.config import read_cvo_params_yaml
from unified_cvo_tpu_torch.datasets.kitti import KittiHandler
from unified_cvo_tpu_torch.datasets.pcd import write_pcd
from unified_cvo_tpu_torch.device import resolve_device
from unified_cvo_tpu_torch.frontend import selector as sel
from unified_cvo_tpu_torch.frontend.pipeline import pointcloud_from_stereo
from unified_cvo_tpu_torch.models.align import compute_association_non_isotropic
from unified_cvo_tpu_torch.utils.pointcloud import to_numpy_valid


def filter_keyframe_depth(
    kf_xyz: np.ndarray,
    wd_sum: np.ndarray,
    w_sum: np.ndarray,
    n_obs: np.ndarray,
    min_views: int = 4,
):
    """Fuse per-point depth observations (main_depth_filtering.cpp:260-295):
    keep points with > 3 observations; depth = (sum w_k d_k + d0 * wbar) /
    (sum w_k + wbar) with wbar = sum w_k / n_obs; rescale along the ray."""
    keep = np.nonzero(n_obs >= min_views)[0]
    if len(keep) == 0:
        return keep, np.zeros((0, 3), np.float32)
    wbar = w_sum[keep] / n_obs[keep]
    fused = (wd_sum[keep] + kf_xyz[keep, 2] * wbar) / (w_sum[keep] + wbar)
    rays = kf_xyz[keep] / kf_xyz[keep, 2:3]
    return keep, (rays * fused[:, None]).astype(np.float32)


def run(seq_dir, param_file, tracking_file, start_ind, total_inds,
        depth_dir_ell, depth_normal_ell, out_dir=".",
        frame_capacity=65536, top_k=64, device=None, log=print):
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)

    params = read_cvo_params_yaml(param_file)
    kitti = KittiHandler(seq_dir, "stereo")
    calib = kitti.calibration()
    frame_inds = list(range(start_ind, start_ind + total_inds))

    rows = np.loadtxt(tracking_file, dtype=np.float64).reshape(-1, 12)
    poses = []
    for fid in frame_inds:
        T = np.eye(4)
        T[:3, :4] = rows[fid].reshape(3, 4)
        poses.append(T)

    voxel = params.multiframe_downsample_voxel_size
    kitti.set_start_index(frame_inds[0])
    pair = kitti.read_next_stereo()
    kf = build_frame_cloud(pair[0], pair[1], calib, voxel / 4.0, voxel, bucket=1024,
                           device=dev)
    kf_np = to_numpy_valid(kf)
    n_kf = len(kf_np["xyz"])
    log(f"keyframe {frame_inds[0]}: {n_kf} points")

    temporal = []
    for fid in frame_inds[1:]:
        kitti.set_start_index(fid)
        pair = kitti.read_next_stereo()
        temporal.append(
            pointcloud_from_stereo(
                pair[0], pair[1], calib, method=sel.FULL, denoise=False,
                bucket=1024, capacity=frame_capacity, device=dev,
            )
        )
        log(f"frame {fid}: {int(temporal[-1].mask.sum())} points")

    # diag(normal, normal, dir) non-isotropic kernel (main:213-218)
    K = np.diag([depth_normal_ell, depth_normal_ell, depth_dir_ell]).astype(np.float32)

    wd_sum = np.zeros(n_kf)
    w_sum = np.zeros(n_kf)
    n_obs = np.zeros(n_kf, int)
    T_s = poses[0]
    for i, pc_t in enumerate(temporal, start=1):
        T_t = poses[i]
        T_t2s = np.linalg.inv(T_t) @ T_s
        T_s2t = np.linalg.inv(T_s) @ T_t
        vals, idx, _, _ = compute_association_non_isotropic(
            kf, pc_t, torch.as_tensor(T_t2s, dtype=torch.float32), torch.as_tensor(K),
            params, top_k=top_k, device=dev,
        )
        vals, idx = vals.cpu().numpy()[:n_kf], idx.cpu().numpy()[:n_kf]
        # target points expressed in the keyframe camera (main:237-243)
        xyz_t = pc_t.xyz.cpu().numpy()
        z_in_s = (xyz_t @ T_s2t[:3, :3].T + T_s2t[:3, 3])[:, 2]
        ok = (vals > 0) & (idx >= 0)
        w = np.where(ok, vals, 0.0)
        d = z_in_s[np.where(idx >= 0, idx, 0)]
        wd_sum += np.sum(w * d, axis=1)
        w_sum += np.sum(w, axis=1)
        n_obs += np.sum(ok, axis=1)
        log(f"frame {frame_inds[i]}: {int(ok.sum())} associated pairs")

    keep, new_xyz = filter_keyframe_depth(kf_np["xyz"], wd_sum, w_sum, n_obs)
    log(f"total pts after depth filtering is {len(keep)}")

    def rgb_of(d, sel_idx=None):
        f = d.get("features")
        if f is None or f.shape[1] < 3:
            return None
        f = f if sel_idx is None else f[sel_idx]
        return np.clip(f[:, :3] * 255.0, 0, 255).astype(np.uint8)

    write_pcd(os.path.join(out_dir, "before_depth_filtering.pcd"),
              kf_np["xyz"], rgb_of(kf_np))
    write_pcd(os.path.join(out_dir, "after_depth_filtering.pcd"),
              new_xyz, rgb_of(kf_np, keep))
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 7:
        print(__doc__)
        return 1
    return run(
        argv[0], argv[1], argv[2], int(argv[3]), int(argv[4]),
        float(argv[5]), float(argv[6]), argv[7] if len(argv) > 7 else ".",
    )


if __name__ == "__main__":
    raise SystemExit(main())
