"""Local semantic BKI mapping over an RGB-D sequence, the L6/L7 driver (port
of unified_cvo_tpu/apps/local_mapping.py).

Twin of src/experiments/main_local_mapping.cpp (read poses + clouds, fuse
every frame into a SemanticBKIOctoMap, export the occupied map), extended
with the online mode the reference's graph_optimizer layer supports but
never wired into a built main (PoseGraph.cpp / Frame.hpp are commented out
of the reference CMakeLists:160,761): frame-to-frame CVO odometry,
function-angle keyframing, windowed pose-graph smoothing with a marginal
prior, and per-keyframe local maps fused from their tracked frames
(Frame::construct_map / add_points_to_map_from / export_points_from_map).

Usage:
    python -m unified_cvo_tpu_torch.apps.local_mapping SEQ_DIR PARAMS.yaml OUT_PREFIX
        [--trajectory TRAJ.txt]   # offline: fuse along a given trajectory
        [--max-frames N] [--resolution R] [--map-ell L] [--capacity C]

Writes OUT_PREFIX_traj.txt (TUM format) and OUT_PREFIX_map.npz
(centers [V,3], semantics [V], alpha [V,C+1]).

Clouds come from the host frontend's port (frontend/pipeline.py, FAST
selection) on the card; everything from the uploaded images to the map runs
there but the pose graph's bookkeeping and marginal. `run_frames` is the
loop itself over an iterable of (rgb, depth, timestamp); `run_sequence`
reads the TUM layout and calls it. As in JAX the denoiser is OpenCV's
fastNlMeansDenoisingColored, computed by its exact port (ops/nlm_opencv.py).
"""

from __future__ import annotations

import argparse
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from unified_cvo_tpu_torch.config import read_cvo_params_yaml
from unified_cvo_tpu_torch.datasets.tum import TumHandler, write_tum_pose_row
from unified_cvo_tpu_torch.device import resolve_device
from unified_cvo_tpu_torch.frontend.pipeline import pointcloud_from_rgbd
from unified_cvo_tpu_torch.models.align import align, function_angle
from unified_cvo_tpu_torch.models.bki import SemanticBKIMap
from unified_cvo_tpu_torch.models.keyframe import Keyframe
from unified_cvo_tpu_torch.models.posegraph import PoseGraph, PoseGraphConfig
from unified_cvo_tpu_torch.utils.pointcloud import to_numpy_valid

CAPACITY = 8192
STAGES = ("frontend", "align", "function_angle", "bki", "posegraph")


class MappingResult(NamedTuple):
    frames: int
    trajectory: list           # [(timestamp, world_T_frame [4,4])]
    keyframes: List[Keyframe]  # online mode; empty offline
    pose_graph: Optional[PoseGraph]
    centers: np.ndarray        # occupied voxel centres [V,3] (world frame)
    semantics: np.ndarray      # [V]
    alpha: np.ndarray          # [V, C+1]
    global_map: Optional[SemanticBKIMap]   # offline mode's map; None online
    align_infos: list          # online mode: each pair's AlignInfo
    odometry: list             # online mode: each pair's (relative pose [4,4], function angle)
    seconds: dict              # wall seconds per stage (STAGES), summed over frames


def _load_trajectory(path: str):
    """TUM (8 cols) or KITTI (12 cols) trajectory -> list of [4, 4] poses."""
    from unified_cvo_tpu_torch.utils.trajectory import load_trajectory

    _, poses = load_trajectory(path)
    return list(poses)


def run_frames(
    frames,
    calib,
    params,
    trajectory=None,
    max_frames: int = 100000,
    resolution: float = 0.1,
    map_ell: float = 0.3,
    num_classes: int = 19,
    capacity: int = CAPACITY,
    keyframe_function_angle: float = 0.6,
    window_size: int = 8,
    incremental: bool = False,
    denoise: bool = True,
    log=print,
    device=None,
    odometry=None,
) -> MappingResult:
    """Map an iterable of (rgb, depth, timestamp). `trajectory` (a list of
    [4, 4] world_T_frame poses) selects the offline mode: fuse every frame
    into one global map along it. Without it, the online mode: odometry,
    keyframing, pose graph and per-keyframe local maps. `odometry` (an
    online run's `MappingResult.odometry`) replays that run's tracking
    instead of aligning: keyframing, the pose graph and the maps run again,
    e.g. on another device. `device=None` means the card."""
    dev = resolve_device(device)
    seconds = dict.fromkeys(STAGES, 0.0)

    def timed(stage, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        seconds[stage] += time.perf_counter() - t0
        return out

    # one global map (the reference main's SemanticBKIOctoMap) plus, in
    # online mode, per-keyframe local maps via the Frame machinery
    global_map = SemanticBKIMap(resolution=resolution, num_classes=num_classes, ell=map_ell,
                                device=dev)
    pg = PoseGraph(PoseGraphConfig(keyframe_function_angle_threshold=keyframe_function_angle,
                                   window_size=window_size, incremental=incremental),
                   device=dev)
    keyframes: List[Keyframe] = []
    infos, tracked = [], []
    fa_ell = torch.tensor(max(params.ell_init * 0.5, params.ell_min), dtype=torch.float32,
                          device=dev)

    traj_rows = []
    prev_cloud = None
    prev_rel = np.eye(4)
    kf_T = np.eye(4)           # accumulated last-keyframe -> current frame
    world_T = np.eye(4)
    k = 0
    it = iter(frames)
    while k < max_frames:
        frame = next(it, None)
        if frame is None:
            break
        rgb, depth, ts = frame
        cloud = timed("frontend", pointcloud_from_rgbd, rgb, depth, calib, capacity=capacity,
                      denoise=denoise, device=dev)

        if trajectory is not None:
            if k >= len(trajectory):
                break
            world_T = trajectory[k]
            data = to_numpy_valid(cloud)
            xyz_w = data["xyz"] @ world_T[:3, :3].T + world_T[:3, 3]
            timed("bki", global_map.insert_pointcloud, xyz_w, data.get("labels"),
                  origin=world_T[:3, 3])
        elif prev_cloud is None:
            pg.add_first_frame(k)
            kf = Keyframe(k, cloud, pose=world_T.copy())
            timed("bki", kf.construct_map, resolution=resolution, num_classes=num_classes,
                  ell=map_ell)
            keyframes.append(kf)
        else:
            if odometry is None:
                ig = torch.as_tensor(np.linalg.inv(prev_rel), dtype=torch.float32, device=dev)
                T_rel, _, info = timed("align", align, prev_cloud, cloud, ig, params, device=dev)
                infos.append(info)
                # align returns the map taking target-frame points into the
                # source frame == the new camera's pose in the previous
                # camera frame; poses accumulate by RIGHT-multiplication
                # (reference accum_mat *= result, main_cvo_gpu_align_raw_image.cpp:126)
                rel = T_rel.cpu().numpy().astype(np.float64)
                fa = float(timed("function_angle", function_angle, prev_cloud, cloud,
                                 T_rel.to(torch.float32), fa_ell, params, device=dev))
            else:
                rel, fa = odometry[k - 1]
            tracked.append((rel, fa))
            prev_rel = rel
            kf_T = kf_T @ rel
            world_T = world_T @ rel
            is_kf = timed("posegraph", pg.add_frame, k, kf_T, function_angle=fa)
            if is_kf:
                kf_T = np.eye(4)
                kf = Keyframe(k, cloud, pose=world_T.copy())
                timed("bki", kf.construct_map, resolution=resolution,
                      num_classes=num_classes, ell=map_ell)
                keyframes.append(kf)
                # refresh keyframe poses from the smoothed graph
                for kf_i, s in zip(keyframes, range(pg.num_keyframes)):
                    kf_i.pose = pg.keyframe_poses[s].copy()
                world_T = keyframes[-1].pose.copy()
            else:
                # fuse the tracked frame into the current keyframe's local
                # map (Frame::add_points_to_map_from)
                timed("bki", keyframes[-1].add_points_from,
                      Keyframe(k, cloud, pose=world_T.copy()))
        if trajectory is None:
            prev_cloud = cloud

        traj_rows.append((ts, world_T.copy()))
        if k % 10 == 0:
            nvox = (len(global_map) if trajectory is not None
                    else sum(len(kf.local_map) for kf in keyframes
                             if kf.local_map is not None))
            log(f"frame {k}: map voxels={nvox} keyframes={len(keyframes)}")
        k += 1

    if trajectory is None:
        # merge the keyframe-local maps into the export (world frame)
        centers_all, sems_all, alpha_all = [], [], []
        for kf in keyframes:
            if kf.local_map is None or len(kf.local_map) == 0:
                continue
            c, s, a = kf.local_map.export_occupied()
            if len(c) == 0:
                continue
            centers_all.append(c @ kf.pose[:3, :3].T + kf.pose[:3, 3])
            sems_all.append(s)
            alpha_all.append(a)
        centers = np.concatenate(centers_all) if centers_all else np.zeros((0, 3))
        sems = np.concatenate(sems_all) if sems_all else np.zeros((0,), np.int32)
        alpha = (np.concatenate(alpha_all) if alpha_all
                 else np.zeros((0, num_classes + 1)))
    else:
        centers, sems, alpha = global_map.export_occupied()
    online = trajectory is None
    return MappingResult(k, traj_rows, keyframes, pg if online else None, centers, sems,
                         alpha, None if online else global_map, infos, tracked, seconds)


def run_sequence(
    seq_dir: str,
    param_file: str,
    out_prefix: str,
    trajectory: str | None = None,
    max_frames: int = 100000,
    resolution: float = 0.1,
    map_ell: float = 0.3,
    num_classes: int = 19,
    capacity: int = CAPACITY,
    keyframe_function_angle: float = 0.6,
    window_size: int = 8,
    incremental: bool = False,   # window_size=0 + incremental=True = the
    #   iSAM2-analogue full-graph mode (see PoseGraphConfig.incremental)
    denoise: bool = True,
    log=print,
    device=None,
):
    """The JAX driver's signature (plus `device`). Returns (frames,
    keyframes, occupied voxels)."""
    tum = TumHandler(seq_dir)
    calib = tum.calibration()
    params = read_cvo_params_yaml(param_file)
    poses_given = _load_trajectory(trajectory) if trajectory else None

    def frames():
        while True:
            pair = tum.read_next_rgbd()
            if pair is None:
                return
            ts = tum.timestamp()
            tum.next()
            yield pair[0], pair[1], ts

    res = run_frames(frames(), calib, params, trajectory=poses_given, max_frames=max_frames,
                     resolution=resolution, map_ell=map_ell, num_classes=num_classes,
                     capacity=capacity, keyframe_function_angle=keyframe_function_angle,
                     window_size=window_size, incremental=incremental, denoise=denoise,
                     log=log, device=device)
    with open(f"{out_prefix}_traj.txt", "w") as f:
        for ts, T in res.trajectory:
            write_tum_pose_row(f, ts, T)
    np.savez(f"{out_prefix}_map.npz", centers=res.centers, semantics=res.semantics,
             alpha=res.alpha)
    log(f"done: {res.frames} frames, {len(res.keyframes)} keyframes, "
        f"{len(res.centers)} occupied voxels -> {out_prefix}_map.npz")
    return res.frames, len(res.keyframes), len(res.centers)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("seq_dir")
    ap.add_argument("param_file")
    ap.add_argument("out_prefix")
    ap.add_argument("--trajectory", default=None)
    ap.add_argument("--max-frames", type=int, default=100000)
    ap.add_argument("--resolution", type=float, default=0.1)
    ap.add_argument("--map-ell", type=float, default=0.3)
    ap.add_argument("--capacity", type=int, default=CAPACITY)
    ap.add_argument("--no-denoise", action="store_true")
    args = ap.parse_args(argv)
    run_sequence(args.seq_dir, args.param_file, args.out_prefix,
                 trajectory=args.trajectory, max_frames=args.max_frames,
                 resolution=args.resolution, map_ell=args.map_ell,
                 capacity=args.capacity, denoise=not args.no_denoise)


if __name__ == "__main__":
    main()
