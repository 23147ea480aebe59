"""Shared helpers for the multiframe IRLS BA drivers (port of
unified_cvo_tpu/apps/_ba_common.py).

The reference's IRLS mains (main_multi_frame_irls_{tum,kitti,tartan}.cpp)
share the same preprocessing recipe: build a DSO-edge cloud and a FULL
cloud per frame, voxel-downsample each at a type-specific leaf size, tag
the survivors EDGE/SURFACE, concatenate, and initialise frame poses from
the graph file or a tracking-trajectory subset (read_pose_file,
main_multi_frame_irls_kitti.cpp:120-163).

As in JAX the voxel downsample runs on the host (numpy): the two clouds
come back from the device, and the BA cloud goes up to `device` (None means
the card).
"""

from __future__ import annotations

import numpy as np

from unified_cvo_tpu_torch.frontend import selector as sel
from unified_cvo_tpu_torch.frontend.pipeline import pointcloud_from_rgbd
from unified_cvo_tpu_torch.utils.pointcloud import PointCloud, make_pointcloud, to_numpy_valid
from unified_cvo_tpu_torch.utils.voxel import voxel_downsample_indices

# geometric_type rows for downsampled BA clouds (EDGE ~ [0.9,0.1], SURFACE
# ~ [0,1] — CvoPointCloud GeometryType tagging, CvoPointCloud.cpp:570-652)
EDGE_GTYPE = (0.9, 0.1)
SURFACE_GTYPE = (0.0, 1.0)


def downsample_edge_surface(
    pc_edge: PointCloud,
    pc_full: PointCloud,
    voxel_edge: float,
    voxel_surface: float,
    bucket: int = 1024,
    device=None,
) -> PointCloud:
    """Edge + surface voxel-downsampled BA frame cloud
    (main_multi_frame_irls_tum.cpp:300-340 / _kitti.cpp:236-295)."""
    e = to_numpy_valid(pc_edge)
    f = to_numpy_valid(pc_full)
    ei = voxel_downsample_indices(e["xyz"], voxel_edge)
    fi = voxel_downsample_indices(f["xyz"], voxel_surface)
    xyz = np.concatenate([e["xyz"][ei], f["xyz"][fi]])
    feats = np.concatenate([e["features"][ei], f["features"][fi]])
    gtypes = np.concatenate(
        [
            np.tile([list(EDGE_GTYPE)], (len(ei), 1)),
            np.tile([list(SURFACE_GTYPE)], (len(fi), 1)),
        ]
    ).astype(np.float32)
    return make_pointcloud(xyz, features=feats, geometric_types=gtypes, bucket=bucket,
                           device=device)


def build_frame_cloud(rgb, depth, calib, voxel_edge, voxel_surface, bucket=1024,
                      device=None):
    """Edge (DSO_EDGES) + surface (FULL) cloud of an RGB-D frame, without
    denoising, voxel-downsampled per type: JAX's irls_tum and irls_tartan
    `build_frame_cloud` (main_multi_frame_irls_tum.cpp:300-340)."""
    pc_edge = pointcloud_from_rgbd(rgb, depth, calib, method=sel.DSO_EDGES, denoise=False,
                                   bucket=64, device=device)
    pc_full = pointcloud_from_rgbd(rgb, depth, calib, method=sel.FULL, denoise=False,
                                   bucket=64, device=device)
    return downsample_edge_surface(pc_edge, pc_full, voxel_edge, voxel_surface, bucket,
                                   device=device)


def read_pose_rows_subset(path: str, frame_inds) -> np.ndarray:
    """Rows `frame_inds` of a KITTI-format 12-float/row trajectory file as
    [F,3,4] (read_pose_file, main_multi_frame_irls_kitti.cpp:120-163)."""
    rows = np.loadtxt(path, dtype=np.float64).reshape(-1, 12)
    return rows[np.asarray(frame_inds, int)].reshape(-1, 3, 4).astype(np.float32)


def write_kitti_traj(path: str, poses: np.ndarray) -> None:
    """One 12-float KITTI row per frame (write_traj_file,
    main_multi_frame_irls_kitti.cpp:25-46)."""
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.9g}" for v in np.asarray(T).reshape(12)) + "\n")


def write_xyzq_traj(path: str, poses: np.ndarray) -> None:
    """`x y z qx qy qz qw` rows (the TartanAir drivers' output format,
    main_cvo_gpu_align_tartan.cpp:55-58)."""
    from scipy.spatial.transform import Rotation

    with open(path, "w") as f:
        for T in poses:
            T = np.asarray(T)
            q = Rotation.from_matrix(T[:3, :3]).as_quat()  # x y z w
            t = T[:3, 3]
            f.write(
                f"{t[0]:.9g} {t[1]:.9g} {t[2]:.9g} "
                f"{q[0]:.9g} {q[1]:.9g} {q[2]:.9g} {q[3]:.9g}\n"
            )


def merged_map_xyz_rgb(clouds, poses):
    """All frames' valid points transformed into the world frame — the
    write_transformed_pc covis-map export (main_multi_frame_irls_kitti.cpp:166-184)."""
    all_xyz, all_rgb = [], []
    for pc, T in zip(clouds, poses):
        d = to_numpy_valid(pc)
        T = np.asarray(T, np.float64)
        xyz = d["xyz"] @ T[:3, :3].T + T[:3, 3]
        all_xyz.append(xyz)
        feats = d.get("features")
        if feats is not None and feats.shape[1] >= 3:
            all_rgb.append(np.clip(feats[:, :3] * 255.0, 0, 255).astype(np.uint8))
    xyz = np.concatenate(all_xyz) if all_xyz else np.zeros((0, 3))
    rgb = np.concatenate(all_rgb) if len(all_rgb) == len(all_xyz) and all_rgb else None
    return xyz, rgb
