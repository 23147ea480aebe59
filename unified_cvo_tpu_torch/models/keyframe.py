"""Keyframe container binding a point cloud, its pose, and a local BKI map
(port of unified_cvo_tpu/models/keyframe.py).

Reference: src/graph_optimizer/Frame.{hpp,cpp} (Frame.hpp:18-122): a
keyframe owns its CvoPointCloud, tracking RelativePose, and a per-keyframe
local semantic BKI map (construct_map / add_points_to_map_from /
export_points_from_map, Frame.hpp:99-101). The map lives on the cloud's
device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from unified_cvo_tpu_torch.models.bki import SemanticBKIMap
from unified_cvo_tpu_torch.utils.pointcloud import PointCloud, make_pointcloud, to_numpy_valid


@dataclasses.dataclass
class Keyframe:
    frame_id: int
    cloud: PointCloud
    pose: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4))
    local_map: Optional[SemanticBKIMap] = None

    def construct_map(self, resolution: float = 0.1, num_classes: int = 19,
                      ell: float = 0.3, free_resolution: float = 100.0):
        """Build the keyframe-local BKI map from its own points
        (Frame::construct_map). free_resolution defaults to 100 m exactly
        as the reference caller passes it (Frame.cpp:166
        `insert_pointcloud_csm(&points_, origin, -1, 100, -1)`): at
        KITTI-scale ranges that inserts essentially no free-space samples;
        pass a small value (e.g. 0.5) for dense free-space evidence."""
        self.local_map = SemanticBKIMap(resolution=resolution, num_classes=num_classes,
                                        ell=ell, free_resolution=free_resolution,
                                        device=self.cloud.xyz.device)
        data = to_numpy_valid(self.cloud)
        self.local_map.insert_pointcloud(data["xyz"], data.get("labels"), origin=np.zeros(3))

    def add_points_from(self, other: "Keyframe"):
        """Fuse another frame's points into this keyframe's local map,
        expressed in this keyframe's frame (Frame::add_points_to_map_from)."""
        assert self.local_map is not None, "construct_map first"
        data = to_numpy_valid(other.cloud)
        T = np.linalg.inv(self.pose) @ other.pose
        xyz = data["xyz"] @ T[:3, :3].T + T[:3, 3]
        self.local_map.insert_pointcloud(xyz, data.get("labels"), origin=T[:3, 3])

    def export_points_from_map(self) -> Optional[PointCloud]:
        """Occupied map voxels as a labeled point cloud
        (Frame::export_points_from_map)."""
        if self.local_map is None:
            return None
        centers, _, alphas = self.local_map.export_occupied()
        if len(centers) == 0:
            return None
        dist = alphas[:, 1:] / np.maximum(alphas[:, 1:].sum(1, keepdims=True), 1e-12)
        return make_pointcloud(centers.astype(np.float32), labels=dist.astype(np.float32),
                               device=self.local_map.device)
