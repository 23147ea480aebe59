"""KITTI odometry dataset handler (stereo pngs, velodyne bins, semantics).

A copy of unified_cvo_tpu/datasets/kitti.py, kept here so that the port
imports nothing of the JAX package, with two changes: PNGs are read by the
port's own decoder (`datasets/png.py`, cv2.imread's bytes), so nothing here
needs OpenCV; and velodyne scans are read by `datasets/prefetch.py`'s
thread pool (np.fromfile), which takes the place of the JAX package's native
prefetch loader: the next scan is read while the current one is registered.

Reference: src/dataset_handler/KittiHandler.cpp. Sequence folder layout:
  <seq>/image_2/*.png, <seq>/image_3/*.png, <seq>/velodyne/*.bin,
  <seq>/image_semantic/*.bin (float32 HxWxC), <seq>/cvo_calib.txt
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from unified_cvo_tpu_torch.datasets import png
from unified_cvo_tpu_torch.datasets.prefetch import PrefetchLoader
from unified_cvo_tpu_torch.frontend.calibration import Calibration, read_calibration


def _build_label_map() -> np.ndarray:
    """SemanticKITTI raw id -> 1..19 training id (+0 = unlabeled), the
    exact table of KittiHandler::create_label_map (KittiHandler.cpp:195+);
    moving ids (252..259) collapse onto their static classes."""
    pairs = {
        0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5,
        30: 6, 31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13,
        51: 14, 52: 0, 60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19,
        99: 0, 252: 1, 253: 7, 254: 6, 255: 8, 256: 5, 257: 5, 258: 4,
        259: 5,
    }
    table = np.zeros(260, np.int32)
    for k, v in pairs.items():
        table[k] = v
    return table


KITTI_LABEL_MAP = _build_label_map()


class KittiHandler:
    def __init__(self, folder: str, data_type: str = "stereo"):
        self.folder = folder
        sub = "image_2" if data_type == "stereo" else "velodyne"
        names = [
            os.path.splitext(f)[0]
            for f in os.listdir(os.path.join(folder, sub))
            if not f.startswith(".")
        ]
        self.names = sorted(names)
        self.curr_index = 0
        self._loader = PrefetchLoader(2)
        self._pending = {}

    def _read_f32(self, path):
        ticket = self._pending.pop(path, None)
        if ticket is None:
            ticket = self._loader.submit(path, PrefetchLoader.RAW_F32)
        return self._loader.get(ticket)

    def __len__(self):
        return len(self.names)

    def set_start_index(self, idx: int):
        self.curr_index = idx

    def next_frame_index(self):
        return self.curr_index

    def read_next_stereo(self):
        if self.curr_index >= len(self.names):
            return None
        name = self.names[self.curr_index]
        left = png.imread(os.path.join(self.folder, "image_2", name + ".png"))
        right = png.imread(os.path.join(self.folder, "image_3", name + ".png"))
        if left is None or right is None:
            return None
        return left, right

    def read_next_stereo_semantic(self, num_classes: int = 19):
        pair = self.read_next_stereo()
        if pair is None:
            return None
        left, right = pair
        name = self.names[self.curr_index]
        path = os.path.join(self.folder, "image_semantic", name + ".bin")
        sem = np.fromfile(path, np.float32).reshape(
            left.shape[0], left.shape[1], num_classes
        )
        return left, right, sem

    def read_next_lidar(self):
        """Velodyne [N,4] xyz+intensity, rotated into the camera-style frame
        the reference uses (KittiHandler.cpp:120-145: x<-−y, y<-−z, z<-x)."""
        if self.curr_index >= len(self.names):
            return None
        name = self.names[self.curr_index]
        pts = self._read_f32(
            os.path.join(self.folder, "velodyne", name + ".bin")
        ).reshape(-1, 4)
        # prefetch the next scan on the loader's threads while the card
        # registers this one
        if self.curr_index + 1 < len(self.names):
            nxt = self.names[self.curr_index + 1]
            p = os.path.join(self.folder, "velodyne", nxt + ".bin")
            if p not in self._pending:
                self._pending[p] = self._loader.submit(p, PrefetchLoader.RAW_F32)
        xyz = pts[:, :3]
        rotated = np.stack([-xyz[:, 1], -xyz[:, 2], xyz[:, 0]], axis=1)
        return np.concatenate([rotated, pts[:, 3:4]], axis=1)

    def read_next_lidar_semantic(self, num_classes: int = 19):
        """(points [N,4], labels [N] int in [-1, num_classes-1]).

        SemanticKITTI layout: <seq>/labels/<name>.label, one uint32 per
        velodyne point — lower 16 bits semantic id, upper 16 instance id
        (KittiHandler.cpp read_next_lidar semantic overload, :154-193).
        Raw ids collapse through create_label_map minus 1, so 0 marks
        unlabeled/outlier points as -1 (dropped downstream by
        pointcloud_from_lidar's semantics >= 0 gate)."""
        pts = self.read_next_lidar()
        if pts is None:
            return None
        name = self.names[self.curr_index]
        raw = np.fromfile(
            os.path.join(self.folder, "labels", name + ".label"), np.uint32
        )
        sem = (raw & 0xFFFF).astype(np.int64)
        in_table = sem < KITTI_LABEL_MAP.shape[0]
        labels = np.where(
            in_table, KITTI_LABEL_MAP[np.where(in_table, sem, 0)], 0) - 1
        return pts, labels.astype(np.int32)

    def next(self):
        self.curr_index += 1

    def calibration(self) -> Calibration:
        return read_calibration(os.path.join(self.folder, "cvo_calib.txt"), "stereo")


def write_kitti_pose_row(f, T: np.ndarray):
    """One KITTI-format row: the top 3x4 of the accumulated pose."""
    row = T[:3, :4].reshape(-1)
    f.write(" ".join(f"{v:.9g}" for v in row) + "\n")
    f.flush()


def read_kitti_poses(path: str) -> np.ndarray:
    """[N,4,4] poses from a KITTI-format trajectory file."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    n = rows.shape[0]
    out = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    out[:, :3, :4] = rows
    return out
