"""Lyft L5 lidar dataset handler (a copy of unified_cvo_tpu/datasets/lyft.py,
kept here so that the port imports nothing of the JAX package).

Reference: src/dataset_handler/LyftHandler.cpp — lidar sweeps stored as
5-float-per-point .bin files (x y z intensity ring), rotated into the same
camera-style frame as KITTI (x <- -y, y <- -z, z <- x); optional .label
semantic files of one uint32 per point.
"""

from __future__ import annotations

import os

import numpy as np


class LyftHandler:
    def __init__(self, folder: str, data_subdir: str = "lidar"):
        self.folder = os.path.join(folder, data_subdir)
        self.names = sorted(
            os.path.splitext(f)[0]
            for f in os.listdir(self.folder)
            if f.endswith(".bin")
        )
        self.curr_index = 0

    def __len__(self):
        return len(self.names)

    def set_start_index(self, idx: int):
        self.curr_index = idx

    def next(self):
        self.curr_index += 1

    def read_next_lidar(self):
        """[N,4] xyz+intensity in the camera-style frame, or None past the end."""
        if self.curr_index >= len(self.names):
            return None
        raw = np.fromfile(
            os.path.join(self.folder, self.names[self.curr_index] + ".bin"),
            np.float32,
        ).reshape(-1, 5)
        xyz = raw[:, :3]
        rotated = np.stack([-xyz[:, 1], -xyz[:, 2], xyz[:, 0]], axis=1)
        return np.concatenate([rotated, raw[:, 3:4]], axis=1)

    def read_next_lidar_semantic(self):
        """(points [N,4], labels [N] int32: the .label file's uint32 values)."""
        pts = self.read_next_lidar()
        if pts is None:
            return None
        path = os.path.join(self.folder, self.names[self.curr_index] + ".label")
        labels = np.fromfile(path, np.uint32).astype(np.int32)
        return pts, labels
