"""TartanAir dataset handler (rgb pngs + depth/semantic npys).

A copy of unified_cvo_tpu/datasets/tartanair.py, kept here so that the port
imports nothing of the JAX package, with two changes: PNGs are read by the
port's own decoder (`datasets/png.py`, cv2.imread's bytes), and the depth
and segmentation `.npy` files by `datasets/prefetch.py::read_npy`
(np.load), where JAX's reader takes its native cnpy twin.

Reference: src/dataset_handler/TartanAirHandler.cpp (cnpy-based). Layout:
  <traj>/image_left/NNNNNN_left.png
  <traj>/depth_left/NNNNNN_left_depth.npy     (float32 metric depth)
  <traj>/seg_left/NNNNNN_left_seg.npy         (uint8 class ids)
"""

from __future__ import annotations

import os

import numpy as np

from unified_cvo_tpu_torch.datasets import png
from unified_cvo_tpu_torch.datasets.prefetch import read_npy
from unified_cvo_tpu_torch.frontend.calibration import Calibration

# TartanAir pinhole intrinsics (fixed across the dataset)
TARTANAIR_K = np.array(
    [[320.0, 0.0, 320.0], [0.0, 320.0, 240.0], [0.0, 0.0, 1.0]], np.float32
)


class TartanAirHandler:
    def __init__(self, folder: str):
        self.folder = folder
        names = [
            f.split("_")[0]
            for f in os.listdir(os.path.join(folder, "image_left"))
            if f.endswith(".png")
        ]
        self.names = sorted(names)
        self.curr_index = 0

    def __len__(self):
        return len(self.names)

    def set_start_index(self, idx: int):
        self.curr_index = idx

    def read_next_rgbd(self):
        if self.curr_index >= len(self.names):
            return None
        n = self.names[self.curr_index]
        rgb = png.imread(os.path.join(self.folder, "image_left", f"{n}_left.png"))
        depth_path = os.path.join(self.folder, "depth_left", f"{n}_left_depth.npy")
        if rgb is None or not os.path.isfile(depth_path):
            return None
        return rgb, read_npy(depth_path).astype(np.float32)

    def read_next_rgbd_semantic(self, num_classes: int):
        out = self.read_next_rgbd()
        if out is None:
            return None
        rgb, depth = out
        n = self.names[self.curr_index]
        seg = read_npy(os.path.join(self.folder, "seg_left", f"{n}_left_seg.npy"))
        onehot = np.eye(num_classes, dtype=np.float32)[
            np.clip(seg.astype(np.int64), 0, num_classes - 1)
        ]
        return rgb, depth, onehot

    def next(self):
        self.curr_index += 1

    def calibration(self) -> Calibration:
        return Calibration(TARTANAIR_K.copy(), depth_scale=1.0, cols=640, rows=480)
