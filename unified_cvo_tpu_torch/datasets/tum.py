"""TUM RGB-D dataset handler (assoc.txt-paired rgb/depth).

Reference: src/dataset_handler/TumHandler.cpp. assoc.txt rows:
  rgb_timestamp rgb/xxx.png depth_timestamp depth/xxx.png
Depth pngs are uint16 with scale 5000 (standard TUM; the calibration file's
depth_scale field).

A copy of unified_cvo_tpu/datasets/tum.py, kept here so that the port
imports nothing of the JAX package; PNGs are read by the port's own decoder
(`datasets/png.py`, cv2.imread's bytes under both flags), so nothing here
needs OpenCV.
"""

from __future__ import annotations

import os

import numpy as np

from unified_cvo_tpu_torch.datasets import png
from unified_cvo_tpu_torch.frontend.calibration import Calibration, read_calibration


class TumHandler:
    def __init__(self, folder: str):
        self.folder = folder
        self.rgb_names, self.rgb_paths, self.depth_paths = [], [], []
        with open(os.path.join(folder, "assoc.txt")) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 4 or parts[0].startswith("#"):
                    continue
                self.rgb_names.append(parts[0])
                self.rgb_paths.append(parts[1])
                self.depth_paths.append(parts[3])
        self.curr_index = 0

    def __len__(self):
        return len(self.rgb_names)

    def set_start_index(self, idx: int):
        self.curr_index = idx

    def read_next_rgbd(self):
        if self.curr_index >= len(self.rgb_names):
            return None
        rgb = png.imread(os.path.join(self.folder, self.rgb_paths[self.curr_index]))
        depth = png.imread(os.path.join(self.folder, self.depth_paths[self.curr_index]),
                           unchanged=True)
        if rgb is None or depth is None:
            return None
        return rgb, depth

    def timestamp(self) -> str:
        return self.rgb_names[self.curr_index]

    def next(self):
        self.curr_index += 1

    def calibration(self) -> Calibration:
        return read_calibration(os.path.join(self.folder, "cvo_calib.txt"), "rgbd")


def read_tum_trajectory(path: str):
    """(timestamps list, poses [N,4,4]) from a TUM-format trajectory file
    (timestamp tx ty tz qx qy qz qw) — the format evaluate_ate_scale.py
    consumes in the reference's BA scripts."""
    from scipy.spatial.transform import Rotation

    stamps, poses = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 8 or parts[0].startswith("#"):
                continue
            stamps.append(parts[0])
            t = np.asarray([float(v) for v in parts[1:4]])
            q = [float(v) for v in parts[4:8]]  # x y z w
            T = np.eye(4)
            T[:3, :3] = Rotation.from_quat(q).as_matrix()
            T[:3, 3] = t
            poses.append(T)
    return stamps, np.asarray(poses)


def write_tum_pose_row(f, timestamp: str, T: np.ndarray):
    """timestamp tx ty tz qx qy qz qw (TUM trajectory format)."""
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(T[:3, :3]).as_quat()  # x y z w
    t = T[:3, 3]
    f.write(
        f"{timestamp} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
        f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
    )
    f.flush()
