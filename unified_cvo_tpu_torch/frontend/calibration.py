"""Camera calibration file reader (a copy of
unified_cvo_tpu/frontend/calibration.py, numpy only, kept here so that the
port imports nothing of the JAX package).

Reference: include/UnifiedCvo/utils/Calibration.hpp:22-69 — a plain-text
file `fx fy cx cy {baseline|depth_scale} [cols rows]`, interpreted per
modality (stereo baseline vs RGB-D depth scaling factor).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Calibration:
    intrinsic: np.ndarray          # [3,3]
    baseline: float = 0.0          # stereo
    depth_scale: float = 1.0       # rgbd (e.g. 5000 for TUM)
    cols: int = 0
    rows: int = 0

    @property
    def fx(self):
        return float(self.intrinsic[0, 0])

    @property
    def fy(self):
        return float(self.intrinsic[1, 1])

    @property
    def cx(self):
        return float(self.intrinsic[0, 2])

    @property
    def cy(self):
        return float(self.intrinsic[1, 2])


def read_calibration(path: str, data_type: str = "stereo") -> Calibration:
    vals = []
    with open(path) as f:
        for tok in f.read().split():
            vals.append(float(tok))
    fx, fy, cx, cy, fifth = vals[:5]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    cols, rows = (int(vals[5]), int(vals[6])) if len(vals) >= 7 else (0, 0)
    if data_type == "stereo":
        return Calibration(K, baseline=fifth, depth_scale=1.0, cols=cols, rows=rows)
    return Calibration(K, baseline=0.0, depth_scale=fifth, cols=cols, rows=rows)
