"""Backprojection and the good-point gate of the host frontend, in torch ops
on the device (port of unified_cvo_tpu/frontend/stereo.py).

The gating semantics are the reference's pt_depth_from_disparity
(StaticStereo.cpp:66-113): u in [1,w-2], v in [1,h-2], disparity > 0.05,
depth = |baseline| * fx / disp, xyz = K^{-1} [u,v,1] * depth; and the RGB-D
constructor's depth / depth_scale, valid if > 0 (CvoPointCloud.cpp:459-564).
Each computes in the precision JAX's numpy does (the depths in float64,
the disparity path's rays in float32), with K^{-1} the float32 inverse numpy
takes of the float32 intrinsic. Divisors are device tensors, so CUDA divides
as numpy does instead of multiplying by a reciprocal.

`compute_disparity` (cv2.StereoSGBM or native/) is not ported (ROADMAP item
1.9); the device frontend's census-SGM is `ops/sgm.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from unified_cvo_tpu_torch.frontend.calibration import Calibration

DISPARITY_MISSING = (
    "compute_disparity (cv2.StereoSGBM or the native census/SGM library) is not "
    "ported (ROADMAP item 1.9: Canny, ORB and compute_disparity); pass a disparity "
    "map, or use the device frontend (frontend/device.py, ops/sgm.py)")


def compute_disparity(left, right, max_disparity: int = 128, backend: str = "auto"):
    raise NotImplementedError(DISPARITY_MISSING)


def _kinv(calib: Calibration, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(np.linalg.inv(calib.intrinsic), dtype=dtype, device=dev)


def _norm3(xyz: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((xyz[:, 0] * xyz[:, 0] + xyz[:, 1] * xyz[:, 1])
                      + xyz[:, 2] * xyz[:, 2])


def backproject_disparity(uv: torch.Tensor, disparity: torch.Tensor, calib: Calibration):
    """Vectorized pt_depth_from_disparity over selected pixels.
    Returns (xyz [N,3] float32, good [N] bool) on the disparity's device."""
    dev = disparity.device
    h, w = disparity.shape
    u = uv[:, 0].to(torch.int64)
    v = uv[:, 1].to(torch.int64)
    in_bounds = (u >= 1) & (u <= w - 2) & (v >= 1) & (v <= h - 2)
    d = torch.where(in_bounds, disparity[v.clamp(0, h - 1), u.clamp(0, w - 1)]
                    .to(torch.float32), 0.0)
    valid = in_bounds & (d > 0.05)
    # |b| fx is a float64 scalar in numpy, so the depth is float64
    fxb = torch.tensor(abs(calib.baseline) * calib.fx, dtype=torch.float64, device=dev)
    depth = fxb / torch.where(valid, d, 1.0).to(torch.float64)
    homo = torch.stack([u.to(torch.float32), v.to(torch.float32),
                        torch.ones_like(u, dtype=torch.float32)], 1)
    xyz = (homo @ _kinv(calib, torch.float32, dev).T).to(torch.float64) * depth[:, None]
    return xyz.to(torch.float32), valid


def is_good_point(xyz: torch.Tensor, uv: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Sky/far-point filter (CvoPointCloud.cpp:39-57): u in [2, w-2],
    v in [100, h-30], range < 55 m."""
    u, v = uv[:, 0], uv[:, 1]
    ok = (u >= 2) & (u <= w - 2) & (v >= 100) & (v <= h - 30)
    return ok & (_norm3(xyz) < 55.0)


def backproject_depth(uv: torch.Tensor, depth_image: torch.Tensor, calib: Calibration):
    """RGB-D backprojection: depth / depth_scale in float64, valid if >
    1e-6. Returns (xyz [N,3] float32, valid [N] bool) on the depth map's
    device."""
    dev = depth_image.device
    h, w = depth_image.shape[:2]
    u = uv[:, 0].to(torch.int64)
    v = uv[:, 1].to(torch.int64)
    in_bounds = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    d = torch.where(in_bounds, depth_image[v.clamp(0, h - 1), u.clamp(0, w - 1)]
                    .to(torch.float64), 0.0)
    depth = d / torch.tensor(float(calib.depth_scale), dtype=torch.float64, device=dev)
    valid = in_bounds & (depth > 1e-6)
    homo = torch.stack([u.to(torch.float64), v.to(torch.float64),
                        torch.ones_like(u, dtype=torch.float64)], 1)
    xyz = (homo @ _kinv(calib, torch.float64, dev).T) * depth[:, None]
    return xyz.to(torch.float32), valid
