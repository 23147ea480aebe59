"""Plain reference of the KITTI stereo frontend: a stereo pair to a colour
point cloud, stage by stage, from the frozen plain stages of
`stereo_ops.py`.

    denoised   cv2.fastNlMeansDenoisingColored(left, None, 10, 10, 7, 21)
    disparity  StereoSGBM 3WAY (block 7, P1 8 * 49, P2 32 * 49, ...) of the
               raw pair's cv2 grey, its int16 map / 16
    keypoints  FAST-9 with the reference's adaptive threshold on the
               denoised image's grey, raster order
    cloud      pt_depth_from_disparity (u in [1, w-2], v in [1, h-2],
               disparity > 0.05, depth = |b| fx / d), the good-point gate
               (u in [2, w-2], v in [100, h-30], range < 55 m), features
               [b, g, r] / 255 and the gradient / 500 + 0.5, the capacity
               cap by evenly spaced indices

The features are float32 with correctly rounded divisions, so they come
out bit for bit. The backprojection is computed here in float64 from K's
float64 inverse,
so its gap to the package is the package's own float32 rounding;
`prec="tf32"` (the control) rounds the pixel coordinates and K^-1 to
TF32's 10-bit mantissa first, as a TF32 product rounds its operands.
Imports nothing of the measured package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

import stereo_ops as ops
from cvo_ref import rounder

RANGE_MAX = 55.0


class Frontend(NamedTuple):
    denoised: torch.Tensor     # [H, W, 3] uint8
    disparity: torch.Tensor    # [H, W] float32, invalid <= 0
    uv: torch.Tensor           # [n, 2] int32 keypoints, raster order
    uv_kept: torch.Tensor      # [m, 2] int64 pixels of the cloud's rows
    xyz: torch.Tensor          # [m, 3] float64
    features: torch.Tensor     # [m, 5] float32
    range_m: torch.Tensor      # [m] float64 |xyz| of every gated keypoint
    gated_uv: torch.Tensor     # [g, 2] keypoints that passed the disparity gate


def stereo_frontend(left, right, camera: dict, capacity: int, max_disparity: int,
                    prec: str = "fp32") -> Frontend:
    """The frontend on uint8 BGR [H, W, 3] tensors `left`, `right`."""
    rnd = rounder(prec)
    dev = left.device
    den = ops.fast_nl_means_denoising_colored(left, 10.0, 10.0, 7, 21)
    gray = ops.opencv_gray(den)
    grad, _ = ops.gradients(gray)
    uv, _, _ = ops.fast_select(gray, "stereo", 0)
    g1 = ops.opencv_gray(left).to(torch.uint8)
    g2 = ops.opencv_gray(right).to(torch.uint8)
    disp = ops.sgbm_3way(g1, g2, **ops.opencv_settings(max_disparity)).to(torch.float32) / 16.0
    h, w = disp.shape
    u, v = uv[:, 0].long(), uv[:, 1].long()
    inb = (u >= 1) & (u <= w - 2) & (v >= 1) & (v <= h - 2)
    d = torch.where(inb, disp[v.clamp(0, h - 1), u.clamp(0, w - 1)], 0.0).to(torch.float64)
    valid = inb & (d > 0.05)
    K = np.array([[camera["fx"], 0.0, camera["cx"]], [0.0, camera["fy"], camera["cy"]],
                  [0.0, 0.0, 1.0]], np.float32)
    Kinv = torch.as_tensor(np.linalg.inv(K.astype(np.float64)), device=dev)
    Kinv = rnd(Kinv.to(torch.float32)).to(torch.float64) if prec != "fp32" else Kinv
    depth = abs(float(camera["baseline"])) * float(K[0, 0]) / torch.where(valid, d, 1.0)
    uf, vf = (rnd(t.to(torch.float32)).to(torch.float64) for t in (u, v))
    ray = torch.stack([uf, vf, torch.ones_like(uf)], 1) @ Kinv.T
    xyz = ray * depth[:, None]
    rng_m = torch.linalg.vector_norm(xyz, dim=1)
    good = valid & (u >= 2) & (u <= w - 2) & (v >= 100) & (v <= h - 30) & (rng_m < RANGE_MAX)
    ug, vg = u[good], v[good]
    # features in float32 as the reference's C++ fills them, each division
    # a correctly rounded one (by a tensor, never a reciprocal's product)
    c255 = torch.tensor(255.0, dtype=torch.float32, device=dev)
    c500 = torch.tensor(500.0, dtype=torch.float32, device=dev)
    feats = torch.cat([den[vg, ug].to(torch.float32) / c255, grad[vg, ug] / c500 + 0.5], dim=1)
    xyz_g = xyz[good]
    uv_g = torch.stack([ug, vg], 1)
    if len(xyz_g) > capacity:
        sub = ops.cap_indices(len(xyz_g), capacity, dev)
        xyz_g, feats, uv_g = xyz_g[sub], feats[sub], uv_g[sub]
    return Frontend(denoised=den, disparity=disp, uv=uv, uv_kept=uv_g, xyz=xyz_g,
                    features=feats, range_m=rng_m[valid], gated_uv=uv[valid].long())
