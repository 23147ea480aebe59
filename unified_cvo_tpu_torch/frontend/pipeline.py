"""Measurement -> feature point cloud construction on the device, the host
frontend of the JAX package (port of unified_cvo_tpu/frontend/pipeline.py).

Composes RawImage, point selection, stereo / RGB-D depth and the good-point
filters into padded PointClouds, mirroring the reference constructors:
  * stereo: CvoPointCloud(ImageStereo, Calibration) (CvoPointCloud.cpp:680-773)
  * rgbd:   CvoPointCloud(RawImage, depth, Calibration) (CvoPointCloud.cpp:459-564)
The images go up once; selection, backprojection, the filters and the
capacity cap run on the device, and only counts come back (the FAST
histogram and the selected and kept point counts).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from unified_cvo_tpu_torch.device import resolve_device
from unified_cvo_tpu_torch.frontend import selector as sel
from unified_cvo_tpu_torch.frontend.calibration import Calibration
from unified_cvo_tpu_torch.frontend.image import RawImage, make_raw_image, pixel_features
from unified_cvo_tpu_torch.frontend.stereo import (
    _norm3, backproject_depth, backproject_disparity, compute_disparity, is_good_point)
from unified_cvo_tpu_torch.utils.pointcloud import PointCloud, round_up

UNLABELED_CLASS = 10  # reference excludes argmax==10 points (CvoPointCloud.cpp:716-722)


def cap_indices(n: int, capacity: int, device=None) -> torch.Tensor:
    """`np.linspace(0, n - 1, capacity).astype(np.int64)` built as numpy
    builds it: arange * ((n - 1) / (capacity - 1)) in float64, the last index
    set to n - 1, truncated. `torch.linspace` computes the second half from
    the end and picks other indices for some (n, capacity)."""
    dev = resolve_device(device)
    if capacity == 1:
        return torch.zeros(1, dtype=torch.int64, device=dev)
    step = (n - 1) / (capacity - 1)
    y = torch.arange(capacity, dtype=torch.float64, device=dev) * step
    y[-1] = n - 1
    return y.to(torch.int64)


def _pad_cloud(xyz, feats, labels, gtype, bucket: int, capacity: Optional[int]) -> PointCloud:
    """make_pointcloud's padding rules on device tensors."""
    n = xyz.shape[0]
    cap = capacity if capacity is not None else max(round_up(n, bucket), bucket)
    if cap < n:
        raise ValueError(f"capacity {cap} < num points {n}")

    def pad(a):
        out = torch.zeros((cap, a.shape[1]), dtype=torch.float32, device=xyz.device)
        out[:n] = a
        return out

    mask = torch.zeros((cap,), dtype=torch.float32, device=xyz.device)
    mask[:n] = 1.0
    return PointCloud(xyz=pad(xyz), mask=mask, features=pad(feats),
                      labels=None if labels is None else pad(labels),
                      geometric_types=pad(gtype))


def _finalize(raw: RawImage, uv, gtype, xyz, good, bucket, capacity=None) -> PointCloud:
    uv, gtype, xyz = uv[good], gtype[good], xyz[good]
    u, v = uv[:, 0].long(), uv[:, 1].long()
    feats = pixel_features(raw, u, v)
    labels = None
    if raw.num_classes > 0:
        labels = raw.semantics[v, u]
        keep = labels.argmax(1) != UNLABELED_CLASS
        gtype, xyz, feats, labels = gtype[keep], xyz[keep], feats[keep], labels[keep]
    if capacity is not None and len(xyz) > capacity:
        # uniform point-budget cap, the analogue of the reference's adaptive
        # FAST-threshold retuning toward its 15-28k target
        # (CvoPointCloud.cpp:283-323)
        sub = cap_indices(len(xyz), capacity, xyz.device)
        xyz, gtype, feats = xyz[sub], gtype[sub], feats[sub]
        labels = labels[sub] if labels is not None else None
    return _pad_cloud(xyz, feats, labels, gtype, bucket, capacity)


def _upload(a, dev) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    a = np.asarray(a)
    if a.dtype == np.uint16:
        a = a.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def pointcloud_from_stereo(
    left,
    right,
    calib: Calibration,
    method: str = sel.CV_FAST,
    semantics=None,
    denoise: bool = True,
    bucket: int = 1024,
    capacity: Optional[int] = None,
    disparity=None,
    stereo_backend: str = "auto",
    device=None,
) -> PointCloud:
    """JAX's signature, plus `device` (None means the card). Without
    `disparity` the disparity of the raw (not denoised) pair is computed on
    `dev` by compute_disparity (`stereo_backend` 'native': the native
    census-SGM bit for bit; 'opencv': cv2.StereoSGBM 3WAY bit for bit;
    'auto': JAX's rule, 'opencv' where cv2 is importable, else 'native'). A given `disparity`, a numpy array or a tensor on any device, goes
    to `dev`."""
    dev = resolve_device(device)
    raw = make_raw_image(left, semantics=semantics, denoise=denoise, device=dev)
    uv, gtype = sel.select_points(raw, "stereo", method)
    if disparity is None:
        disparity = compute_disparity(left, right, backend=stereo_backend, device=dev)
    xyz, valid = backproject_disparity(uv, _upload(disparity, dev), calib)
    good = valid & is_good_point(xyz, uv, raw.rows, raw.cols)
    return _finalize(raw, uv, gtype, xyz, good, bucket, capacity)


def pointcloud_from_rgbd(
    rgb,
    depth,
    calib: Calibration,
    method: str = sel.CV_FAST,
    semantics=None,
    denoise: bool = True,
    bucket: int = 1024,
    capacity: Optional[int] = None,
    max_range: float = 55.0,
    device=None,
) -> PointCloud:
    """JAX's signature (its denoiser is OpenCV's, make_raw_image's default),
    plus `device` (None means the card)."""
    dev = resolve_device(device)
    raw = make_raw_image(rgb, semantics=semantics, denoise=denoise, device=dev)
    uv, gtype = sel.select_points(raw, "rgbd", method)
    xyz, valid = backproject_depth(uv, _upload(depth, dev), calib)
    good = valid & (_norm3(xyz) < max_range)
    return _finalize(raw, uv, gtype, xyz, good, bucket, capacity)
