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

`compute_disparity` is JAX's with both its backends, on the inputs' device:
"native" is the C++ census-SGM of native/cvo_native.cpp bit for bit
(`ops/sgm.py::sgm_disparity_native`); "opencv" is cv2.StereoSGBM in
MODE_SGBM_3WAY at JAX's settings, its int16 map bit for bit
(`ops/sgbm_opencv.py::sgbm_3way`) divided by 16. `backend="auto"` is
JAX's rule: "opencv" where cv2 is importable, "native" elsewhere
(`auto_backend`, which looks for the module without importing it).
"""

from __future__ import annotations

import importlib.util

import numpy as np
import torch

from unified_cvo_tpu_torch.device import resolve_device
from unified_cvo_tpu_torch.frontend.calibration import Calibration
from unified_cvo_tpu_torch.frontend.device import _upload
from unified_cvo_tpu_torch.frontend.image import opencv_gray
from unified_cvo_tpu_torch.ops.sgbm_opencv import sgbm_3way
from unified_cvo_tpu_torch.ops.sgm import sgm_disparity_native


def opencv_settings(max_disparity: int) -> dict:
    """JAX's StereoSGBM settings (unified_cvo_tpu/frontend/stereo.py): block
    7, P1 8 * 49, P2 32 * 49, disp12MaxDiff 1, uniquenessRatio 10, speckle
    window 100 and range 2, preFilterCap 31, as `sgbm_3way`'s keywords."""
    block = 7
    return dict(min_disparity=0, num_disparities=max_disparity, block_size=block,
                p1=8 * block * block, p2=32 * block * block, disp12_max_diff=1,
                uniqueness_ratio=10, speckle_window_size=100, speckle_range=2,
                pre_filter_cap=31)


def auto_backend() -> str:
    """The backend "auto" stands for: "opencv" where cv2 is importable (JAX
    then takes cv2.StereoSGBM), else "native"."""
    return "opencv" if importlib.util.find_spec("cv2") is not None else "native"


def compute_disparity(left, right, max_disparity: int = 128, backend: str = "auto",
                      device=None) -> torch.Tensor:
    """Left-image disparity map [H, W] float32, invalid pixels <= 0, on
    `device` (None: the inputs' device where they are tensors, else the
    card). left / right: BGR [H, W, 3] or grey [H, W] uint8 images, colour
    converted as cv2.cvtColor's BGR2GRAY converts it (`opencv_gray`), for
    both backends, as JAX converts it. backend 'native':
    native/cvo_native.cpp's census-SGM bit for bit (p1 10, p2 120,
    uniqueness 0.1, the 120-pixel region speckle); 'opencv': StereoSGBM
    3WAY at `opencv_settings`, its int16 map / 16 (invalid pixels -1);
    'auto': `auto_backend()`, JAX's rule."""
    if backend not in ("native", "auto", "opencv"):
        raise ValueError(f"unknown stereo backend {backend!r}")
    if backend == "auto":
        backend = auto_backend()
    if device is None and isinstance(left, torch.Tensor):
        dev = left.device
    else:
        dev = resolve_device(device)

    def gray(im):
        im = _upload(im, dev)
        return opencv_gray(im).to(torch.uint8) if im.ndim == 3 else im

    if backend == "opencv":
        disp = sgbm_3way(gray(left), gray(right), **opencv_settings(max_disparity))
        return disp.to(torch.float32) / 16.0
    return sgm_disparity_native(gray(left), gray(right), max_disp=max_disparity)


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
