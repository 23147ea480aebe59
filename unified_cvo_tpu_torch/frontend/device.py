"""Fully on-device stereo and RGB-D frontends (port of
unified_cvo_tpu/frontend/device.py): raw images (and a depth map) in, a
registration-ready padded PointCloud on the device out.

The reference's measurement pipeline is host-bound C++/OpenCV: NL-means
denoise (RawImage.cpp:22-25), gradients (:55-81), DSO pixel selection
(CvoPixelSelector.cpp), backprojection + feature fill
(CvoPointCloud.cpp:459-564, 744-768). This module keeps the whole chain in
torch ops on one device: after the images are uploaded nothing returns to
the host, so the cloud feeds `models/align.py` directly.

Differences from the host DSO selector, forced by static shapes (as in
JAX):
- the grid potential `pot` is a parameter (default 3, the reference's
  starting potential) instead of the count-driven retuning loop
  (CvoPixelSelector.cpp:430-463);
- the output is a fixed `capacity`: when more grid cells pass their block
  threshold than fit, the strongest-gradient winners are kept, ties in cell
  order (a stable sort, as jnp.argsort is).
Block thresholds are the exact histogram-quantile math of makeHists
(CvoPixelSelector.cpp:85-147).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from unified_cvo_tpu_torch.device import resolve_device
from unified_cvo_tpu_torch.frontend.calibration import Calibration
from unified_cvo_tpu_torch.ops.nlm import nlm_denoise
from unified_cvo_tpu_torch.ops.sgm import sgm_disparity_device
from unified_cvo_tpu_torch.utils.pointcloud import PointCloud

_EMPTY_BLOCK = 1 << 20     # sorts after every gradient of a block's interior


def device_gray_and_gradients(image: torch.Tensor):
    """[H,W,3] BGR or [H,W] -> (gray, grad [H,W,2], grad_sq), float32 on the
    image's device: the grey level of the device frontends, as JAX's device
    frontend computes it.

    Colour takes the 14-bit fixed-point rule JAX's device frontend emulates,
    (1868*B + 9617*G + 4899*R + 8192) >> 14: with integer-valued uint8
    inputs every intermediate stays below 2^24, so float32 is exact. It is
    not cv2.cvtColor's BGR2GRAY, which the host frontend takes
    (`frontend/image.py::opencv_gray`); the two part by one on 43864 of the
    2^24 colours. Gradients as `gradients`."""
    img = torch.as_tensor(image).to(torch.float32)
    if img.ndim == 3:
        gray = torch.floor((1868.0 * img[..., 0] + 9617.0 * img[..., 1]
                            + 4899.0 * img[..., 2] + 8192.0) * (1.0 / 16384.0))
    else:
        gray = img
    return (gray,) + gradients(gray)


def gradients(gray: torch.Tensor):
    """[H,W] float32 grey -> (grad [H,W,2], grad_sq): central differences
    with zeroed borders (RawImage.cpp:55-81)."""
    dx = torch.zeros_like(gray)
    dy = torch.zeros_like(gray)
    dx[:, 1:-1] = 0.5 * (gray[:, 2:] - gray[:, :-2])
    dy[1:-1, :] = 0.5 * (gray[2:, :] - gray[:-2, :])
    dx[0, :] = 0.0
    dx[-1, :] = 0.0
    return torch.stack([dx, dy], dim=-1), dx * dx + dy * dy


def _blocks(a: torch.Tensor, h32: int, w32: int) -> torch.Tensor:
    """[H, W] -> [h32 * w32, 1024]: the full 32x32 blocks, row-major."""
    return (a[:h32 * 32, :w32 * 32].reshape(h32, 32, w32, 32)
            .permute(0, 2, 1, 3).reshape(h32 * w32, 1024))


def dso_block_thresholds(gs: torch.Tensor) -> torch.Tensor:
    """Per-32x32-block DSO thresholds (makeHists,
    CvoPixelSelector.cpp:85-147): histogram 0.5-quantile of
    int(sqrt(grad^2)) clipped to 48, +7, 3x3 block smoothing, squared."""
    h, w = gs.shape
    h32, w32 = h // 32, w // 32
    g = torch.clamp(torch.sqrt(torch.clamp(gs, min=0.0)).to(torch.int32), 0, 48)
    interior = torch.zeros((h, w), dtype=torch.bool, device=gs.device)
    interior[1:h - 1, 1:w - 1] = True
    gb = _blocks(g, h32, w32)
    ib = _blocks(interior, h32, w32)
    total = ib.sum(1)
    # histogram quantile == sorted[int(total*0.5 + 0.5)] over interior
    # values (non-interior sort to the end)
    vals = torch.sort(torch.where(ib, gb, _EMPTY_BLOCK), dim=1)[0]
    th_idx = (total.to(torch.float32) * 0.5 + 0.5).to(torch.int64).clamp(max=1023)
    q = vals.gather(1, th_idx[:, None])[:, 0]
    q = torch.where(q >= _EMPTY_BLOCK, 90, q)   # empty block fallback (ref :78)
    ths = (q + 7.0).to(torch.float32).reshape(h32, w32)
    pad = F.pad(ths, (1, 1, 1, 1))
    cnt = F.pad(torch.ones_like(ths), (1, 1, 1, 1))
    sm = 0.0
    n = 0.0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            sm = sm + pad[1 + dy:1 + dy + h32, 1 + dx:1 + dx + w32]
            n = n + cnt[1 + dy:1 + dy + h32, 1 + dx:1 + dx + w32]
    sm = sm / n
    return sm * sm


def dso_select_device(gs: torch.Tensor, ths_sm: torch.Tensor, pot: int, capacity: int,
                      th_factor: float = 1.0):
    """Grid selection (select(), CvoPixelSelector.cpp:270-426): per pot x pot
    cell keep the strongest pixel above its block threshold; the strongest
    `capacity` cells win when over budget, ties in cell order. Returns (uv
    [capacity, 2] int32, valid [capacity] bool)."""
    h, w = gs.shape
    dev = gs.device
    h32v = torch.clamp(torch.arange(h, device=dev) // 32, max=ths_sm.shape[0] - 1)
    w32v = torch.clamp(torch.arange(w, device=dev) // 32, max=ths_sm.shape[1] - 1)
    per_pix = ths_sm[h32v][:, w32v] * th_factor
    ok = gs > per_pix
    border = torch.zeros((h, w), dtype=torch.bool, device=dev)
    border[4:h - 4, 4:w - 4] = True
    gv = torch.where(ok & border, gs, -1.0)
    Hc, Wc = -(-h // pot), -(-w // pot)
    padded = F.pad(gv, (0, Wc * pot - w, 0, Hc * pot - h), value=-1.0)
    cells = (padded.reshape(Hc, pot, Wc, pot).permute(0, 2, 1, 3)
             .reshape(Hc * Wc, pot * pot))
    score, best = cells.amax(1), cells.argmax(1)            # -1 = no hit
    n_cells = Hc * Wc
    if n_cells < capacity:
        # pad so the output shapes hold when the grid has fewer cells than
        # the budget
        score = F.pad(score, (0, capacity - n_cells), value=-1.0)
        best = F.pad(best, (0, capacity - n_cells))
    order = torch.argsort(-score, stable=True)[:capacity]
    valid = score[order] > 0
    cell = torch.clamp(order, max=n_cells - 1)
    b = best[cell]
    oy, ox = b // pot, b % pot
    cy, cx = cell // Wc, cell % Wc
    uv = torch.stack([cx * pot + ox, cy * pot + oy], dim=1).to(torch.int32)
    return torch.where(valid[:, None], uv, 0), valid


def _cloud(xyz, mask, feats, capacity: int) -> PointCloud:
    keep = mask[:, None] > 0
    gtype = torch.tensor([[0.9, 0.1]], dtype=torch.float32, device=xyz.device)
    return PointCloud(xyz=torch.where(keep, xyz, 0.0), mask=mask,
                      features=torch.where(keep, feats, 0.0), labels=None,
                      geometric_types=gtype.expand(capacity, 2).contiguous())


def _backproject(u, v, depth, Kinv):
    homo = torch.stack([u.to(torch.float32), v.to(torch.float32),
                        torch.ones_like(u, dtype=torch.float32)], dim=1)
    return (homo @ Kinv.T) * depth[:, None]


def _features(img, gray, grad, u, v):
    g = grad[v, u] / 500.0 + 0.5
    if img.ndim == 3:
        return torch.cat([img[v, u] / 255.0, g], dim=-1)
    return torch.cat([gray[v, u, None] / 255.0, g], dim=-1)


def _rgbd_impl(img, depth, Kinv, depth_scale: float, pot, capacity, max_range, denoise):
    if denoise:
        img = nlm_denoise(img)
    gray, grad, gs = device_gray_and_gradients(img)
    uv, valid = dso_select_device(gs, dso_block_thresholds(gs), pot, capacity)
    u, v = uv[:, 0].long(), uv[:, 1].long()
    d = depth[v, u].to(torch.float32) / depth_scale
    z_ok = d > 1e-6
    xyz = _backproject(u, v, d, Kinv)
    rng_ok = torch.linalg.vector_norm(xyz, dim=1) < max_range
    mask = (valid & z_ok & rng_ok).to(torch.float32)
    return _cloud(xyz, mask, _features(img, gray, grad, u, v), capacity)


def _stereo_impl(img, right_gray, Kinv, fx_baseline: float, pot, capacity, max_disp,
                 max_range, v_min, v_bottom_margin, denoise):
    # matching runs on the RAW pair; denoise feeds features/gradients only
    gray_raw, _, _ = device_gray_and_gradients(img)
    if denoise:
        img = nlm_denoise(img)
    gray, grad, gs = device_gray_and_gradients(img)
    rg = right_gray.to(torch.float32)
    if rg.ndim == 3:
        rg, _, _ = device_gray_and_gradients(rg)
    disp = sgm_disparity_device(gray_raw, rg, max_disp=max_disp)
    uv, valid = dso_select_device(gs, dso_block_thresholds(gs), pot, capacity)
    u, v = uv[:, 0].long(), uv[:, 1].long()
    h, w = gray.shape

    # pt_depth_from_disparity gates (StaticStereo.hpp:29-43): interior
    # pixel, disparity > 0.05; depth = |b| fx / disp
    d = disp[v, u]
    d_ok = (u >= 1) & (u <= w - 2) & (v >= 1) & (v <= h - 2) & (d > 0.05)
    # a tensor numerator: a Python scalar over a tensor is its reciprocal
    # times the scalar in torch, which rounds differently from JAX's division
    depth = torch.full_like(d, fx_baseline) / torch.where(d_ok, d, 1.0)
    xyz = _backproject(u, v, depth, Kinv)
    # is_good_point (CvoPointCloud.cpp:39-57)
    good = ((u >= 2) & (u <= w - 2) & (v >= v_min) & (v <= h - v_bottom_margin)
            & (torch.linalg.vector_norm(xyz, dim=1) < max_range))
    mask = (valid & d_ok & good).to(torch.float32)
    return _cloud(xyz, mask, _features(img, gray, grad, u, v), capacity)


def _kinv(calib: Calibration, dev) -> torch.Tensor:
    return torch.as_tensor(np.linalg.inv(calib.intrinsic).astype(np.float32), device=dev)


def _upload(a, dev) -> torch.Tensor:
    """An image or depth map on `dev`, in its own dtype (uint8 images are a
    quarter of float32's bytes; the frontends cast on the device). uint16
    depth maps go up as int32, which holds them exactly."""
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    a = np.asarray(a)
    if a.dtype == np.uint16:
        a = a.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def device_pointcloud_from_stereo(
    left,
    right_gray,
    calib: Calibration,
    pot: int = 3,
    capacity: int = 8192,
    max_disp: int = 128,
    max_range: float = 55.0,
    v_min: int = 100,
    v_bottom_margin: int = 30,
    denoise: bool = False,
    device=None,
) -> PointCloud:
    """Whole stereo frontend on one device: left BGR (or gray) + right gray
    (or BGR) in, device-resident PointCloud out: census-SGM disparity
    (ops/sgm.py), DSO selection, backprojection and the reference's
    good-point gates. v_min/v_bottom_margin are the reference's hard-coded
    sky/hood crop (CvoPointCloud.cpp:39-57). `device=None` means the card."""
    dev = resolve_device(device)
    return _stereo_impl(
        _upload(left, dev).to(torch.float32), _upload(right_gray, dev), _kinv(calib, dev),
        float(np.float32(abs(calib.baseline) * calib.fx)), pot, capacity, max_disp,
        max_range, v_min, v_bottom_margin, denoise)


def device_pointcloud_from_rgbd(
    image,
    depth,
    calib: Calibration,
    pot: int = 3,
    capacity: int = 8192,
    max_range: float = 55.0,
    denoise: bool = False,
    device=None,
) -> PointCloud:
    """Image + depth map in, device-resident PointCloud out. `denoise=True`
    prepends NL-means (ops/nlm.py). `device=None` means the card."""
    dev = resolve_device(device)
    return _rgbd_impl(
        _upload(image, dev).to(torch.float32), _upload(depth, dev), _kinv(calib, dev),
        float(np.float32(calib.depth_scale or 1.0)), pot, capacity, max_range, denoise)
