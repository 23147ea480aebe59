"""Lidar point selection on the device: per-ring edges and LOAM surfaces,
or LeGO-LOAM's range-image pipeline (port of
unified_cvo_tpu/frontend/lidar.py, which runs on the host in numpy and
scipy).

The scan goes up once; rings, edges, curvature, surfaces, the range image,
ground, segmentation and the LOAM features run on the device. What comes
back is counts: the flat-point count of the surface draw, the rest count of
LeGO-LOAM's surface draw, and the selected point count. Random draws are
made with numpy on the host from those counts, exactly as JAX draws them,
and go up as data.

The LOAM half (`method="loam"`) equals JAX bit for bit: norms in numpy's
order ((x*x + y*y) + z*z in float32, the root taken in float64 and rounded,
which is the correctly rounded float32 root numpy gives), the curvature's
rolled sums in JAX's order, the ratio divided in float64 and rounded, and
every comparison in the precision numpy makes it. The LeGO-LOAM half bins
and links with angles in float64 on both devices (JAX bins float32
arctan2, which differs between numpy, torch and CUDA in the last bit), so
its cells may differ from JAX's in a small share. Its connected components
and its per-ring feature loop are the hand kernels of ops/lidar.py.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from unified_cvo_tpu_torch.device import resolve_device
from unified_cvo_tpu_torch.frontend.pipeline import _pad_cloud, cap_indices
from unified_cvo_tpu_torch.ops import lidar as lidar_ops
from unified_cvo_tpu_torch.utils.pointcloud import PointCloud


def norm3(xyz: torch.Tensor) -> torch.Tensor:
    """`np.linalg.norm(xyz, axis=1)` of a float32 [N, 3] tensor, bit for
    bit on the CPU and the card."""
    s = (xyz[:, 0] * xyz[:, 0] + xyz[:, 1] * xyz[:, 1]) + xyz[:, 2] * xyz[:, 2]
    return torch.sqrt(s.to(torch.float64)).to(torch.float32)


def ring_ids(xyz: torch.Tensor, num_beams: int = 64) -> torch.Tensor:
    """Scanline index per point from azimuth wrap-around in scan order
    (reference get_quadrant + ring counter, LidarPointSelector.cpp:46-53,
    257-276). xyz is in the rotated camera-style frame (z forward, x right)."""
    x_h = xyz[:, 2]
    y_h = -xyz[:, 0]
    quad = torch.zeros(len(xyz), dtype=torch.int8, device=xyz.device)
    quad[(x_h > 0) & (y_h >= 0)] = 1
    quad[(x_h <= 0) & (y_h > 0)] = 2
    quad[(x_h < 0) & (y_h <= 0)] = 3
    quad[(x_h >= 0) & (y_h < 0)] = 4
    wrap = torch.zeros(len(xyz), dtype=torch.int64, device=xyz.device)
    wrap[1:] = ((quad[1:] == 1) & (quad[:-1] == 4)).to(torch.int64)
    return torch.clamp(torch.cumsum(wrap, 0), max=num_beams - 1)


def edge_detection(
    xyz: torch.Tensor,
    intensity: torch.Tensor,
    rings: torch.Tensor,
    intensity_bound: float = 0.4,
    depth_bound: float = 4.0,
    distance_bound: float = 40.0,
) -> torch.Tensor:
    """Boolean edge mask (reference edge_detection, LidarPointSelector.cpp:37-81):
    a point is an edge if its max neighbor depth jump or intensity jump along
    the scanline exceeds the bound, intensity > 0, and range < bound."""
    n = len(xyz)
    dev = xyz.device
    if n < 3:
        return torch.zeros(n, dtype=torch.bool, device=dev)
    dl = norm3(xyz[1:] - xyz[:-1])
    # JAX keeps both gradients in float64 arrays, so their bounds compare there
    depth_grad = torch.zeros(n, dtype=torch.float64, device=dev)
    depth_grad[1:-1] = torch.maximum(dl[:-1], dl[1:]).to(torch.float64)
    di = torch.abs(intensity[1:] - intensity[:-1])
    int_grad = torch.zeros(n, dtype=torch.float64, device=dev)
    int_grad[1:-1] = torch.maximum(di[:-1], di[1:]).to(torch.float64)
    same_ring = torch.zeros(n, dtype=torch.bool, device=dev)
    same_ring[1:-1] = (rings[1:-1] == rings[:-2]) & (rings[1:-1] == rings[2:])
    rng = norm3(xyz)
    nonzero = (xyz != 0).any(1)
    return (same_ring
            & ((int_grad > intensity_bound) | (depth_grad > depth_bound))
            & (intensity > 0.0) & nonzero & (rng < distance_bound))


def loam_curvature(xyz: torch.Tensor, rings: torch.Tensor, k: int = 5) -> torch.Tensor:
    """LOAM curvature c_i = |sum_{j in +-k} (p_j - p_i)| / (2k |p_i|) per
    scanline (LoamScanRegistration curvature region), float64 holding
    float32 values as JAX's array does; inf where the window leaves the
    ring."""
    n = len(xyz)
    window = torch.zeros_like(xyz)
    for off in range(-k, k + 1):
        if off != 0:
            window += torch.roll(xyz, -off, 0) - xyz
    valid = torch.ones(n, dtype=torch.bool, device=xyz.device)
    for off in (-k, k):
        valid &= torch.roll(rings, -off) == rings
    den = (2 * k) * torch.clamp(norm3(xyz), min=1e-6)
    ratio = (norm3(window).to(torch.float64) / den.to(torch.float64)).to(torch.float32)
    return torch.where(valid, ratio.to(torch.float64), math.inf)


def surface_selection(
    xyz: torch.Tensor,
    rings: torch.Tensor,
    num_want: int,
    distance_bound: float = 40.0,
    ground_height: float = -1.2,
    curvature_max: float = 0.1,
    seed: int = 0,
) -> torch.Tensor:
    """Boolean surface mask: low-curvature points, uniformly subsampled to
    the budget by numpy's `choice` over their positions (JAX draws
    `choice(idx, num_want)`, which picks the same positions)."""
    rng = norm3(xyz)
    c = loam_curvature(xyz, rings)
    flat = (c < curvature_max) & (rng < distance_bound) & (rng > 1.0)
    idx = torch.nonzero(flat).squeeze(1)
    if len(idx) > num_want:
        pos = np.random.default_rng(seed).choice(len(idx), num_want, replace=False)
        idx = torch.sort(idx[torch.from_numpy(pos).to(idx.device)]).values
    out = torch.zeros(len(xyz), dtype=torch.bool, device=xyz.device)
    out[idx] = True
    return out


# --------------------------------------------------------------- LeGO-LOAM
#
# The reference's LeGoLoamPointSelection (src/utils/LeGoLoamPointSelection.cpp)
# as the JAX package re-derives it: range-image projection (KITTI HDL-64
# geometry, LeGoLoamPointSelection.hpp:296-301), ground removal by
# inter-ring vertical angle (:281-318), segmentation with the
# atan2(d2 sin a, d1 - d2 cos a) > 60 deg criterion (:462-505), and LOAM
# feature association (:644-830).

LEGO_N_SCAN = 64
LEGO_HORIZON = 1800
LEGO_ANG_RES_X = 0.2
LEGO_ANG_RES_Y = 0.427
LEGO_ANG_BOTTOM = 24.9
LEGO_GROUND_ROWS = 50
LEGO_SEGMENT_THETA = math.radians(60.0)
LEGO_MIN_RANGE = 1.0


def project_range_image(xyz: torch.Tensor,
                        n_scan: int = LEGO_N_SCAN,
                        horizon: int = LEGO_HORIZON,
                        ang_res_x: float = LEGO_ANG_RES_X,
                        ang_res_y: float = LEGO_ANG_RES_Y,
                        ang_bottom: float = LEGO_ANG_BOTTOM,
                        min_range: float = LEGO_MIN_RANGE):
    """Project a camera-frame cloud to a [n_scan, horizon] range image.
    Returns (range_img float32, index_img int64) with inf / -1 for empty
    cells (projectPointCloud, LeGoLoamPointSelection.cpp:215-280). A cell
    hit by several points keeps the last, as the reference's assignment
    does (a max over point indices, so it does not depend on write order)."""
    dev = xyz.device
    rng = norm3(xyz)
    x, y, z = xyz.to(torch.float64).unbind(1)
    vert = torch.rad2deg(torch.atan2(-y, torch.sqrt(x * x + z * z)))
    row = torch.floor((vert + ang_bottom) / ang_res_y).to(torch.int64)
    horiz = torch.rad2deg(torch.atan2(z, -x))
    col = (-torch.round((horiz - 90.0) / ang_res_x) + horizon / 2).to(torch.int64)
    col = torch.where(col >= horizon, col - horizon, col)
    ok = ((row >= 0) & (row < n_scan) & (col >= 0) & (col < horizon)
          & (rng >= min_range) & torch.isfinite(rng))
    cell = (row * horizon + col)[ok]
    index = torch.full((n_scan * horizon,), -1, dtype=torch.int64, device=dev)
    index.scatter_reduce_(0, cell, torch.nonzero(ok).squeeze(1), "amax")
    range_img = torch.where(index >= 0, rng[index.clamp(min=0)], math.inf)
    return range_img.view(n_scan, horizon), index.view(n_scan, horizon)


def _angle_deg(d: torch.Tensor) -> torch.Tensor:
    """Elevation of the float32 vectors `d` [..., 3] in degrees, in float64."""
    d = d.to(torch.float64)
    return torch.rad2deg(torch.atan2(d[..., 1], torch.sqrt(d[..., 0] ** 2 + d[..., 2] ** 2)))


def ground_mask_range_image(xyz: torch.Tensor, index_img: torch.Tensor,
                            ground_rows: int = LEGO_GROUND_ROWS,
                            mount_angle: float = 0.0) -> torch.Tensor:
    """Ground cells: vertical angle between ring i and i+1 within 10 deg of
    the mount angle AND the lower point itself more than 3 deg below level
    (groundRemoval, LeGoLoamPointSelection.cpp:281-318)."""
    n_scan, horizon = index_img.shape
    ground = torch.zeros((n_scan, horizon), dtype=torch.bool, device=xyz.device)
    gi = min(ground_rows, n_scan - 1)
    lower = index_img[:gi]
    upper = index_img[1:gi + 1]
    valid = (lower >= 0) & (upper >= 0)
    pl_ = xyz[lower.clamp(min=0)]
    pu = xyz[upper.clamp(min=0)]
    is_g = (valid & (torch.abs(_angle_deg(pu - pl_) - mount_angle) <= 10.0)
            & (torch.abs(_angle_deg(pl_) - mount_angle) > 3.0))
    ground[:gi] |= is_g
    ground[1:gi + 1] |= is_g
    return ground


def segment_links(range_img: torch.Tensor, ground: torch.Tensor,
                  segment_theta: float = LEGO_SEGMENT_THETA,
                  alpha_x: float = math.radians(LEGO_ANG_RES_X),
                  alpha_y: float = math.radians(LEGO_ANG_RES_Y)):
    """The links of segment_range_image: (link_v [rows - 1, cols], link_h
    [rows, cols], valid [rows, cols]). Two valid adjacent cells join when
    atan2(d2 sin a, d1 - d2 cos a) > segment_theta, in float64 as numpy
    computes it (d2 times a float64 scalar)."""
    valid = torch.isfinite(range_img) & ~ground

    def link(a, b, va, vb, alpha):
        ok = torch.isfinite(a) & torch.isfinite(b) & va & vb
        d1 = torch.maximum(a, b).to(torch.float64)
        d2 = torch.minimum(a, b).to(torch.float64)
        ang = torch.atan2(d2 * math.sin(alpha), d1 - d2 * math.cos(alpha))
        return ok & (ang > segment_theta)

    link_v = link(range_img[:-1], range_img[1:], valid[:-1], valid[1:], alpha_y)
    link_h = link(range_img, range_img.roll(-1, 1), valid, valid.roll(-1, 1), alpha_x)
    return link_v, link_h, valid


def feasible_clusters(labels: torch.Tensor, valid: torch.Tensor,
                      min_cluster: int = 30, valid_point_num: int = 5,
                      valid_line_num: int = 3) -> torch.Tensor:
    """Cells of valid clusters: >= min_cluster cells, or >= valid_point_num
    cells on >= valid_line_num scan lines (:470-486). `labels` name each
    component by its smallest cell id."""
    n_scan, horizon = labels.shape
    n = n_scan * horizon
    lab = labels.reshape(-1).to(torch.int64)
    sel = valid.reshape(-1)
    counts = torch.bincount(lab[sel], minlength=n)
    row_of = torch.arange(n, device=lab.device) // horizon
    pairs = torch.unique(lab[sel] * n_scan + row_of[sel])
    line_counts = torch.bincount(pairs // n_scan, minlength=n)
    feasible = (counts >= min_cluster) | ((counts >= valid_point_num)
                                          & (line_counts >= valid_line_num))
    return (sel & feasible[lab]).view(n_scan, horizon)


def segment_range_image(range_img: torch.Tensor, ground: torch.Tensor,
                        segment_theta: float = LEGO_SEGMENT_THETA,
                        alpha_x: float = math.radians(LEGO_ANG_RES_X),
                        alpha_y: float = math.radians(LEGO_ANG_RES_Y),
                        min_cluster: int = 30,
                        valid_point_num: int = 5,
                        valid_line_num: int = 3) -> torch.Tensor:
    """Connected-component segmentation on the range image (labelComponents,
    LeGoLoamPointSelection.cpp:462-505): the links in torch, the components
    in `ops.lidar.components`, the cluster rule in torch. Returns the mask
    of segmented (non-ground, kept) cells."""
    link_v, link_h, valid = segment_links(range_img, ground, segment_theta, alpha_x, alpha_y)
    labels = lidar_ops.components(link_v, link_h)
    return feasible_clusters(labels, valid, min_cluster, valid_point_num, valid_line_num)


def loam_extract_features(range_img: torch.Tensor, index_img: torch.Tensor,
                          segmented: torch.Tensor, ground: torch.Tensor,
                          edge_threshold: float = 0.1, surface_rate: int = 4,
                          seed: int = 0):
    """LOAM feature association on the segmented cloud (extractFeatures
    :703-817): the per-ring corner picks in `ops.lidar.loam_features`; then
    1-in-`surface_rate` of each sector's remaining points as surfaces.
    JAX draws `rng.random(len(rest))` sector after sector from one
    generator; one draw of the total is the same stream, so the rest count
    is read once, drawn with numpy and uploaded, and the choice is made on
    the device. Returns (edge_point_indices, surface_point_indices) in
    JAX's order (ring by ring, column order)."""
    keep = segmented & (index_img >= 0)
    kind, rest_counts = lidar_ops.loam_features(range_img, keep, edge_threshold)
    kind = kind.reshape(-1)
    index = index_img.reshape(-1)
    rest = kind == lidar_ops.REST
    total = int(rest_counts.sum())
    u = torch.from_numpy(np.random.default_rng(seed).random(total)).to(index.device)
    draw = (torch.cumsum(rest.to(torch.int64), 0) - 1).clamp(min=0)
    chosen = rest & (u[draw] < 1.0 / surface_rate) if total else rest
    return index[kind == lidar_ops.EDGE], index[chosen]


def legoloam_select(xyz: torch.Tensor, seed: int = 0):
    """Full LeGO-LOAM selection pipeline (cloudHandler,
    LeGoLoamPointSelection.cpp:61-85). Returns (edge_indices,
    surface_indices) into `xyz` (camera-style frame)."""
    range_img, index_img = project_range_image(xyz)
    ground = ground_mask_range_image(xyz, index_img)
    segmented = segment_range_image(range_img, ground)
    return loam_extract_features(range_img, index_img, segmented, ground, seed=seed)


def _upload(a, dtype: torch.dtype, dev) -> torch.Tensor:
    """A host array or tensor as `dtype` on `dev` (cast on the host, as JAX
    casts with astype)."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(dtype).to(dev)


def pointcloud_from_lidar(
    points,
    num_want: int = 10000,
    beam_num: int = 64,
    semantics=None,
    num_classes: int = 19,
    intensity_bound: float = 0.4,
    depth_bound: float = 4.0,
    distance_bound: float = 40.0,
    bucket: int = 1024,
    capacity: Optional[int] = None,
    method: str = "loam",
    device=None,
) -> PointCloud:
    """[N,4] xyz+intensity (camera-style frame) -> PointCloud with a single
    intensity feature and edge geometric tags (1, 0), mirroring the lidar
    CvoPointCloud ctor (CvoPointCloud.cpp:964-1040). With `semantics`
    (per-point int labels), unlabeled (-1) points are dropped and one-hot
    label distributions attached (:1043-1136). method="loam" uses the
    per-ring edge + curvature-surface selector; method="legoloam" the
    LeGO-LOAM range-image pipeline. JAX's signature plus `device` (None
    means the card)."""
    dev = resolve_device(device)
    pts = _upload(points, torch.float32, dev)
    xyz = pts[:, :3].contiguous()
    intensity = pts[:, 3].contiguous()
    rings = ring_ids(xyz, beam_num)
    if method == "legoloam":
        e_idx, s_idx = legoloam_select(xyz)
        edges = torch.zeros(len(xyz), dtype=torch.bool, device=dev)
        edges[e_idx] = True
        surfaces = torch.zeros(len(xyz), dtype=torch.bool, device=dev)
        surfaces[s_idx] = True
        surfaces &= ~edges
    elif method == "loam":
        edges = edge_detection(xyz, intensity, rings, intensity_bound, depth_bound,
                               distance_bound)
        surfaces = surface_selection(xyz, rings, num_want, distance_bound)
    else:
        raise ValueError(f"unknown lidar selection method {method!r}")
    sel = edges | surfaces
    sem = None
    if semantics is not None:
        sem = _upload(semantics, torch.int64, dev)
        sel &= sem >= 0
    idx = torch.nonzero(sel).squeeze(1)
    if capacity is not None and len(idx) > capacity:
        # uniform point-budget cap (same contract as the image pipeline)
        idx = idx[cap_indices(len(idx), capacity, dev)]
    labels = None
    if sem is not None:
        labels = torch.nn.functional.one_hot(
            torch.clamp(sem[idx], 0, num_classes - 1), num_classes).to(torch.float32)
    gtype = torch.tensor([[1.0, 0.0]], device=dev).expand(len(idx), 2)
    return _pad_cloud(xyz[idx], intensity[idx, None], labels, gtype, bucket, capacity)
