"""Image point selection on the device: FAST-adaptive, DSO-style and FULL
(port of unified_cvo_tpu/frontend/selector.py).

Reference: select_points_from_image (src/utils/CvoPointCloud.cpp:258-381).
Selected pixels carry a 2-vector geometric type (edge, surface).

CV_FAST reproduces cv2.FastFeatureDetector (FAST-9/16, no non-maximum
suppression) without OpenCV: one pass gives every pixel its FAST score, the
largest threshold t at which cv2 reports it (a pixel is a corner at t when
9 contiguous pixels of its 16-pixel circle are all brighter than p + t or
all darker than p - t). The reference's adaptive threshold search then
replays on the counts #(score >= t), read once as a 256-bin histogram, and
the keypoints at the chosen threshold come out in raster order, as cv2
emits them.

EDGES_ONLY is cv2.Canny(gray, 50, 150) exactly (ops/canny.py) and JAX's
random quarter-budget draw over the edge pixels, drawn on the host from
the same numpy stream. CANNY_EDGES puts cv2.ORB's keypoints first
(frontend/orb.py, exact and in cv2's order), then the same edge draw, then
JAX's uniform surface draw from that stream.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from unified_cvo_tpu_torch.frontend import device as fe
from unified_cvo_tpu_torch.frontend import orb
from unified_cvo_tpu_torch.frontend.image import RawImage
from unified_cvo_tpu_torch.ops.canny import canny

CV_FAST = "CV_FAST"
DSO_EDGES = "DSO_EDGES"
CANNY_EDGES = "CANNY_EDGES"
EDGES_ONLY = "EDGES_ONLY"
FULL = "FULL"

# the FAST-9/16 circle in cv2's order (dx, dy)
FAST_CIRCLE = ((0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
               (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3))
FAST_ARC = 9
FAST_BORDER = 3
FAST_LEVELS = 256            # score histogram bins: thresholds 0..255


def fast_scores(gray: torch.Tensor) -> torch.Tensor:
    """[H, W] grey levels (integer valued) -> int32 [H, W] FAST-9 scores:
    the max over the 16 arcs of 9 circle pixels of min(x - p) - 1 (brighter)
    and min(p - x) - 1 (darker). cv2 reports the pixel at threshold t iff
    score >= t. The 3-pixel border, which cv2 skips, scores -1."""
    g = gray.to(torch.int32)
    h, w = g.shape
    b = FAST_BORDER
    p = g[b:h - b, b:w - b]
    d = torch.stack([g[b + dy:h - b + dy, b + dx:w - b + dx] - p
                     for dx, dy in FAST_CIRCLE])          # [16, H-6, W-6]
    lo, hi = d, d
    span = 1
    while span < FAST_ARC - 1:                               # windows of 2, 4, 8
        lo = torch.minimum(lo, torch.roll(lo, -span, 0))
        hi = torch.maximum(hi, torch.roll(hi, -span, 0))
        span *= 2
    lo = torch.minimum(lo, torch.roll(d, -span, 0))          # the 9th pixel
    hi = torch.maximum(hi, torch.roll(d, -span, 0))
    inner = torch.maximum(lo.amax(0), (-hi).amax(0)) - 1
    return F.pad(inner, (b, b, b, b), value=-1)


def fast_histogram(score: torch.Tensor) -> torch.Tensor:
    """counts[t] = #(score >= t) for t in 0..255, on the score's device."""
    hist = torch.bincount(torch.clamp(score.reshape(-1), -1, FAST_LEVELS - 1) + 1,
                          minlength=FAST_LEVELS + 1)[1:]
    return torch.flip(torch.cumsum(torch.flip(hist, (0,)), 0), (0,))


def fast_adaptive_threshold(counts, pt_type: str, num_classes: int) -> int:
    """The reference's adaptive threshold search (CvoPointCloud.cpp:273-323,
    JAX selector._fast_adaptive) replayed on the counts: the first detection
    runs at threshold 5 whatever `thresh` starts at; the search climbs while
    over `num_want` up to `break_thresh`, then descends while under
    `num_min` down to 0. Returns the threshold of the last detection."""
    if pt_type == "rgbd":
        thresh, num_want, num_min, break_thresh = 9, 15000, 12000, 13
    else:  # stereo
        thresh, num_want, num_min, break_thresh = 4, 24000, 15000, 50
        if num_classes > 0:
            num_want = 28000

    def count(t):
        return int(counts[min(max(t, 0), FAST_LEVELS - 1)])

    detected = 5
    n = count(detected)
    while n > num_want:
        thresh += 1
        detected = thresh
        n = count(detected)
        if thresh == break_thresh:
            break
    while n < num_min:
        thresh -= 1
        detected = thresh
        n = count(detected)
        if thresh == 0:
            break
    return detected


def fast_select(gray: torch.Tensor, pt_type: str, num_classes: int):
    """(uv [N,2] int32 in raster order, geometric type [N,2], the
    threshold): FAST with the adaptive search, one score pass and one
    histogram read."""
    score = fast_scores(gray)
    thr = fast_adaptive_threshold(fast_histogram(score).tolist(), pt_type, num_classes)
    vu = torch.nonzero(score >= thr)                          # row-major: raster order
    uv = torch.stack([vu[:, 1], vu[:, 0]], dim=1).to(torch.int32)
    gtype = torch.tensor([[1.0, 0.0]], dtype=torch.float32,
                         device=gray.device).expand(len(uv), 2).contiguous()
    return uv, gtype, thr


def _dso_select_pot(gs: torch.Tensor, ths_sm: torch.Tensor, pot: int,
                    th_factor: float = 1.0) -> torch.Tensor:
    """One DSO selection pass at grid potential `pot` (reference select(),
    CvoPixelSelector.cpp:270-426): in every pot x pot cell keep the pixel
    with the largest grad^2 among those above the block threshold, the first
    in cell order on ties. Returns uv [N,2] int32, cells in raster order."""
    h, w = gs.shape
    dev = gs.device
    h32v = torch.clamp(torch.arange(h, device=dev) // 32, max=ths_sm.shape[0] - 1)
    w32v = torch.clamp(torch.arange(w, device=dev) // 32, max=ths_sm.shape[1] - 1)
    ok = gs > ths_sm[h32v][:, w32v] * th_factor
    border = torch.zeros((h, w), dtype=torch.bool, device=dev)
    border[4:h - 4, 4:w - 4] = True
    gv = torch.where(ok & border, gs, -1.0)
    Hc, Wc = -(-h // pot), -(-w // pot)
    padded = F.pad(gv, (0, Wc * pot - w, 0, Hc * pot - h), value=-1.0)
    cells = padded.reshape(Hc, pot, Wc, pot).permute(0, 2, 1, 3).reshape(Hc, Wc, pot * pot)
    best = cells.argmax(-1)
    cy, cx = torch.nonzero(cells.amax(-1) > 0, as_tuple=True)
    b = best[cy, cx]
    return torch.stack([cx * pot + b % pot, cy * pot + b // pot], dim=1).to(torch.int32)


def _dso_make_heat_maps(gs, ths_sm, num_want, pot, recursions_left):
    """makeHeatMaps (CvoPixelSelector.cpp:152-266): select at the current
    potential, then adapt it with DSO's ideal-potential model and recurse
    while the yield is >1.25x or <0.25x the budget. Returns (uv, final
    potential). One count read per pass. The reference's dead paths
    (pyramid levels 1-2, direction distribution, the thinning that never
    filters output_uv) stay out, as in JAX."""
    uv = _dso_select_pot(gs, ths_sm, pot)
    num_have = max(len(uv), 1)
    quotia = num_want / num_have
    ideal = int(math.sqrt(num_have * (pot + 1) ** 2 / num_want) - 1)
    ideal = max(ideal, 1)
    if recursions_left > 0 and quotia > 1.25 and pot > 1:
        if ideal >= pot:
            ideal = pot - 1
        return _dso_make_heat_maps(gs, ths_sm, num_want, ideal, recursions_left - 1)
    if recursions_left > 0 and quotia < 0.25:
        if ideal <= pot:
            ideal = pot + 1
        return _dso_make_heat_maps(gs, ths_sm, num_want, ideal, recursions_left - 1)
    return uv, pot


def dso_select_pixels(raw: RawImage, num_want: int):
    """The DSO semi-dense pixel selector (CvoPixelSelector.cpp:430-463, JAX
    selector.dso_select_pixels, a numpy function whose outputs this equals):
    makeHeatMaps at potential 3 with 3 adaptation recursions; while too many
    points come back, retry at growing potentials (up to 5 tries); if fewer
    than 2/3 of the budget remain, back off two steps."""
    gs = raw.gradient_square
    ths_sm = fe.dso_block_thresholds(gs)
    uv, pot = _dso_make_heat_maps(gs, ths_sm, num_want, 3, 3)
    times = 1
    while len(uv) > num_want and times < 5:
        uv, pot = _dso_make_heat_maps(gs, ths_sm, num_want, 3 + times, 3)
        times += 1
    if len(uv) < num_want * 2 // 3:
        uv, pot = _dso_make_heat_maps(gs, ths_sm, num_want, max(3 + times - 2, 1), 3)
    gtype = torch.tensor([[0.9, 0.1]], dtype=torch.float32,
                         device=gs.device).expand(len(uv), 2).contiguous()
    return uv, gtype


def canny_uniform_orb(gray: torch.Tensor, use_orb_uniform: bool, expected_points: int,
                      seed: int):
    """JAX's _canny_uniform_orb (stereo_surface_sampling,
    CvoPointCloud.cpp:151-256) with Canny always on and ORB and the uniform
    draw together (CANNY_EDGES) or off (EDGES_ONLY): ORB's keypoints
    (nfeatures expected_points // 3, int() of their float positions), then
    the edge pixels in raster order, each kept where its draw from
    np.random.default_rng(seed) is below (expected_points / 4) / n_edge,
    then the non-edge pixels whose (h, w) draw is below 0.1, each kept where
    its next draw is below (3/4 expected_points) / n_surface. Edges and
    keypoints are typed (1, 0), surfaces (0, 1). uv [N,2] int32 (u =
    column) on the image's device; the draws are made on the host."""
    dev = gray.device
    rng = np.random.default_rng(seed)
    edges = canny(gray)
    parts = []
    if use_orb_uniform:
        parts.append(orb.detect(gray, expected_points // 3).pt.to(torch.int32))
    vu = torch.nonzero(edges)                                   # raster order
    n_edge = len(vu)
    if n_edge:
        draw = torch.from_numpy(rng.random(n_edge)).to(dev)
        vu = vu[draw < (expected_points / 4) / n_edge]
    parts.append(vu.flip(1).to(torch.int32))
    n_typed_edge = sum(len(p) for p in parts)
    if use_orb_uniform:
        h, w = gray.shape
        su = torch.nonzero(torch.from_numpy(rng.random((h, w)) < 0.1).to(dev) & ~edges)
        n_surf = len(su)
        if n_surf:
            draw = torch.from_numpy(rng.random(n_surf)).to(dev)
            su = su[draw < (expected_points * 3 / 4) / n_surf]
        parts.append(su.flip(1).to(torch.int32))
    uv = torch.cat(parts)
    gtype = torch.zeros((len(uv), 2), dtype=torch.float32, device=dev)
    gtype[:n_typed_edge, 0] = 1.0
    gtype[n_typed_edge:, 1] = 1.0
    return uv, gtype


def select_points(
    raw: RawImage,
    pt_type: str = "stereo",
    method: str = CV_FAST,
    expected_points: int = 10000,
    seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (uv [N,2] int32 (u=col, v=row), geometric_type [N,2]) on the
    image's device. `seed` seeds the random sampling of EDGES_ONLY and
    CANNY_EDGES."""
    if method == CV_FAST:
        uv, gtype, _ = fast_select(raw.intensity, pt_type, raw.num_classes)
        return uv, gtype
    if method == DSO_EDGES:
        return dso_select_pixels(raw, expected_points)
    if method in (CANNY_EDGES, EDGES_ONLY):
        return canny_uniform_orb(raw.intensity, method == CANNY_EDGES, expected_points, seed)
    if method == FULL:
        h, w = raw.rows, raw.cols
        dev = raw.image.device
        vv, uu = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                                indexing="ij")
        uv = torch.stack([uu.reshape(-1), vv.reshape(-1)], dim=1).to(torch.int32)
        gtype = torch.tensor([[0.5, 0.5]], dtype=torch.float32,
                             device=dev).expand(len(uv), 2).contiguous()
        return uv, gtype
    raise ValueError(f"unknown selection method {method}")
