"""cv2.ORB_create(nfeatures).detect(gray), exact, without OpenCV.

JAX's CANNY_EDGES selection (unified_cvo_tpu/frontend/selector.py:188-191,
the reference's stereo_surface_sampling, CvoPointCloud.cpp:151-256) runs
OpenCV's ORB detector at its defaults; the port imports no OpenCV, so
this module gives the keypoints of OpenCV 5.0's orb.cpp (computeKeyPoints,
HARRIS_SCORE) bit for bit and in its order:

a. level budgets: n0 = n (1 - f) / (1 - f^8) with f = (float)(1 / 1.2),
   cvRound of the running float value on every level but the last, which
   takes the remainder (`level_budgets`);
b. level l is (cvRound(cols / s_l), cvRound(rows / s_l)) with s_l =
   (float)pow(1.2, l), the division a float product by (float)(1 / s_l)
   (`level_sizes`);
c. each level resized from the one before with INTER_LINEAR_EXACT, cv2's
   fixed-point linear resize: 8-bit weights, a 16-bit horizontal pass and a
   rounded vertical one (`resize_linear_exact`, `pyramid`);
d. FAST-9/16 at threshold 20 with non-maximum suppression on each level: a
   corner survives where its score (cv2's cornerScore, selector.fast_scores)
   is strictly above each of its 8 neighbours', a non-corner counting 0;
   raster order (`fast_corners`);
e. runByImageBorder(31): corners with 31 <= x < w - 31, 31 <= y < h - 31,
   none on a level of 62 pixels or fewer across;
f. retainBest(2 budget) on the FAST scores: libstdc++'s std::nth_element,
   then std::partition of the rest by >= the n-th response (`retain_best`);
g. Harris responses over the 7 x 7 block of 3 x 3 Sobel-like derivatives,
   k = 0.04f, every float32 step rounded in the C++'s order
   (`harris_responses`);
h. retainBest(budget) on the Harris responses; levels concatenated;
i. points back to level 0: pt * s_l in float32.

Stages b-e and g run as torch ops on the image's device; a, f and h on the
host, where their work is (the selection is a few thousand keypoints a
level, in libstdc++'s exact order: the cloud's point order follows it).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

N_LEVELS = 8
SCALE_FACTOR = float(np.float32(1.2))   # ORB_create's float 1.2, kept as a double
EDGE_THRESHOLD = 31
FAST_THRESHOLD = 20
HARRIS_BLOCK = 7
HARRIS_K = np.float32(0.04)
# 1 / (4 * blockSize * 255) to the fourth power, each product in float32
_HS = np.float32(1.0) / (np.float32(4 * HARRIS_BLOCK) * np.float32(255.0))
HARRIS_SCALE4 = np.float32(np.float32(np.float32(_HS * _HS) * _HS) * _HS)


@dataclass
class Keypoints:
    """ORB keypoints in cv2's order: `pt` float32 [n, 2] (x, y) at level 0,
    `octave` int32 [n] (the pyramid level), `response` float32 [n] (Harris),
    all on the image's device."""

    pt: torch.Tensor
    octave: torch.Tensor
    response: torch.Tensor

    def __len__(self):
        return len(self.pt)


def level_budgets(nfeatures: int) -> List[int]:
    """computeKeyPoints' nfeaturesPerLevel, in float32 as the C++ does it."""
    f32 = np.float32
    factor = f32(1.0 / SCALE_FACTOR)
    per_scale = f32(f32(nfeatures) * (f32(1) - factor)
                    / (f32(1) - f32(math.pow(float(factor), N_LEVELS))))
    out = []
    for _ in range(N_LEVELS - 1):
        out.append(int(np.rint(per_scale)))
        per_scale = f32(per_scale * factor)
    out.append(max(nfeatures - sum(out), 0))
    return out


def level_scales() -> List[np.float32]:
    """layerScale[l] = (float)pow(1.2, l)."""
    return [np.float32(math.pow(SCALE_FACTOR, level)) for level in range(N_LEVELS)]


def level_sizes(cols: int, rows: int) -> List[Tuple[int, int]]:
    """(width, height) of each level: cvRound(cols * (float)(1 / scale))."""
    out = []
    for s in level_scales():
        inv = np.float32(1) / s
        out.append((int(np.rint(np.float32(cols) * inv)), int(np.rint(np.float32(rows) * inv))))
    return out


@lru_cache(maxsize=64)
def _linear_exact_axis(src: int, dst: int):
    """interpolationLinear::getCoeffs of cv2's resize_bitExact along one axis:
    (the first source index, its right neighbour, the 8-bit weight of the
    right one) per destination index, in double as softdouble computes them;
    destinations left of the source repeat its first pixel, right of it its
    last (weights 256 / 0)."""
    scale = 1.0 / (dst / src)
    lo = np.zeros(dst, np.int64)
    w1 = np.zeros(dst, np.int64)
    for v in range(dst):
        f = scale * (v + 0.5) - 0.5
        i = math.floor(f)
        if i >= 0 and src > 1:
            if i < src - 1:
                lo[v] = i
                w1[v] = round((f - i) * 256)           # cvRound: half to even
            else:
                lo[v] = src - 1
    hi = np.minimum(lo + 1, src - 1)
    return lo, hi, w1


def resize_linear_exact(img: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """cv2.resize(img, (width, height), interpolation=INTER_LINEAR_EXACT) of
    a uint8 [H, W] tensor on its device: a horizontal pass in 8.8 fixed
    point, a vertical one in 16.16, rounded to uint8. (cv2 takes INTER_AREA
    instead at exactly half size on both axes; ORB's 1.2 steps never do.)"""
    h0, w0 = img.shape
    if 2 * width == w0 and 2 * height == h0:
        raise ValueError("cv2 resizes by exactly 1/2 with INTER_AREA, which is not emulated")
    dev = img.device
    xl, xh, xw = (torch.from_numpy(a).to(dev) for a in _linear_exact_axis(w0, width))
    yl, yh, yw = (torch.from_numpy(a).to(dev) for a in _linear_exact_axis(h0, height))
    s = img.to(torch.int32)
    xw, yw = xw.to(torch.int32), yw.to(torch.int32)
    row = s[:, xl] * (256 - xw) + s[:, xh] * xw                   # [H, width], 8.8
    out = (row[yl] * (256 - yw)[:, None] + row[yh] * yw[:, None] + 32768) >> 16
    return out.to(torch.uint8)


def pyramid(gray: torch.Tensor) -> List[torch.Tensor]:
    """ORB's image pyramid: level 0 the image, level l resized from level
    l - 1 (orb.cpp's prevImg) to level_sizes' size."""
    h, w = gray.shape
    levels = [gray]
    for width, height in level_sizes(w, h)[1:]:
        levels.append(resize_linear_exact(levels[-1], width, height))
    return levels


def fast_corners(img: torch.Tensor, border: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """cv2.FAST(img, FAST_THRESHOLD, nonmaxSuppression=True), then
    runByImageBorder(border): (xy int64 [n, 2], score int32 [n]) in raster
    order. A corner is kept where its score exceeds each of its 8
    neighbours' (non-corners and the 3-pixel border count 0)."""
    from unified_cvo_tpu_torch.frontend.selector import FAST_BORDER, fast_scores

    h, w = img.shape
    dev = img.device
    lim = max(border, FAST_BORDER)
    if h <= 2 * lim or w <= 2 * lim:
        return (torch.zeros((0, 2), dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev))
    score = fast_scores(img)
    corner = score >= FAST_THRESHOLD
    sc = torch.where(corner, score, 0)
    p = F.pad(sc, (1, 1, 1, 1))
    nb = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                s = p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                nb = s if nb is None else torch.maximum(nb, s)
    keep = corner & (sc > nb)
    if border > 0:
        inside = torch.zeros_like(keep)
        inside[border:h - border, border:w - border] = True
        keep &= inside
    yx = torch.nonzero(keep)
    return yx.flip(1), sc[keep]


def harris_responses(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """orb.cpp's HarrisResponses(blockSize 7, k 0.04f) at integer points xy
    [n, 2] of a uint8 level: integer sums a = sum Ix^2, b = sum Iy^2, c =
    sum Ix Iy over the 7 x 7 block, then (a b - c c - k (a + b)(a + b)) *
    scale^4 in float32, one eager op a step (each rounds; no FMA)."""
    dev = img.device
    if len(xy) == 0:
        return torch.zeros(0, dtype=torch.float32, device=dev)
    r = HARRIS_BLOCK // 2 + 1
    d = torch.arange(-r, r + 1, device=dev)
    ys = (xy[:, 1:2] + d)[:, :, None]
    xs = (xy[:, 0:1] + d)[:, None, :]
    p = img[ys, xs].to(torch.int32)                               # [n, 9, 9]
    n = HARRIS_BLOCK
    ix = ((p[:, 1:n + 1, 2:] - p[:, 1:n + 1, :n]) * 2 + (p[:, :n, 2:] - p[:, :n, :n])
          + (p[:, 2:, 2:] - p[:, 2:, :n]))
    iy = ((p[:, 2:, 1:n + 1] - p[:, :n, 1:n + 1]) * 2 + (p[:, 2:, :n] - p[:, :n, :n])
          + (p[:, 2:, 2:] - p[:, :n, 2:]))
    a, b, c = ((u * v).sum((1, 2)).to(torch.float32) for u, v in ((ix, ix), (iy, iy), (ix, iy)))
    k = torch.tensor(HARRIS_K, device=dev)
    s4 = torch.tensor(HARRIS_SCALE4, device=dev)
    t = a * b
    t = t - c * c
    s = a + b
    t = t - (k * s) * s
    return t * s4


# ---- libstdc++'s std::nth_element and std::partition (bits/stl_algo.h,
# bits/stl_heap.h), on a list of item ids compared by `key` (greater first)


def _nth_element(a: list, nth: int, key: Sequence[float]) -> None:
    first, last = 0, len(a)
    if first == last or nth == last:
        return
    depth = ((last - first).bit_length() - 1) * 2              # std::__lg(n) * 2
    while last - first > 3:
        if depth == 0:
            _heap_select(a, first, nth + 1, last, key)
            a[first], a[nth] = a[nth], a[first]
            return
        depth -= 1
        cut = _unguarded_partition_pivot(a, first, last, key)
        if cut <= nth:
            first = cut
        else:
            last = cut
    _insertion_sort(a, first, last, key)


def _unguarded_partition_pivot(a, first, last, key):
    mid = first + (last - first) // 2
    x, y, z = first + 1, mid, last - 1                        # __move_median_to_first
    kx, ky, kz = key[a[x]], key[a[y]], key[a[z]]
    if kx > ky:
        m = y if ky > kz else (z if kx > kz else x)
    elif kx > kz:
        m = x
    elif ky > kz:
        m = z
    else:
        m = y
    a[first], a[m] = a[m], a[first]
    pivot = key[a[first]]
    lo, hi = first + 1, last                                  # __unguarded_partition
    while True:
        while key[a[lo]] > pivot:
            lo += 1
        hi -= 1
        while pivot > key[a[hi]]:
            hi -= 1
        if not lo < hi:
            return lo
        a[lo], a[hi] = a[hi], a[lo]
        lo += 1


def _insertion_sort(a, first, last, key):
    for i in range(first + 1, last):
        v = a[i]
        kv = key[v]
        if kv > key[a[first]]:
            a[first + 1:i + 1] = a[first:i]
            a[first] = v
        else:                                                 # __unguarded_linear_insert
            j = i
            while kv > key[a[j - 1]]:
                a[j] = a[j - 1]
                j -= 1
            a[j] = v


def _adjust_heap(a, first, hole, length, value, key):
    top = second = hole
    while second < (length - 1) // 2:
        second = 2 * (second + 1)
        if key[a[first + second]] > key[a[first + second - 1]]:
            second -= 1
        a[first + hole] = a[first + second]
        hole = second
    if (length & 1) == 0 and second == (length - 2) // 2:
        second = 2 * (second + 1)
        a[first + hole] = a[first + second - 1]
        hole = second - 1
    parent = (hole - 1) // 2                                  # __push_heap
    while hole > top and key[a[first + parent]] > key[value]:
        a[first + hole] = a[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    a[first + hole] = value


def _heap_select(a, first, middle, last, key):
    length = middle - first
    if length >= 2:                                           # __make_heap
        parent = (length - 2) // 2
        while True:
            _adjust_heap(a, first, parent, length, a[first + parent], key)
            if parent == 0:
                break
            parent -= 1
    for i in range(middle, last):
        if key[a[i]] > key[a[first]]:                         # __pop_heap
            v = a[i]
            a[i] = a[first]
            _adjust_heap(a, first, 0, length, v, key)


def _partition(a, first, last, keep) -> int:
    """std::partition on bidirectional iterators."""
    while True:
        while True:
            if first == last:
                return first
            if keep(a[first]):
                first += 1
            else:
                break
        last -= 1
        while True:
            if first == last:
                return first
            if not keep(a[last]):
                last -= 1
            else:
                break
        a[first], a[last] = a[last], a[first]
        first += 1


def retain_best(responses: Sequence[float], n_points: int) -> List[int]:
    """KeyPointsFilter::retainBest: the indices of the kept keypoints in the
    order the C++ leaves them (nth_element by response, greater first, then
    the rest partitioned by >= the n-th response: ties are kept)."""
    a = list(range(len(responses)))
    if n_points < 0 or len(a) <= n_points:
        return a
    if n_points == 0:
        return []
    key = list(responses)
    _nth_element(a, n_points - 1, key)
    boundary = key[a[n_points - 1]]
    end = _partition(a, n_points, len(a), lambda i: key[i] >= boundary)
    return a[:end]


def _take(order: List[int], *tensors):
    if not order:
        return tuple(t[:0] for t in tensors)
    idx = torch.tensor(order, dtype=torch.int64, device=tensors[0].device)
    return tuple(t[idx] for t in tensors)


def detect(gray: torch.Tensor, nfeatures: int) -> Keypoints:
    """cv2.ORB_create(nfeatures).detect(gray) on a uint8 [H, W] tensor (grey
    levels of any dtype are cast), on its device; see the module docstring
    for the stages."""
    img = gray if gray.dtype == torch.uint8 else gray.to(torch.uint8)
    dev = img.device
    budgets = level_budgets(nfeatures)
    scales = level_scales()
    pts, octaves, responses = [], [], []
    for level, im in enumerate(pyramid(img)):
        xy, score = fast_corners(im, EDGE_THRESHOLD)
        xy, = _take(retain_best(score.tolist(), 2 * budgets[level]), xy)
        resp = harris_responses(im, xy)
        xy, resp = _take(retain_best(resp.tolist(), budgets[level]), xy, resp)
        pts.append(xy.to(torch.float32) * torch.tensor(scales[level], device=dev))
        octaves.append(torch.full((len(xy),), level, dtype=torch.int32, device=dev))
        responses.append(resp)
    return Keypoints(torch.cat(pts), torch.cat(octaves), torch.cat(responses))
