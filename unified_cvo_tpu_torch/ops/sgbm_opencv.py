"""OpenCV's StereoSGBM in MODE_SGBM_3WAY, computed as OpenCV computes it, in
torch ops on any device.

The JAX package's `compute_disparity(backend="opencv")` (and its "auto"
wherever cv2 imports) is `cv2.StereoSGBM_create(..., mode=
STEREO_SGBM_MODE_SGBM_3WAY).compute(left, right)` on grey uint8 images
(unified_cvo_tpu/frontend/stereo.py). `sgbm_3way` gives the same int16 map
(disparity x 16, invalid pixels (minDisparity - 1) x 16) without OpenCV,
stage by stage as OpenCV's stereosgbm.cpp runs them:

1. Prefilter: a horizontal Sobel, 2 (r[x+1] - r[x-1]) plus the same
   difference of the rows above and below (the first and last rows stand in
   for their missing neighbour), clipped to +-ftzero and offset by ftzero,
   ftzero = max(preFilterCap, 15) | 1. Columns 0 and W - 1 hold ftzero, in
   the prefiltered row and in the raw-intensity row alike.
2. Pixel costs for the columns x in [max(maxD, 0), W + min(minD, 0)):
   Birchfield-Tomasi on the prefiltered rows plus Birchfield-Tomasi on the
   raw rows shifted right by 2. BT's half-pixel bounds are (p + neighbour)
   // 2, the neighbour itself at the row's ends.
3. The block sum: the pixel costs box-summed over block_size x block_size,
   borders replicated: at the left and right ends of those columns, at the
   image's last row, and at the first row of the stripe (below).
4. Three path costs with OpenCV's recurrence, Lc = c + min(Lp[d], Lp[d +-
   1] + P1, min Lp + P2) - min Lp, each path restarting at Lc = c: left to
   right, right to left, and top to bottom. The top-down path runs in 4
   stripes of ceil(H / 4) rows, each starting `stripe_overlap` =
   block_size // 2 + 1 + ceil(0.1 x stripe) rows above its first row (at
   row 0 at the least). A stripe whose start is clamped to 0 keeps OpenCV's
   row offset: its output row i is its computed row overlap + i % stripe,
   invalid where that row is past its end (images under ~14 rows a stripe).
   The count 4 is fixed in OpenCV, so the result does not depend on the
   thread count. `ops/sgm.py::_sgm_scan` runs every path: on the card
   as one launch of the hand kernel in csrc/sgm.cu a scan (`top`, then
   `across`), on the CPU as its plain loop of torch ops.
5. Winner-take-all on the sum of the three paths, with the tie rule of
   OpenCV's 128-bit SIMD search: 8 lanes (d mod 8) each keep their last
   minimum, and the smallest of those positions that hold the overall
   minimum wins.
6. Uniqueness (ratio u > 0): the pixel is invalid where a cost at |d -
   best| > 1 is below (short)(100 min // (100 - u) + 1), the threshold of
   OpenCV's SIMD loop (which truncates to int16).
7. Subpixel on the 16x scale: 16 d + ((S[d-1] - S[d+1]) 16 + k) / (2 k),
   k = max(S[d-1] + S[d+1] - 2 S[d], 1), C's truncating division; d * 16
   at d = 0 and d = D - 1.
8. The right image's disparity from the same sums: each valid pixel
   scatters its disparity to x - d; the least cost wins, ties to the
   largest x (OpenCV's right-to-left order and strict compare). Then the
   pseudo left-right check with disp12MaxDiff (values <= 0 mean 1): a
   pixel is invalid where both floor(d / 16) and ceil(d / 16) disagree
   with a valid right disparity by more than it.
9. Columns left of max(maxD, 0) (and right of W + minD where minD < 0) are
   invalid.
10. StereoSGBM::compute then runs medianBlur(disp, 3) (replicated border)
    and, where speckleWindowSize > 0, filterSpeckles(newVal (minD - 1) 16,
    maxSpeckleSize speckleWindowSize, maxDiff 16 speckleRange).
11. filterSpeckles: 4-connected regions of pixels != newVal whose
    neighbours differ by at most maxDiff; a region of at most
    maxSpeckleSize pixels becomes newVal. The regions are the connected
    components of those links (ops/lidar.py::components: the L1 kernel on
    the card, its plain version on the CPU).

Every cost is an integer held in int32; `sgbm_3way` refuses settings under
which OpenCV's int16 sums could saturate (3 (block cost + P2) > 32767: at
block 7, preFilterCap 31, the largest block cost is 6125 and the three-path
sum at most 23079), so int32 gives OpenCV's int16 bits. Every step is an
integer op or an order-free reduction, so the card and the CPU give the
same bytes. tests/test_torch_sgbm_opencv.py holds it to cv2 5.0.0 bit for
bit. The scans are plain torch ops, ~11 launches a step, W - D steps across
and ~H / 4 + overlap steps down (a hand kernel is ROADMAP queue 2 item d).
"""

from __future__ import annotations

import math

import torch

from unified_cvo_tpu_torch.ops import lidar
from unified_cvo_tpu_torch.ops.sgm import _sgm_scan

DISP_SHIFT = 4
DISP_SCALE = 1 << DISP_SHIFT      # StereoMatcher::DISP_SCALE
N_STRIPES = 4                     # fixed in StereoSGBM::compute for MODE_SGBM_3WAY
SIMD_LANES = 8                    # int16 lanes of OpenCV's 128-bit universal intrinsics
SHRT_MAX = 32767


def _clamped(n: int, lo: int, hi: int, shift: int, device) -> torch.Tensor:
    return torch.clamp(torch.arange(n, device=device) + shift, lo, hi)


def _prefiltered(g: torch.Tensor, ftzero: int) -> torch.Tensor:
    """[H, W] int32: the clipped horizontal Sobel + ftzero, ftzero in the
    first and last columns."""
    h, w = g.shape
    up = g[_clamped(h, 0, h - 1, -1, g.device)]
    dn = g[_clamped(h, 0, h - 1, 1, g.device)]
    s = (2 * (g[:, 2:] - g[:, :-2]) + (up[:, 2:] - up[:, :-2]) + (dn[:, 2:] - dn[:, :-2]))
    out = torch.full_like(g, ftzero)
    out[:, 1:-1] = s.clamp(-ftzero, ftzero) + ftzero
    return out


def _raw(g: torch.Tensor, ftzero: int) -> torch.Tensor:
    """The raw intensities with ftzero in the first and last columns, as
    calcPixelCostBT's row buffers hold them."""
    r = g.clone()
    r[:, 0] = ftzero
    r[:, -1] = ftzero
    return r


def _bt_bounds(p: torch.Tensor):
    """(min, max) of p and its half-pixel neighbours (p + p[x -+ 1]) // 2,
    p itself past the row's ends."""
    w = p.shape[1]
    left = p[:, _clamped(w, 0, w - 1, -1, p.device)]
    right = p[:, _clamped(w, 0, w - 1, 1, p.device)]
    a, b = (p + left) >> 1, (p + right) >> 1
    return torch.minimum(torch.minimum(a, b), p), torch.maximum(torch.maximum(a, b), p)


def _pixel_costs(g1: torch.Tensor, g2: torch.Tensor, min_d: int, D: int, x0: int, x1: int,
                ftzero: int) -> torch.Tensor:
    """calcPixelCostBT: [H, x1 - x0, D] int32 costs of left columns x in
    [x0, x1) at disparities min_d + d."""
    dev = g1.device
    xr = (torch.arange(x0, x1, device=dev)[:, None] - min_d
          - torch.arange(D, device=dev)[None, :])                     # right column x - d
    cost = None
    for rows, shift in ((_prefiltered, 0), (_raw, 2)):
        p, q = rows(g1, ftzero), rows(g2, ftzero)
        (u0, u1), (v0, v1) = _bt_bounds(p), _bt_bounds(q)
        u, u0, u1 = (t[:, x0:x1, None] for t in (p, u0, u1))
        v, v0, v1 = (t[:, xr] for t in (q, v0, v1))
        c0 = torch.maximum(u - v1, v0 - u).clamp(min=0)
        c1 = torch.maximum(v - u1, u0 - v).clamp(min=0)
        c = torch.minimum(c0, c1) >> shift
        cost = c if cost is None else cost.add_(c)
    return cost


def _box_columns(pc: torch.Tensor, r: int) -> torch.Tensor:
    """Sum over the 2r + 1 columns around each column, the end columns
    replicated (getRawMatchingCost's running hsum)."""
    w1 = pc.shape[1]
    out = pc.clone()
    for j in range(1, r + 1):
        out += pc[:, _clamped(w1, 0, w1 - 1, -j, pc.device)]
        out += pc[:, _clamped(w1, 0, w1 - 1, j, pc.device)]
    return out


def _stripes(h: int, block_size: int):
    """The 3WAY row split: (stripe rows, overlap, [(source start, source
    end, first output row, rows out)]) for the stripes that hold output
    rows."""
    sz = math.ceil(h / N_STRIPES)
    ov = block_size // 2 + 1 + math.ceil(0.1 * sz)
    out = []
    for k in range(N_STRIPES):
        if k * sz >= h:
            break
        out.append((max(min(k * sz - ov, h), 0), min((k + 1) * sz, h), k * sz,
                    min(sz, h - k * sz)))
    return sz, ov, out


def _path_sums(hs: torch.Tensor, h: int, block_size: int, r: int, P1: int, P2: int):
    """The three-path sums [H, W1, D] int32 of the output rows, and which
    output rows OpenCV computes (False: a clamped stripe's rows past its
    end)."""
    dev = hs.device
    _, ov, parts = _stripes(h, block_size)
    n = max(e - s for s, e, _, _ in parts)
    # block costs of each stripe's rows, the stripe's first row replicated up
    # and the image's last row down; a short stripe repeats its last row
    ys = torch.stack([(torch.arange(n, device=dev) + s).clamp(max=e - 1)
                      for s, e, _, _ in parts], 1)                     # [n, stripes]
    lo = torch.tensor([s for s, _, _, _ in parts], device=dev)
    blk = hs[ys]
    for j in range(1, r + 1):
        blk += hs[torch.maximum(ys - j, lo)]
        blk += hs[(ys + j).clamp(max=h - 1)]
    top = _sgm_scan(blk, None, 0, P1, P2)                               # [n, stripes, W1, D]
    src, stripe, computed = [], [], []
    for k, (s, e, first, rows) in enumerate(parts):
        y = torch.arange(rows, device=dev) + (first if k == 0 else s + ov)
        computed.append(y < e)
        src.append(y.clamp(max=e - 1) - s)
        stripe.append(torch.full_like(y, k))
    src, stripe = torch.cat(src), torch.cat(stripe)
    c = blk[src, stripe]                                                # [H, W1, D]
    total = top[src, stripe]
    del blk, top
    lines = torch.stack([c.transpose(0, 1), c.flip(1).transpose(0, 1)], 1).contiguous()
    del c
    across = _sgm_scan(lines, None, 0, P1, P2)                          # [W1, 2, H, D]
    del lines
    total += across[:, 0].transpose(0, 1)
    total += across[:, 1].flip(0).transpose(0, 1)
    return total, torch.cat(computed)


def _winner(S: torch.Tensor):
    """(least cost, its disparity index) over the last axis of S, ties
    resolved as OpenCV's SIMD search resolves them: each of 8 lanes keeps
    its last minimum, the smallest such index holding the least cost
    wins."""
    D = S.shape[-1]
    least = S.amin(-1)
    d = torch.arange(D, device=S.device).view(D // SIMD_LANES, SIMD_LANES)
    at = (S == least[..., None]).view(*S.shape[:-1], D // SIMD_LANES, SIMD_LANES)
    lane_last = torch.where(at, d, -1).amax(-2)                         # [..., 8]
    best = torch.where(lane_last >= 0, lane_last, D).amin(-1)
    return least, best


def _int16(x: torch.Tensor) -> torch.Tensor:
    """x cast to C's short (two's complement wrap)."""
    return ((x + 32768) & 0xFFFF) - 32768


def median3(disp: torch.Tensor) -> torch.Tensor:
    """medianBlur(disp, 3): the median of each 3 x 3 window, the border
    replicated."""
    h, w = disp.shape
    rows = [disp[_clamped(h, 0, h - 1, dy, disp.device)] for dy in (-1, 0, 1)]
    cols = [_clamped(w, 0, w - 1, dx, disp.device) for dx in (-1, 0, 1)]
    return torch.stack([r[:, c] for r in rows for c in cols]).median(0).values


def speckle_links(disp: torch.Tensor, new_val: int, max_diff: int):
    """(link_v [H - 1, W], link_h [H, W]) of filter_speckles: 4-neighbours
    both != new_val and within max_diff, no link out of the last column
    (lidar.components wraps its rows)."""
    v = disp != new_val
    link_v = v[:-1] & v[1:] & ((disp[1:] - disp[:-1]).abs() <= max_diff)
    link_h = torch.zeros_like(v)
    link_h[:, :-1] = v[:, :-1] & v[:, 1:] & ((disp[:, 1:] - disp[:, :-1]).abs() <= max_diff)
    return link_v, link_h


def filter_speckles(disp: torch.Tensor, new_val: int, max_size: int,
                    max_diff: int) -> torch.Tensor:
    """cv2.filterSpeckles: the 4-connected regions of pixels != new_val
    whose neighbours differ by at most max_diff become new_val where they
    hold at most max_size pixels."""
    labels = lidar.components(*speckle_links(disp, new_val, max_diff))
    labels = labels.reshape(-1).to(torch.int64)
    size = torch.bincount(labels, minlength=labels.numel())[labels].view_as(disp)
    return torch.where((disp != new_val) & (size <= max_size), new_val, disp)


def sgbm_3way(left, right, min_disparity: int = 0, num_disparities: int = 16,
              block_size: int = 3, p1: int = 0, p2: int = 0, disp12_max_diff: int = 0,
              uniqueness_ratio: int = 0, speckle_window_size: int = 0, speckle_range: int = 0,
              pre_filter_cap: int = 0) -> torch.Tensor:
    """cv2.StereoSGBM_create(minDisparity, numDisparities, blockSize, P1,
    P2, disp12MaxDiff, preFilterCap, uniquenessRatio, speckleWindowSize,
    speckleRange, mode=STEREO_SGBM_MODE_SGBM_3WAY).compute(left, right):
    the int16 [H, W] map on the inputs' device (defaults are cv2's).
    left / right: grey [H, W] uint8 images (arrays or tensors). Raises
    ValueError where OpenCV would fail or read past its buffers (the image
    not wider than num_disparities plus block_size // 2), for
    num_disparities not a positive multiple of 16 (OpenCV's contract),
    uniqueness_ratio >= 100 (OpenCV divides by zero) and block_size < 1,
    and where its int16 sums could saturate (not emulated)."""
    g1 = torch.as_tensor(left)
    g2 = torch.as_tensor(right).to(g1.device)
    if g1.dim() != 2 or tuple(g1.shape) != tuple(g2.shape):
        raise ValueError(f"sgbm_3way: left {tuple(g1.shape)} and right {tuple(g2.shape)} "
                         f"must be one grey [H, W] shape")
    if g1.dtype != torch.uint8 or g2.dtype != torch.uint8:
        raise ValueError("sgbm_3way: left and right must be uint8 images")
    D = num_disparities
    if D <= 0 or D % 16:
        raise ValueError(f"sgbm_3way: num_disparities {D} must be a positive multiple of 16")
    if block_size < 1 or uniqueness_ratio >= 100:
        raise ValueError(f"sgbm_3way: block_size {block_size} must be >= 1 and "
                         f"uniqueness_ratio {uniqueness_ratio} < 100")
    g1, g2 = g1.to(torch.int32), g2.to(torch.int32)
    dev = g1.device
    h, w = g1.shape
    min_d, max_d = min_disparity, min_disparity + D
    invalid = (min_d - 1) * DISP_SCALE
    ftzero = max(pre_filter_cap, 15) | 1
    r = block_size // 2
    P1 = p1 if p1 > 0 else 2
    P2 = max(p2 if p2 > 0 else 5, P1 + 1)
    uniq = uniqueness_ratio if uniqueness_ratio >= 0 else 10
    lr_max = disp12_max_diff if disp12_max_diff > 0 else 1
    x0, x1 = max(max_d, 0), w + min(min_d, 0)
    if x1 - x0 <= r:
        raise ValueError(f"sgbm_3way: width {w} leaves {x1 - x0} matched columns at "
                         f"disparities [{min_d}, {max_d}); OpenCV needs more than {r}")
    largest = (2 * r + 1) ** 2 * (2 * ftzero + (255 >> 2))
    if 3 * (largest + P2) > SHRT_MAX:
        raise ValueError(f"sgbm_3way: block cost up to {largest} with P2 {P2} can saturate "
                         f"OpenCV's int16 path sums (not emulated)")

    S, computed = _path_sums(_box_columns(_pixel_costs(g1, g2, min_d, D, x0, x1, ftzero), r),
                             h, block_size, r, P1, P2)
    least, best = _winner(S)
    dd = torch.arange(D, device=dev)
    ok = computed[:, None].expand_as(best)
    if uniq > 0:
        thresh = _int16(torch.div(100 * least, 100 - uniq, rounding_mode="trunc") + 1)
        rival = (S < thresh[..., None]) & ((dd - best[..., None]).abs() > 1)
        ok = ok & ~rival.any(-1)
    # subpixel on the 16x scale
    sm = S.gather(-1, (best - 1).clamp(min=0)[..., None])[..., 0]
    sp = S.gather(-1, (best + 1).clamp(max=D - 1)[..., None])[..., 0]
    del S
    k = (sm + sp - 2 * least).clamp(min=1)
    sub = best * DISP_SCALE + torch.div((sm - sp) * DISP_SCALE + k, 2 * k, rounding_mode="trunc")
    scaled = torch.where((best > 0) & (best < D - 1), sub, best * DISP_SCALE)
    row = torch.where(ok, scaled + min_d * DISP_SCALE, invalid)

    # the right image's disparity: least cost per x - d, ties to the largest x
    xs = torch.arange(x0, x1, device=dev)
    x2 = xs - best - min_d
    hit = ok & (x2 >= 0) & (x2 < w)
    key = least.to(torch.int64) * (w + 1) + (w - 1 - xs)
    none = torch.iinfo(torch.int64).max
    kb = torch.full((h, w + 1), none, dtype=torch.int64, device=dev)
    kb.scatter_reduce_(1, torch.where(hit, x2, w), torch.where(hit, key, none), "amin")
    kb = kb[:, :w]
    cols = torch.arange(w, device=dev)
    disp2 = torch.where(kb < none, (w - 1 - kb % (w + 1)) - cols, invalid)

    def disagrees(xx, dv):
        other = disp2.gather(1, xx.clamp(0, w - 1))
        return (xx >= 0) & (xx < w) & (other >= min_d) & ((other - dv).abs() > lr_max)

    lo_d = row >> DISP_SHIFT
    hi_d = (row + DISP_SCALE - 1) >> DISP_SHIFT
    bad = (row != invalid) & disagrees(xs - lo_d, lo_d) & disagrees(xs - hi_d, hi_d)
    disp = torch.full((h, w), invalid, dtype=torch.int32, device=dev)
    disp[:, x0:x1] = torch.where(bad, invalid, row)

    disp = median3(disp)
    if speckle_window_size > 0:
        disp = filter_speckles(disp, invalid, speckle_window_size,
                               DISP_SCALE * speckle_range)
    return disp.to(torch.int16)
