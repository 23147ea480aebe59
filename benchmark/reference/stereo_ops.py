"""A frozen copy of the plain PyTorch versions of the stereo frontend's
stages, the reference that `correct` holds `pointcloud_from_stereo` against.

Copied from the measured package's modules (`ops/nlm_opencv.py`: cv2's
integer NL-means and 8-bit Lab; `ops/sgm.py::sgm_scan_plain`;
`ops/lidar.py::components_plain`; `ops/sgbm_opencv.py`: StereoSGBM 3WAY;
`frontend/image.py::opencv_gray`; `frontend/device.py::gradients`;
`frontend/selector.py`: FAST-9 with the adaptive threshold;
`frontend/stereo.py::opencv_settings`; `frontend/pipeline.py::cap_indices`)
at the commit that added this benchmark, with every hand
kernel replaced by its plain version (the SGM recurrence's Python loop and
the min-label propagation of the speckle filter's components). It imports
nothing of the measured package, so a later change to the package cannot
change the yardstick. `stereo_ref.py` composes these stages.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

H_STRENGTH = 10.0     # reference h and hColor
TEMPLATE = 7          # templateWindowSize
SEARCH = 21           # searchWindowSize

# ------------------------------------------------------------------ NL-means


def _shift_for(template: int) -> int:
    """getNearestPowerOf2: the smallest p with 2^p >= template^2."""
    p = 0
    while (1 << p) < template * template:
        p += 1
    return p


@functools.lru_cache(maxsize=None)
def weight_table(h: float, template: int, search: int, channels: int):
    """(fixed-point weights over almost_dist = box_ssd >> shift, shift).

    OpenCV's FastNlMeansDenoisingInvoker constructor with DistSquared:
    fixed_point_mult = INT_MAX // (search^2 * 255); dist = almost_dist *
    2^shift / template^2 in float64; w = exp(-dist / (h*h*channels)) with
    h*h*channels rounded to float32 as OpenCV's float arithmetic does;
    weight = cvRound(mult * w), zeroed below 0.001 * mult."""
    fpm = (2 ** 31 - 1) // (search * search * 255)
    shift = _shift_for(template)
    mult = float(1 << shift) / (template * template)
    denom = float(np.float32(np.float32(h) * np.float32(h)) * np.float32(channels))
    size = int(255 * 255 * channels / mult + 1)
    table = np.empty(size, np.int64)
    for a in range(size):
        w = math.exp(-(a * mult) / denom)
        wt = int(np.rint(fpm * w))
        table[a] = 0 if wt < 0.001 * fpm else wt
    return table, shift


def nlm_opencv(img_u8: torch.Tensor, h: float = H_STRENGTH, template: int = TEMPLATE,
               search: int = SEARCH) -> torch.Tensor:
    """cv2.fastNlMeansDenoising(img, None, h, template, search) on a uint8
    [H, W] or [H, W, C] tensor (C = 1..3 channels share one weight), bit
    for bit, on the tensor's device."""
    if img_u8.dtype != torch.uint8:
        raise ValueError(f"nlm_opencv takes uint8, got {img_u8.dtype}")
    chans = img_u8[..., None] if img_u8.ndim == 2 else img_u8
    Hh, Ww, C = chans.shape
    sr, tr = search // 2, template // 2
    B = sr + tr
    if min(Hh, Ww) <= B:
        raise ValueError(f"nlm_opencv needs both sides > {B} (reflect padding), "
                         f"got {Hh} x {Ww}")
    dev = img_u8.device
    table_np, shift = weight_table(float(h), template, search, C)
    Ht, Wt = Hh + 2 * tr, Ww + 2 * tr                                # template margin
    # int32 holds every sum while a column of box sums stays below 2^31
    # (OpenCV's own estimate sums are int); taller images take int64
    it = torch.int64 if Ht * template * 255 * 255 * C >= 2 ** 31 else torch.int32
    table = torch.from_numpy(table_np).to(dev, it)
    x = chans.permute(2, 0, 1).to(torch.float32)[None]
    pad = F.pad(x, (B, B, B, B), mode="reflect")[0].to(it)          # [C, H+2B, W+2B]
    centre = pad[:, sr:sr + Ht, sr:sr + Wt]
    est = torch.zeros((C, Hh, Ww), dtype=it, device=dev)
    wsum = torch.zeros((Hh, Ww), dtype=it, device=dev)
    S, T = 2 * sr + 1, template
    # a search row's offsets as one strided view: [S, C, Ht, Wt]
    for dy in range(S):
        nb = pad[:, dy:dy + Ht, :].unfold(2, Wt, 1).permute(2, 0, 1, 3)
        d = centre[None] - nb
        ssd = (d * d).sum(1, dtype=it)                                # [S, Ht, Wt]
        cw = F.pad(ssd.cumsum(2, dtype=it), (1, 0))
        rows = cw[:, :, T:] - cw[:, :, :-T]                           # [S, Ht, W]
        ch = F.pad(rows.cumsum(1, dtype=it), (0, 0, 1, 0))
        box = ch[:, T:] - ch[:, :-T]                                  # [S, H, W]
        w = table[(box >> shift).long()]
        p = nb[:, :, tr:tr + Hh, tr:tr + Ww]                          # [S, C, H, W]
        est += (w[:, None] * p).sum(0, dtype=it)
        wsum += w.sum(0, dtype=it)
    # est reaches 441 * 19096 * 255 = 2^31 - 42968 on a flat white patch, so
    # adding wsum / 2 leaves int32: OpenCV adds in unsigned, this in int64
    wsum = wsum.to(torch.int64)
    out = torch.div(est.to(torch.int64) + torch.div(wsum, 2, rounding_mode="floor"), wsum,
                    rounding_mode="floor")
    out = out.clamp(0, 255).to(torch.uint8).permute(1, 2, 0)
    return out[..., 0] if img_u8.ndim == 2 else out.contiguous()


# ------------------------------------------------------------ Lab, 8 bit

_LAB_SHIFT = 12       # xyz_shift
_GAMMA_SHIFT = 3
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT
_BASE = 1 << 14       # Lab2RGBinteger base
_INV_GAMMA = 1 << 12  # inverse-gamma table size
_MIN_AB = -8145
# sRGB2XYZ_D65, XYZ2sRGB_D65 (rows R, G, B / X, Y, Z) and the D65 white point
_RGB2XYZ = ((0.412453, 0.357580, 0.180423),
            (0.212671, 0.715160, 0.072169),
            (0.019334, 0.119193, 0.950227))
_XYZ2RGB = ((3.240479, -1.53715, -0.498535),
            (-0.969256, 1.875991, 0.041556),
            (0.055648, -0.204043, 1.057311))
_D65 = (0.950456, 1.0, 1.088754)
# OpenCV's softfloat cbrt: a quartic rational polynomial in float64 on the
# mantissa scaled into [0.125, 1)
_CBRT_NUM = (45.2548339756803022511987494, 192.2798368355061050458134625,
             119.1654824285581628956914143, 13.43250139086239872172837314,
             0.1636161226585754240958355063)
_CBRT_DEN = (14.80884093219134573786480845, 151.9714051044435648658557668,
             168.5254414101568283957668343, 33.9905941350215598754191872, 1.0)


def _softfloat_cbrt(a: np.float32) -> np.float32:
    """OpenCV's `cbrt(softfloat)`: the polynomial's float64 value, its
    fraction truncated (not rounded) to float32's 23 bits."""
    ia = int(np.asarray(a, np.float32).view(np.uint32))
    if ia & 0x7FFFFFFF == 0:
        return np.float32(0.0)
    sign = ia >> 31
    ex = ((ia >> 23) & 0xFF) - 127
    shx = int(math.fmod(ex, 3))
    shx -= 3 if shx >= 0 else 0
    ex = (ex - shx) // 3 - 1
    fr = float(np.asarray(((shx + 1023) << 52) | ((ia & 0x7FFFFF) << 29),
                          np.uint64).view(np.float64))
    num = den = 0.0
    for c in _CBRT_NUM:
        num = num * fr + c
    for c in _CBRT_DEN:
        den = den * fr + c
    frac = (int(np.asarray(num / den).view(np.uint64)) & ((1 << 52) - 1)) >> 29
    return np.asarray((sign << 31) | ((ex + 127) << 23) | frac, np.uint32).view(np.float32)[()]


def _c_div(a: int, b: int) -> int:
    """C's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


@functools.lru_cache(maxsize=None)
def _lab_tables():
    """The integer tables of OpenCV's initLabTabs that the two 8-bit
    conversions read, and their coefficients (BGR order)."""
    f32 = np.float32
    # RGB2Lab_b: LabCbrtTab_b over x = i / (255 * 8) in softfloat
    lthresh = f32(216) / f32(24389)
    lscale = f32(841) / f32(108)
    lbias = f32(16) / f32(116)
    scale = f32(1) / (f32(255) * f32(1 << _GAMMA_SHIFT))
    cbrt_tab = np.empty(256 * 3 // 2 * (1 << _GAMMA_SHIFT), np.int64)
    for i in range(len(cbrt_tab)):
        x = f32(scale * f32(i))
        if x < lthresh:        # mulAdd: one rounding
            v = f32(float(x) * float(lscale) + float(lbias))
        else:
            v = _softfloat_cbrt(x)
        cbrt_tab[i] = int(np.rint(f32(1 << _LAB_SHIFT2) * v))
    to_xyz = np.array([[int(np.rint((1 << _LAB_SHIFT) * _RGB2XYZ[r][c] / _D65[r]))
                        for c in (2, 1, 0)] for r in range(3)], np.int64)   # [XYZ, BGR]
    # Lab2RGBinteger: L -> (y, fy) in BASE units, a/b -> x/z, RGB rows
    yf = np.empty((256, 2), np.int64)
    for i in range(256):
        li = i * 100.0 / 255.0
        if li <= 8.0:
            y = li / 903.3
            fy = 7.787 * y + 16.0 / 116.0
        else:
            fy = (li + 16.0) / 116.0
            y = fy * fy * fy
        yf[i] = (int(np.rint(y * _BASE)), int(np.rint(fy * _BASE)))
    ab = np.empty(_BASE * 9 // 4, np.int64)
    off = _BASE * 16 // 116 * 108 // 841
    for k in range(len(ab)):
        i = k + _MIN_AB
        ab[k] = (_c_div(i * 108, 841) - off) if i <= 3390 else (i * i // _BASE) * i // _BASE
    to_bgr = np.array([[int(np.rint((1 << _LAB_SHIFT) * _XYZ2RGB[r][c] * _D65[c]))
                        for c in range(3)] for r in (2, 1, 0)], np.int64)  # [BGR, XYZ]
    inv_gamma = np.array([int(f32(255) * (f32(1) / f32(_INV_GAMMA) * f32(i)))
                          for i in range(_INV_GAMMA)], np.int64)          # cvTrunc
    return cbrt_tab, to_xyz, yf, ab, to_bgr, inv_gamma


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def lbgr_to_lab_u8(img: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(img, cv2.COLOR_LBGR2Lab) on uint8 [..., 3], exact."""
    cbrt_tab, to_xyz, *_ = _lab_tables()
    dev = img.device
    tab = torch.from_numpy(cbrt_tab).to(dev)
    bgr = img.to(torch.int64) << _GAMMA_SHIFT                 # linearGammaTab_b
    M = torch.from_numpy(to_xyz).to(dev)
    fX, fY, fZ = (tab[_descale((bgr * M[r]).sum(-1), _LAB_SHIFT)] for r in range(3))
    Lscale = (116 * 255 + 50) // 100
    Lshift = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)
    L = _descale(Lscale * fY + Lshift, _LAB_SHIFT2)
    a = _descale(500 * (fX - fY) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    b = _descale(200 * (fY - fZ) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    return torch.stack([L, a, b], -1).clamp(0, 255).to(torch.uint8)


def lab_to_lbgr_u8(lab: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(lab, cv2.COLOR_Lab2LBGR) on uint8 [..., 3], exact."""
    _, _, yf_np, ab_np, to_bgr, inv_np = _lab_tables()
    dev = lab.device
    yf = torch.from_numpy(yf_np).to(dev)
    abt = torch.from_numpy(ab_np).to(dev)
    inv = torch.from_numpy(inv_np).to(dev)
    M = torch.from_numpy(to_bgr).to(dev)
    v = lab.to(torch.int64)
    L, a, b = v[..., 0], v[..., 1], v[..., 2]
    y, ify = yf[L, 0], yf[L, 1]
    adiv = ((5 * a * 53687 + (1 << 7)) >> 13) - 128 * _BASE // 500
    bdiv = ((b * 41943 + (1 << 4)) >> 9) - 128 * _BASE // 200 + 1
    x = abt[ify + adiv - _MIN_AB]
    z = abt[ify - bdiv - _MIN_AB]
    xyz = torch.stack([x, y, z], -1)
    shift = _LAB_SHIFT + 14 - 12            # lab_shift + (base_shift - inv_gamma_shift)
    out = [inv[_descale((xyz * M[r]).sum(-1), shift).clamp(0, _INV_GAMMA - 1)]
           for r in range(3)]
    return torch.stack(out, -1).to(torch.uint8)


def fast_nl_means_denoising_colored(img_u8: torch.Tensor, h: float = H_STRENGTH,
                                    h_color: float = H_STRENGTH, template: int = TEMPLATE,
                                    search: int = SEARCH) -> torch.Tensor:
    """cv2.fastNlMeansDenoisingColored(img, None, h, hColor, template,
    search) on a uint8 BGR [H, W, 3] tensor."""
    lab = lbgr_to_lab_u8(img_u8)
    L = nlm_opencv(lab[..., 0].contiguous(), h, template, search)
    ab = nlm_opencv(lab[..., 1:].contiguous(), h_color, template, search)
    return lab_to_lbgr_u8(torch.cat([L[..., None], ab], -1))


INF = 1 << 28


def _shift_lines(a: torch.Tensor, fill: int) -> torch.Tensor:
    """a [g, L, X] moved one line along L (line l takes line l - 1), `fill`
    in line 0."""
    return F.pad(a[:, :-1], (0, 0, 1, 0), value=fill)


def sgm_scan_plain(costs: torch.Tensor, has_prev_masks, n_shift: int,
                   P1: int, P2: int, cap=None) -> torch.Tensor:
    """Batched SGM recurrence, a step of torch ops at a time (the plain
    version of csrc/sgm.cu).

    costs: [S, G, L, D] int32, contiguous: S scan steps of G direction
    members over L lines. has_prev_masks: [G, L] bool, lines whose in-step
    predecessor exists (applied from step 1; step 0 always starts a
    scanline), or None when every line has one. The last `n_shift`
    members shift their state +1 along L between steps (the diagonal
    directions: the predecessor is one line over). `cap` saturates Lc (None:
    no cap). Returns the per-step Lc volume [S, G, L, D] int32."""
    S, G, L, D = costs.shape
    out = torch.empty_like(costs)
    out[0] = costs[0]
    Lp = costs[0]
    minprev = Lp.amin(-1, keepdim=True)
    hp = None if has_prev_masks is None else has_prev_masks[:, :, None]
    for s in range(1, S):
        if n_shift:
            k = G - n_shift
            Lp = torch.cat([Lp[:k], _shift_lines(Lp[k:], INF)])
            minprev = torch.cat([minprev[:k], _shift_lines(minprev[k:], 0)])
        pd = F.pad(Lp, (1, 1), value=INF)
        best = torch.minimum(
            Lp, torch.minimum(torch.minimum(pd[..., :-2], pd[..., 2:]) + P1,
                              minprev + P2))
        Lc = costs[s] + best - minprev
        if cap is not None:
            Lc = torch.clamp(Lc, max=cap)
        if hp is not None:
            Lc = torch.where(hp, Lc, costs[s])
        out[s] = Lc
        Lp = Lc
        minprev = Lc.amin(-1, keepdim=True)
    return out


def components_plain(link_v: torch.Tensor, link_h: torch.Tensor, link_dr=None,
                     link_dl=None) -> torch.Tensor:
    """Connected components of the [rows, cols] grid with vertical links
    `link_v` [rows - 1, cols] ((r, c)-(r + 1, c)) and wrapped horizontal
    links `link_h` [rows, cols] ((r, c)-(r, (c + 1) % cols)), and where
    given the diagonal links `link_dr` [rows - 1, cols] ((r, c)-(r + 1,
    c + 1), its last column False) and `link_dl` [rows - 1, cols] ((r, c)-
    (r + 1, c - 1), its first column False). Returns int32 labels [rows,
    cols]: the smallest cell id of each cell's component. Min-label
    propagation over the links, then pointer jumping, until nothing
    changes."""
    rows, cols = link_h.shape
    dev = link_h.device
    ids = torch.arange(rows * cols, device=dev).view(rows, cols)
    a = [ids[:-1][link_v], ids[link_h]]
    b = [ids[1:][link_v], ids.roll(-1, 1)[link_h]]
    if link_dr is not None:
        a += [ids[:-1][link_dr], ids[:-1][link_dl]]
        b += [ids[1:].roll(-1, 1)[link_dr], ids[1:].roll(1, 1)[link_dl]]
    a, b = torch.cat(a), torch.cat(b)
    lab = ids.reshape(-1).clone()
    while True:
        low = torch.minimum(lab[a], lab[b])
        new = lab.scatter_reduce(0, a, low, "amin").scatter_reduce_(0, b, low, "amin")
        while True:
            jumped = new[new]
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, lab):
            return lab.to(torch.int32).view(rows, cols)
        lab = new


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
    top = sgm_scan_plain(blk, None, 0, P1, P2)                               # [n, stripes, W1, D]
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
    across = sgm_scan_plain(lines, None, 0, P1, P2)                          # [W1, 2, H, D]
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
    labels = components_plain(*speckle_links(disp, new_val, max_diff))
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


def opencv_gray(image: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(image, cv2.COLOR_BGR2GRAY) of a [H, W, 3] uint8 BGR
    tensor, as float32 grey levels on its device: OpenCV's 15-bit
    fixed-point rule (3735*B + 19235*G + 9798*R + 16384) >> 15, equal to
    cv2 5.0.0 on all 2^24 colours (tests/test_torch_frontend_host.py) and
    to cv2 4.13.0 (tests/torch_sgbm_cv2_probe.py). It is not the 14-bit
    rule (1868*B + 9617*G + 4899*R + 8192) >> 14 of the device frontends
    (`frontend/device.py::device_gray_and_gradients`), which rounds 43864
    colours the other way by one. The largest sum, 8,372,224, is below
    2^24, so float32 is exact."""
    img = image.to(torch.float32)
    return torch.floor((3735.0 * img[..., 0] + 19235.0 * img[..., 1]
                        + 9798.0 * img[..., 2] + 16384.0) * (1.0 / 32768.0))


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


def opencv_settings(max_disparity: int) -> dict:
    """JAX's StereoSGBM settings (unified_cvo_tpu/frontend/stereo.py): block
    7, P1 8 * 49, P2 32 * 49, disp12MaxDiff 1, uniquenessRatio 10, speckle
    window 100 and range 2, preFilterCap 31, as `sgbm_3way`'s keywords."""
    block = 7
    return dict(min_disparity=0, num_disparities=max_disparity, block_size=block,
                p1=8 * block * block, p2=32 * block * block, disp12_max_diff=1,
                uniqueness_ratio=10, speckle_window_size=100, speckle_range=2,
                pre_filter_cap=31)


def cap_indices(n: int, capacity: int, device=None) -> torch.Tensor:
    """`np.linspace(0, n - 1, capacity).astype(np.int64)` built as numpy
    builds it: arange * ((n - 1) / (capacity - 1)) in float64, the last index
    set to n - 1, truncated. `torch.linspace` computes the second half from
    the end and picks other indices for some (n, capacity)."""
    dev = device
    if capacity == 1:
        return torch.zeros(1, dtype=torch.int64, device=dev)
    step = (n - 1) / (capacity - 1)
    y = torch.arange(capacity, dtype=torch.float64, device=dev) * step
    y[-1] = n - 1
    return y.to(torch.int64)
