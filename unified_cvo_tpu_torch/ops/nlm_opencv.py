"""OpenCV's fastNlMeansDenoising(Colored) and its 8-bit Lab conversions,
computed as OpenCV computes them, in torch on any device.

The reference denoises every incoming frame with
`cv2.fastNlMeansDenoisingColored(img, None, 10, 10, 7, 21)` (grey frames:
`cv2.fastNlMeansDenoising(img, None, 10, 7, 21)`; src/utils/RawImage.cpp:22-25),
and so does the JAX package's default `make_raw_image(denoise_engine='opencv')`.
This module gives the same bytes without OpenCV:

- `nlm_opencv`: OpenCV's integer NL-means (fast_nlmeans_denoising_invoker.hpp).
  The image is padded by search/2 + template/2 with BORDER_REFLECT_101. For
  each of the search x search offsets, the squared difference summed over the
  channels is box-summed over the template window, shifted right by
  the smallest power of two >= template^2, and looked up in a weight table
  built on the host in float64 (`weight_table`). Weight x offset pixel and
  the weight add into integer sums (int32 as in OpenCV, int64 for images
  too tall for int32 box columns); the output is (est + wsum / 2) / wsum,
  integer division in int64 (OpenCV's unsigned). Every sum is an integer,
  so the order of the offsets does not matter and card and CPU give the
  same bytes. The offsets run one search row at a time (search offsets a
  chunk).
- `lbgr_to_lab_u8`, `lab_to_lbgr_u8`: OpenCV's 8-bit COLOR_LBGR2Lab
  (RGB2Lab_b: linear gamma, fixed-point XYZ, the 3072-entry cube-root table
  of OpenCV's softfloat `cbrt`, whose float64 quotient is truncated to
  float32) and COLOR_Lab2LBGR (Lab2RGBinteger: the L and a/b tables, integer
  XYZ to RGB, the truncating linear inverse-gamma table). The tables are
  computed here from OpenCV's formulas and constants.
- `fast_nl_means_denoising_colored`: LBGR -> Lab, NL-means on L (h) and on
  the 2-channel ab image (hColor), then Lab -> LBGR, which is what OpenCV's
  colour call does (denoising.cpp).

`python tests/test_torch_nlm_opencv.py` holds the two conversions against an
installed cv2 on all 2^24 inputs each.
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
