"""Non-local-means image denoising in torch ops (port of
unified_cvo_tpu/ops/nlm.py): the RawImage preprocessing on the device.

The reference denoises every incoming frame with OpenCV's CPU
fastNlMeansDenoising(Colored) (h=10, template 7, search 21;
src/utils/RawImage.cpp:22-25). This is the classic Buades NL-means with the
same (h, patch, search) parameters, as the JAX package computes it:

    for each of the 21x21 search offsets t:
        d(x)   = box_7x7((I(x) - I(x+t))^2)      # patch distance
        w(x)   = exp(-d(x) / (|P| h^2))
        num   += w * I(x+t);  den += w

One loop over the 21 search row offsets; the 21 column offsets of each row
are a strided view of one reflect-padded plane, and the 7x7 patch sums are
shift-adds in JAX's order. For colour input the weights come from the BGR
luminance (0.114 B + 0.587 G + 0.299 R) and apply to all three channels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

TEMPLATE = 7          # patch edge (reference templateWindowSize)
SEARCH = 21           # search window edge (reference searchWindowSize)
H_STRENGTH = 10.0     # reference h


def _reflect(plane: torch.Tensor, m: int) -> torch.Tensor:
    """[..., H, W] reflect-padded by m on both spatial axes (no edge repeat,
    numpy's and jnp.pad's 'reflect')."""
    lead = plane.shape[:-2]
    x = plane.reshape((-1, 1) + plane.shape[-2:])
    return F.pad(x, (m, m, m, m), mode="reflect").reshape(lead + (x.shape[-2] + 2 * m,
                                                                  x.shape[-1] + 2 * m))


def nlm_denoise(image: torch.Tensor, h: float = H_STRENGTH, template: int = TEMPLATE,
                search: int = SEARCH) -> torch.Tensor:
    """NL-means denoise. image: [H,W] or [H,W,3] (0..255 scale) on any device.

    Returns float32 of the same shape on the same device. Weights come from
    the plane itself or the BGR luminance; all channels are averaged with
    those weights."""
    f32 = torch.float32
    img = torch.as_tensor(image).to(f32)
    chans = img[..., None] if img.ndim == 2 else img
    Hh, Ww, C = chans.shape
    if C == 3:
        lum = 0.114 * chans[..., 0] + 0.587 * chans[..., 1] + 0.299 * chans[..., 2]
    else:
        lum = chans[..., 0]

    m = search // 2
    r = template // 2
    M = m + r
    pl = _reflect(lum, M)                                      # [H+2M, W+2M]
    lum_r = pl[m:m + Hh + 2 * r, m:m + Ww + 2 * r]             # centre, r margin
    pad_ch = _reflect(chans.permute(2, 0, 1), m)               # [C, H+2m, W+2m]
    inv = float(np.float32(1.0) / (np.float32(template * template)
                                   * np.float32(h) * np.float32(h)))

    num = torch.zeros((C, Hh, Ww), dtype=f32, device=img.device)
    den = torch.zeros((Hh, Ww), dtype=f32, device=img.device)
    for dy in range(search):
        band = pl[dy:dy + Hh + 2 * r]                          # [H+2r, W+2M]
        sh = band.unfold(1, Ww + 2 * r, 1).permute(1, 0, 2)    # [S, H+2r, W+2r]
        d2raw = (lum_r - sh) ** 2
        rows = d2raw[:, 0:Hh]
        for i in range(1, template):
            rows = rows + d2raw[:, i:i + Hh]
        d2 = rows[:, :, 0:Ww]
        for j in range(1, template):
            d2 = d2 + rows[:, :, j:j + Ww]                     # [S, H, W]
        w = torch.exp(-d2 * inv)
        band_ch = pad_ch[:, dy:dy + Hh]                        # [C, H, W+2m]
        sh_ch = band_ch.unfold(2, Ww, 1).permute(2, 0, 1, 3)   # [S, C, H, W]
        num = num + torch.sum(w[:, None] * sh_ch, dim=0)
        den = den + torch.sum(w, dim=0)
    out = (num / den).permute(1, 2, 0)
    return out[..., 0] if img.ndim == 2 else out


def nlm_denoise_uint8(image: np.ndarray, h: float = H_STRENGTH, device=None) -> np.ndarray:
    """uint8 in / uint8 out convenience wrapper (host arrays; `device=None`
    means the card)."""
    from unified_cvo_tpu_torch.device import resolve_device

    x = torch.as_tensor(np.asarray(image), dtype=torch.float32, device=resolve_device(device))
    out = nlm_denoise(x, h=h)
    return np.clip(out.cpu().numpy(), 0, 255).astype(np.uint8)
