"""Canny edges as cv2.Canny(gray, low, high, apertureSize=3) gives them, on
the image's device, and the hand kernel of its hysteresis (components8).

The JAX package calls cv2.Canny(gray, 50, 150) on the host
(unified_cvo_tpu/frontend/selector.py:188); the card's machine has no
OpenCV, so this is OpenCV's algorithm in its own integer arithmetic:
  - Sobel 3 x 3 with replicated borders, in int32;
  - the L1 magnitude m = |dx| + |dy|, zero outside the image;
  - OpenCV's integer non-maximum suppression: with TG22 = 13573,
    y = |dy| << 15, tg22x = |dx| TG22 and tg67x = tg22x + (|dx| << 16), a
    pixel is kept horizontally (y < tg22x) if m > left and m >= right,
    vertically (y > tg67x) if m > up and m >= down, and diagonally, with
    s = sign(dx ^ dy), if m > the previous row's [x - s] and m > the next
    row's [x + s];
  - candidates: m > low and kept; edges: the 8-connected components of the
    candidates that hold a pixel with m > high (OpenCV's flood fill from
    its strong pixels reaches exactly those).
The components are the `components8` kernel on a CUDA tensor (csrc/
image.cu) and `components8_plain` on a CPU tensor; which components hold a
strong pixel is a scatter_reduce amax over the labels.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from unified_cvo_tpu_torch.ops import cuda_lib
from unified_cvo_tpu_torch.ops.lidar import components_plain

TG22 = 13573            # tan(22.5 deg) << 15, OpenCV's
CANNY_SHIFT = 15


def _links8(mask: torch.Tensor):
    """The 8-neighbour links of a [rows, cols] bool mask, in
    components_plain's layout: vertical, horizontal (none out of the last
    column), down-right and down-left."""
    v = mask[:-1] & mask[1:]
    h = torch.zeros_like(mask)
    h[:, :-1] = mask[:, :-1] & mask[:, 1:]
    dr = torch.zeros_like(v)
    dr[:, :-1] = mask[:-1, :-1] & mask[1:, 1:]
    dl = torch.zeros_like(v)
    dl[:, 1:] = mask[:-1, 1:] & mask[1:, :-1]
    return v, h, dr, dl


def components8_plain(mask: torch.Tensor) -> torch.Tensor:
    """int32 labels [rows, cols]: the smallest pixel id of each pixel's
    8-connected component of `mask` (a pixel off the mask is its own)."""
    return components_plain(*_links8(mask))


def components8(mask: torch.Tensor) -> torch.Tensor:
    """Labels as `components8_plain` gives them: the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if mask.device.type == "cpu":
        return components8_plain(mask)
    if mask.device.type != "cuda":
        raise ValueError(f"components8: unsupported device {mask.device}")
    dev = mask.device
    rows, cols = mask.shape
    m = mask.contiguous()                                # bool: one byte, 0 or 1
    cuda_lib.check_tensor(m, "mask", torch.bool, (rows, cols), dev, "components8")
    labels = torch.empty((rows, cols), dtype=torch.int32, device=dev)
    err = _lib().cvo_image_components8(m.data_ptr(), labels.data_ptr(), rows, cols,
                                       torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, "components8 kernel launch")
    components8.launches += 1
    return labels


components8.launches = 0


def reset_launches() -> None:
    components8.launches = 0


def _lib():
    lib = cuda_lib.load("image")
    if not getattr(lib, "_argtypes_set", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.cvo_image_components8.argtypes = [P, P, I, I, P]
        lib.cvo_image_components8.restype = I
        lib._argtypes_set = True
    return lib


def sobel_magnitude(gray: torch.Tensor):
    """(dx, dy, m) int32 [H, W]: OpenCV's 3 x 3 Sobel derivatives with
    replicated borders and the L1 magnitude |dx| + |dy|."""
    g = gray.to(torch.int32)
    h, w = g.shape
    rows = torch.clamp(torch.arange(-1, h + 1, device=g.device), 0, h - 1)
    cols = torch.clamp(torch.arange(-1, w + 1, device=g.device), 0, w - 1)
    p = g.index_select(0, rows).index_select(1, cols)           # [H + 2, W + 2]

    def at(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    dx = (at(-1, 1) - at(-1, -1)) + 2 * (at(0, 1) - at(0, -1)) + (at(1, 1) - at(1, -1))
    dy = (at(1, -1) + 2 * at(1, 0) + at(1, 1)) - (at(-1, -1) + 2 * at(-1, 0) + at(-1, 1))
    return dx, dy, dx.abs() + dy.abs()


def canny_candidates(gray: torch.Tensor, low: int = 50, high: int = 150):
    """(candidates, strong) bool [H, W]: the pixels above `low` that the
    non-maximum suppression keeps, and those of them above `high`."""
    dx, dy, m = sobel_magnitude(gray)
    h, w = m.shape
    mp = F.pad(m, (1, 1, 1, 1), value=0)                        # zero outside the image

    def nb(dy_, dx_):
        return mp[1 + dy_:1 + dy_ + h, 1 + dx_:1 + dx_ + w]

    ax = dx.abs()
    y = dy.abs() << CANNY_SHIFT
    tg22x = ax * TG22
    tg67x = tg22x + (ax << (CANNY_SHIFT + 1))
    horiz = (m > nb(0, -1)) & (m >= nb(0, 1))
    vert = (m > nb(-1, 0)) & (m >= nb(1, 0))
    s_pos = (dx ^ dy) >= 0                                       # s = 1: up-left, down-right
    diag = torch.where(s_pos, (m > nb(-1, -1)) & (m > nb(1, 1)),
                       (m > nb(-1, 1)) & (m > nb(1, -1)))
    keep = torch.where(y < tg22x, horiz, torch.where(y > tg67x, vert, diag))
    cand = keep & (m > low)
    return cand, cand & (m > high)


def canny(gray: torch.Tensor, low: int = 50, high: int = 150) -> torch.Tensor:
    """Edges bool [H, W] of an integer-valued grey image [H, W]:
    cv2.Canny(gray, low, high, apertureSize=3) != 0, on its device."""
    cand, strong = canny_candidates(gray, low, high)
    labels = components8(cand).reshape(-1).to(torch.int64)
    has_strong = torch.zeros(labels.numel(), dtype=torch.int32, device=labels.device)
    has_strong = has_strong.scatter_reduce(0, labels, strong.reshape(-1).to(torch.int32),
                                           "amax")
    return cand & (has_strong[labels] > 0).view_as(cand)
