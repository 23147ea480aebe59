"""RawImage: denoised intensity + central-difference gradients (+ semantics),
on device tensors (port of unified_cvo_tpu/frontend/image.py).

Reference: src/utils/RawImage.cpp. The reference denoises with
fastNlMeansDenoising (RawImage.cpp:22-25) before computing intensity and the
2-channel gradient dx = 0.5*(I[x+1]-I[x-1]), dy = 0.5*(I[y+1]-I[y-1]) with
zeroed borders (compute_image_gradient, RawImage.cpp:55-81).

Grey levels emulate OpenCV 4's fixed-point BGR2GRAY exactly, the
reference's OpenCV (`frontend/device.py::device_gray_and_gradients`), so
nothing here needs OpenCV unless the caller asks for OpenCV's denoiser.

As in JAX, the features take the (dx, dy) of the selected pixel, the evident
intent of the reference's stereo feature fill (CvoPointCloud.cpp:747-757,
whose 2-channel indexing samples pixel (v*w+u)/2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from unified_cvo_tpu_torch.device import resolve_device
from unified_cvo_tpu_torch.frontend.device import device_gray_and_gradients
from unified_cvo_tpu_torch.ops.nlm import nlm_denoise

OPENCV_MISSING = (
    "denoise_engine='opencv' needs OpenCV (cv2.fastNlMeansDenoising), which is not "
    "installed here; pass denoise_engine='tpu' (the port's NL-means on the device, "
    "ops/nlm.py) or denoise=False")


@dataclasses.dataclass
class RawImage:
    image: torch.Tensor               # HxWx3 uint8 (BGR) or HxW uint8
    intensity: torch.Tensor           # HxW float32 grey level
    gradient: torch.Tensor            # HxWx2 float32 (dx, dy)
    gradient_square: torch.Tensor     # HxW float32 dx^2+dy^2
    semantics: Optional[torch.Tensor] = None  # HxWxC float32 distribution

    @property
    def rows(self):
        return self.image.shape[0]

    @property
    def cols(self):
        return self.image.shape[1]

    @property
    def channels(self):
        return 1 if self.image.ndim == 2 else self.image.shape[2]

    @property
    def num_classes(self):
        return 0 if self.semantics is None else self.semantics.shape[2]


def _opencv_denoise(image: np.ndarray) -> np.ndarray:
    try:
        import cv2
    except ImportError as e:
        raise ImportError(OPENCV_MISSING) from e
    if image.ndim == 3:
        return cv2.fastNlMeansDenoisingColored(image, None, 10, 10, 7, 21)
    return cv2.fastNlMeansDenoising(image, None, 10, 7, 21)


def _as_uint8(image, dev) -> torch.Tensor:
    if isinstance(image, torch.Tensor):
        return image.to(dev)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(image))).to(dev)


def make_raw_image(
    image,
    semantics=None,
    denoise: bool = True,
    denoise_engine: str = "opencv",
    device=None,
) -> RawImage:
    """denoise_engine: 'opencv' = cv2.fastNlMeansDenoising(Colored), the
    reference's exact call (RawImage.cpp:22-25), run on the host; it raises
    ImportError where OpenCV is absent (the card's machine has none) and
    never swaps in another denoiser. 'tpu' = the accelerator NL-means,
    ops/nlm.py on the device, its output truncated to uint8 as JAX's
    nlm_denoise_uint8 does. `device=None` means the card."""
    dev = resolve_device(device)
    if denoise and denoise_engine not in ("opencv", "tpu"):
        raise ValueError(f"unknown denoise_engine {denoise_engine!r}")
    if denoise and denoise_engine == "opencv":
        host = image.cpu().numpy() if isinstance(image, torch.Tensor) else np.asarray(image)
        img = _as_uint8(_opencv_denoise(host), dev)
    else:
        img = _as_uint8(image, dev)
        if denoise:
            img = torch.clamp(nlm_denoise(img.to(torch.float32)), 0, 255).to(torch.uint8)
    gray, grad, gs = device_gray_and_gradients(img)
    if semantics is not None:
        semantics = torch.as_tensor(semantics, dtype=torch.float32, device=dev)
    return RawImage(image=img, intensity=gray, gradient=grad, gradient_square=gs,
                    semantics=semantics)


def pixel_features(raw: RawImage, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-pixel feature rows matching the reference layout
    (CvoPointCloud.cpp:744-768): 3-channel images give
    [b,g,r]/255, dx/500+0.5, dy/500+0.5 (5 dims); grayscale gives
    [i/255, dx/500+0.5, dy/500+0.5] (3 dims). The divisors are device
    tensors: torch turns a division by a Python scalar into a product with
    its reciprocal on CUDA, which rounds differently from numpy's division."""
    dev = raw.image.device
    c500 = torch.tensor(500.0, dtype=torch.float32, device=dev)
    c255 = torch.tensor(255.0, dtype=torch.float32, device=dev)
    g = raw.gradient[v, u] / c500 + 0.5
    if raw.channels == 3:
        bgr = raw.image[v, u].to(torch.float32) / c255
        return torch.cat([bgr, g], dim=-1)
    inten = raw.image[v, u].to(torch.float32)[..., None] / c255
    return torch.cat([inten, g], dim=-1)
