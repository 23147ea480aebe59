"""RawImage: denoised intensity + central-difference gradients (+ semantics),
on device tensors (port of unified_cvo_tpu/frontend/image.py).

Reference: src/utils/RawImage.cpp. The reference denoises with
fastNlMeansDenoising (RawImage.cpp:22-25) before computing intensity and the
2-channel gradient dx = 0.5*(I[x+1]-I[x-1]), dy = 0.5*(I[y+1]-I[y-1]) with
zeroed borders (compute_image_gradient, RawImage.cpp:55-81).

The grey level of a colour image is cv2.cvtColor's BGR2GRAY exactly, as
JAX's host frontend calls it (`opencv_gray`), and OpenCV's denoiser is
ported exactly (`ops/nlm_opencv.py`), so nothing here needs OpenCV. The
device frontends take another rule, JAX's device frontend's
(`frontend/device.py::device_gray_and_gradients`).

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
from unified_cvo_tpu_torch.frontend.device import gradients
from unified_cvo_tpu_torch.ops.nlm import nlm_denoise
from unified_cvo_tpu_torch.ops.nlm_opencv import fast_nl_means_denoising_colored, nlm_opencv


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


def _opencv_denoise(image: torch.Tensor) -> torch.Tensor:
    """cv2.fastNlMeansDenoisingColored(image, None, 10, 10, 7, 21), or
    cv2.fastNlMeansDenoising(image, None, 10, 7, 21) for grey, bit for bit
    on the tensor's device."""
    if image.ndim == 3:
        return fast_nl_means_denoising_colored(image, 10.0, 10.0, 7, 21)
    return nlm_opencv(image, 10.0, 7, 21)


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
    """denoise_engine: 'opencv' = the output of cv2.fastNlMeansDenoising
    (Colored), the reference's exact call (RawImage.cpp:22-25), computed by
    its exact port on the device (ops/nlm_opencv.py; no OpenCV needed).
    'tpu' = the accelerator NL-means, ops/nlm.py on the device, its output
    truncated to uint8 as JAX's nlm_denoise_uint8 does. `device=None` means
    the card."""
    dev = resolve_device(device)
    if denoise and denoise_engine not in ("opencv", "tpu"):
        raise ValueError(f"unknown denoise_engine {denoise_engine!r}")
    img = _as_uint8(image, dev)
    if denoise and denoise_engine == "opencv":
        img = _opencv_denoise(img)
    elif denoise:
        img = torch.clamp(nlm_denoise(img.to(torch.float32)), 0, 255).to(torch.uint8)
    gray = opencv_gray(img) if img.ndim == 3 else img.to(torch.float32)
    grad, gs = gradients(gray)
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
