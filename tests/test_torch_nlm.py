"""NL-means in torch (unified_cvo_tpu_torch/ops/nlm.py) against the JAX
package's ops/nlm.py on the CPU, on the same seeded noisy images: float
output abs 1e-3 on the 0-255 scale, the uint8 wrapper within one level."""

import numpy as np
import pytest
import torch

from unified_cvo_tpu.ops import nlm as j_nlm
from unified_cvo_tpu_torch.ops import nlm as t_nlm

torch.set_num_threads(1)

TOL = 1e-3


def _noisy(color: bool, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    clean = (120 + 60 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
             + 40 * ((xx // 16 + yy // 12) % 2)).astype(np.float32)
    if color:
        clean = np.stack([clean, np.roll(clean, 5, 1), np.roll(clean, 3, 0)], -1)
    return np.clip(clean + rng.normal(scale=12, size=clean.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("color", [False, True], ids=["grey", "colour"])
def test_nlm_denoise_matches_jax(color):
    img = _noisy(color).astype(np.float32)
    want = np.asarray(j_nlm.nlm_denoise(img))
    got = t_nlm.nlm_denoise(torch.from_numpy(img))
    assert got.dtype == torch.float32 and got.shape == img.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # it denoises: the output is smoother than the input
    assert np.abs(np.diff(want, axis=1)).mean() < 0.7 * np.abs(np.diff(img, axis=1)).mean()


@pytest.mark.parametrize("color", [False, True], ids=["grey", "colour"])
def test_nlm_denoise_uint8_within_one_level(color):
    img = _noisy(color, seed=1)
    want = j_nlm.nlm_denoise_uint8(img)
    got = t_nlm.nlm_denoise_uint8(img, device="cpu")
    assert got.dtype == np.uint8 and got.shape == img.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_nlm_identity_on_constant():
    img = torch.full((40, 64), 77.0)
    np.testing.assert_allclose(t_nlm.nlm_denoise(img).numpy(), 77.0, atol=1e-3)
