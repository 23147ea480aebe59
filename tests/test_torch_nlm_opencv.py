"""OpenCV's NL-means and 8-bit Lab conversions, ported exactly
(ops/nlm_opencv.py), against the installed cv2.

These tests hold the port to the installed OpenCV (5.0.0 when they were
written). The reference built against OpenCV 4, whose BGR2GRAY differs
(ROADMAP section 3); the denoiser is not held to OpenCV 4.

- grey, 2-channel and colour denoising against cv2.fastNlMeansDenoising
  (Colored) with torch.equal, at three seeds and sizes (smallest side 14),
  and on frames with a 44 x 46 block of 255;
- COLOR_LBGR2Lab and COLOR_Lab2LBGR against cv2 on every 8th value of each
  channel; `python tests/test_torch_nlm_opencv.py` runs all 2^24 inputs of
  each (about ten seconds);
- make_raw_image's default engine with cv2 hidden against JAX's (which
  calls cv2) on the same frame, grey and colour.
"""

import sys
from pathlib import Path

if __name__ == "__main__":      # as a script: the repo root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import cv2
import numpy as np
import pytest
import torch

from unified_cvo_tpu_torch.ops import nlm_opencv as nlm

torch.set_num_threads(1)

CASES = [(0, 32, 40), (1, 29, 37), (2, 14, 23)]


def _frame(seed, H, W, C):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (H, W, C) if C > 1 else (H, W), np.uint8)
    # half noise, half smooth: both the weight table's tail and its zero
    img[: H // 2] = cv2.GaussianBlur(img, (5, 5), 0)[: H // 2]
    return img


@pytest.mark.parametrize("seed,H,W", CASES)
def test_grey_equals_cv2(seed, H, W):
    img = _frame(seed, H, W, 1)
    want = torch.from_numpy(cv2.fastNlMeansDenoising(img, None, 10, 7, 21))
    assert torch.equal(nlm.nlm_opencv(torch.from_numpy(img)), want)


@pytest.mark.parametrize("seed,H,W", CASES)
def test_two_channels_equal_cv2(seed, H, W):
    img = _frame(seed + 10, H, W, 3)[..., :2].copy()
    want = torch.from_numpy(cv2.fastNlMeansDenoising(img, None, 10, 7, 21))
    assert torch.equal(nlm.nlm_opencv(torch.from_numpy(img)), want)


@pytest.mark.parametrize("seed,H,W", CASES)
def test_colour_equals_cv2(seed, H, W):
    img = _frame(seed + 20, H, W, 3)
    want = torch.from_numpy(cv2.fastNlMeansDenoisingColored(img, None, 10, 10, 7, 21))
    assert torch.equal(nlm.fast_nl_means_denoising_colored(torch.from_numpy(img)), want)


@pytest.mark.parametrize("channels", [1, 2, 3], ids=["grey", "two", "colour"])
def test_saturated_patch_equals_cv2(channels):
    # a 44 x 46 block of 255: every weight is the table's largest, and the
    # estimate sum comes within 2^31 of overflowing
    img = _frame(11, 64, 72, 1 if channels == 1 else 3)
    if channels == 2:
        img = img[..., :2].copy()
    img[10:54, 14:60] = 255
    if channels == 3:
        want = cv2.fastNlMeansDenoisingColored(img, None, 10, 10, 7, 21)
        got = nlm.fast_nl_means_denoising_colored(torch.from_numpy(img))
    else:
        want = cv2.fastNlMeansDenoising(img, None, 10, 7, 21)
        got = nlm.nlm_opencv(torch.from_numpy(img))
    assert (want[30, 30] >= 254).all()
    assert torch.equal(got, torch.from_numpy(want))


def test_other_parameters_equal_cv2():
    img = _frame(5, 24, 31, 1)
    want = cv2.fastNlMeansDenoising(img, None, 4.5, 5, 11)
    got = nlm.nlm_opencv(torch.from_numpy(img), 4.5, 5, 11)
    np.testing.assert_array_equal(got.numpy(), want)


def test_small_images_raise():
    with pytest.raises(ValueError, match="13"):
        nlm.nlm_opencv(torch.zeros((13, 40), dtype=torch.uint8))


def _every_8th():
    v = np.arange(0, 256, 8)
    g = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(-1, 3)
    return np.concatenate([g, g + 7]).astype(np.uint8).reshape(64, -1, 3)


@pytest.mark.parametrize("name,code", [("lbgr_to_lab_u8", cv2.COLOR_LBGR2Lab),
                                       ("lab_to_lbgr_u8", cv2.COLOR_Lab2LBGR)])
def test_lab_conversions_equal_cv2(name, code):
    img = _every_8th()
    got = getattr(nlm, name)(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, cv2.cvtColor(img, code))


@pytest.mark.parametrize("grey", [False, True], ids=["bgr", "grey"])
def test_make_raw_image_without_cv2_matches_jax(grey, monkeypatch):
    from unified_cvo_tpu.frontend import image as j_image
    from unified_cvo_tpu_torch.frontend import image as t_image

    img = _frame(7, 40, 52, 1 if grey else 3)
    want = j_image.make_raw_image(img).image          # cv2's denoiser
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = t_image.make_raw_image(img, device="cpu").image
    np.testing.assert_array_equal(got.numpy(), want)


def check_all_colours() -> int:
    """Both conversions against cv2 on all 2^24 inputs."""
    v = np.arange(1 << 24, dtype=np.uint32)
    img = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8)
    img = img.reshape(4096, 4096, 3)
    t = torch.from_numpy(img)
    bad = 0
    for name, code in (("lbgr_to_lab_u8", cv2.COLOR_LBGR2Lab),
                       ("lab_to_lbgr_u8", cv2.COLOR_Lab2LBGR)):
        ref = cv2.cvtColor(img, code)
        fn = getattr(nlm, name)
        got = torch.cat([fn(t[i:i + 256]) for i in range(0, 4096, 256)]).numpy()
        diff = np.abs(got.astype(np.int32) - ref.astype(np.int32)).max(-1)
        n = int((diff > 0).sum())
        bad += n
        print(f"{name}: {n} of {1 << 24} inputs differ from OpenCV {cv2.__version__} "
              f"(largest difference {int(diff.max())})")
    return 1 if bad else 0


if __name__ == "__main__":
    torch.set_num_threads(4)
    raise SystemExit(check_all_colours())
