"""The port's Canny (ops/canny.py) against cv2.Canny on the CPU, and the
plain version of its hysteresis kernel (components8_plain) against scipy.

- canny(gray, 50, 150) equals cv2.Canny(gray, 50, 150, apertureSize=3) != 0
  on noise, blurred noise, blocks, a rendered TUM frame at 640 x 480 and a
  rendered KITTI frame at 1241 x 376, and at other thresholds;
- components8_plain gives scipy.ndimage.label's 8-connected partition, its
  labels the smallest pixel id of each component; the wrapper takes the
  plain version for a CPU tensor;
- L1's plain version keeps its labels with the diagonal links absent.
- on chip_smoke.py's three fixed union-find cases (every link, no link, a
  serpentine; `cc_cases`, at 70 x 100 here), both wrappers on the CPU give
  the known labels the card's kernels are held to.
"""

import cv2
import numpy as np
import pytest
import scipy.ndimage
import torch

from unified_cvo_tpu.utils import synth as j_synth
from unified_cvo_tpu_torch.ops import canny as C
from unified_cvo_tpu_torch.ops import lidar as L

torch.set_num_threads(1)


def _blocks(h, w, seed, k=8):
    rng = np.random.default_rng(seed)
    return np.kron(rng.integers(0, 255, (h // k + 1, w // k + 1), np.uint8),
                   np.ones((k, k), np.uint8))[:h, :w]


def _image(name):
    rng = np.random.default_rng(len(name))
    if name == "noise":
        return rng.integers(0, 255, (64, 80), np.uint8)
    if name == "blurred":
        return cv2.GaussianBlur(rng.integers(0, 255, (37, 53), np.uint8), (5, 5), 1.5)
    if name == "blocks":
        return cv2.GaussianBlur(_blocks(120, 160, 3), (3, 3), 0.8)
    if name == "tum":
        calib = j_synth.tum_calibration()
        scene = j_synth.corridor_scene(5, half_width=2.5, floor_y=1.2, ceil_y=-1.2,
                                       length=30.0)
        T = j_synth.corridor_trajectory(2, step=0.08, yaw_rate=0.015, bob=0.005)[1]
        return cv2.cvtColor(j_synth.render_frame(scene, calib, T)[0], cv2.COLOR_BGR2GRAY)
    calib = j_synth.kitti_calibration(W=1241, H=376, fx=718.856)
    scene = j_synth.corridor_scene(seed=3)
    left = j_synth.render_stereo(scene, calib, j_synth.corridor_trajectory(1, step=0.35)[0])[0]
    return cv2.cvtColor(left, cv2.COLOR_BGR2GRAY)


@pytest.mark.parametrize("name", ["noise", "blurred", "blocks", "tum", "kitti"])
def test_canny_equals_cv2(name):
    gray = _image(name)
    want = cv2.Canny(gray, 50, 150, apertureSize=3) > 0
    got = C.canny(torch.from_numpy(gray))
    assert got.dtype == torch.bool and tuple(got.shape) == gray.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 100


@pytest.mark.parametrize("low,high", [(10, 30), (100, 101), (0, 255), (150, 50)])
def test_canny_thresholds(low, high):
    gray = cv2.GaussianBlur(_blocks(96, 128, 5, k=6), (3, 3), 1.0)
    want = cv2.Canny(gray, low, high, apertureSize=3) > 0
    got = C.canny(torch.from_numpy(gray), min(low, high), max(low, high))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("density", [0.2, 0.45, 0.6])
def test_components8_plain_gives_scipys_partition(density):
    rng = np.random.default_rng(int(density * 100))
    mask = rng.random((40, 57)) < density
    got = C.components8(torch.from_numpy(mask)).numpy()
    want, n = scipy.ndimage.label(mask, structure=np.ones((3, 3)))
    ids = np.arange(mask.size).reshape(mask.shape)
    # off the mask: each pixel its own label
    np.testing.assert_array_equal(got[~mask], ids[~mask])
    # on the mask: one label per scipy component, its smallest pixel id
    for k in range(1, n + 1):
        comp = want == k
        assert set(np.unique(got[comp])) == {ids[comp].min()}
    assert len(np.unique(got[mask])) == n


def test_components_plain_without_diagonals_keeps_l1s_labels():
    rng = np.random.default_rng(2)
    lv = torch.from_numpy(rng.random((15, 40)) < 0.5)
    lh = torch.from_numpy(rng.random((16, 40)) < 0.5)
    none = torch.zeros_like(lv)
    assert torch.equal(L.components_plain(lv, lh), L.components_plain(lv, lh, none, none))


@pytest.mark.parametrize("case", ["every link", "no link", "serpentine"])
def test_fixed_union_find_cases_give_their_labels(case, monkeypatch):
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "CC_SHAPE", (70, 100))
    lv, lh, l1_want, mask, c8_want = chip_smoke.cc_cases(torch.device("cpu"))[case]
    assert torch.equal(L.components(lv, lh), l1_want)
    assert torch.equal(C.components8(mask), c8_want)
    if case == "serpentine":              # one path through every cell / every masked pixel
        assert int(lv.sum() + lh.sum()) == 70 * 100 - 1
        assert int((c8_want == 0).sum()) == int(mask.sum())
