"""The port's exact ORB (frontend/orb.py) against cv2 (OpenCV 5.0, the one
the tests import), stage by stage, on the CPU:

- INTER_LINEAR_EXACT at every level size of a 1241 x 376, a 640 x 480 and
  two odd frames, each level resized from cv2's level before (as orb.cpp
  chains them), and at a few sizes up and down: equal;
- FAST-9/16 at 20 with non-maximum suppression against
  cv2.FastFeatureDetector_create(20, True): positions and scores equal, in
  cv2's order;
- retainBest's selection against libstdc++'s std::nth_element and
  std::partition compiled from a few lines of C++ (g++), on tie-heavy
  responses: the same indices in the same order;
- the level budgets against the octave counts of cv2's keypoints on a
  texture dense enough to fill every level;
- the whole cv2.ORB_create(n).detect for n in {3333, 333, 5000} on rendered
  KITTI (1241 x 376) and TUM (640 x 480) frames and on blurred noise, on a
  flat image (no keypoints) and on images too small for 8 levels: pt,
  octave and response bit-equal and in cv2's order.

The grey level fed to both is one uint8 image (cv2's BGR2GRAY of the
rendered colour frames, which the port's host frontend computes).
"""

import shutil
import subprocess

import cv2
import numpy as np
import pytest
import torch

from unified_cvo_tpu.utils import synth as j_synth
from unified_cvo_tpu_torch.frontend import orb

torch.set_num_threads(1)

KITTI_SIZE = (1241, 376)
TUM_SIZE = (640, 480)


def _noise(h, w, seed, sigma=1.5):
    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur((rng.random((h, w)) * 255).astype(np.uint8), (0, 0), sigma)


@pytest.fixture(scope="module")
def frames():
    """Grey uint8 frames: KITTI seq-00's camera width in the stereo corridor,
    the TUM camera in the TUM corridor, blurred noise at KITTI size."""
    kc = j_synth.kitti_calibration(*KITTI_SIZE, fx=718.856)
    T = j_synth.corridor_trajectory(2, step=0.35)[1]
    kitti = cv2.cvtColor(j_synth.render_stereo(j_synth.corridor_scene(seed=3), kc, T)[0],
                         cv2.COLOR_BGR2GRAY)
    tc = j_synth.tum_calibration(*TUM_SIZE, fx=525.0)
    scene = j_synth.corridor_scene(5, half_width=2.5, floor_y=1.2, ceil_y=-1.2, length=30.0)
    T = j_synth.corridor_trajectory(2, step=0.08, yaw_rate=0.015, bob=0.005)[1]
    tum = cv2.cvtColor(j_synth.render_frame(scene, tc, T)[0], cv2.COLOR_BGR2GRAY)
    return {"kitti": kitti, "tum": tum, "noise": _noise(KITTI_SIZE[1], KITTI_SIZE[0], 3)}


def _cv2_keypoints(img, n):
    return [(k.pt[0], k.pt[1], k.octave, k.response)
            for k in cv2.ORB_create(nfeatures=n).detect(img)]


def _port_keypoints(img, n):
    kp = orb.detect(torch.from_numpy(img), n)
    assert kp.pt.dtype == kp.response.dtype == torch.float32
    return [(float(x), float(y), int(o), float(r)) for (x, y), o, r in
            zip(kp.pt.numpy(), kp.octave.numpy(), kp.response.numpy())]


@pytest.mark.parametrize("size", [KITTI_SIZE, TUM_SIZE, (333, 97), (101, 67)])
def test_resize_linear_exact_matches_cv2(size):
    w, h = size
    prev = _noise(h, w, seed=w, sigma=0.7)
    sizes = orb.level_sizes(w, h)
    assert sizes[0] == (w, h)
    for lw, lh in sizes[1:]:
        want = cv2.resize(prev, (lw, lh), interpolation=cv2.INTER_LINEAR_EXACT)
        got = orb.resize_linear_exact(torch.from_numpy(prev), lw, lh).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{prev.shape} -> {(lh, lw)}")
        prev = want
    img = _noise(h, w, seed=1, sigma=0.7)
    for lw, lh in ((2 * w + 1, h + 3), (max(w // 3, 1), max(h // 2 + 1, 1)), (w - 1, 1)):
        want = cv2.resize(img, (lw, lh), interpolation=cv2.INTER_LINEAR_EXACT)
        got = orb.resize_linear_exact(torch.from_numpy(img), lw, lh).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{img.shape} -> {(lh, lw)}")


@pytest.mark.parametrize("name", ["kitti", "tum", "noise"])
def test_fast_nonmax_matches_cv2(name, frames):
    img = frames[name]
    kp = cv2.FastFeatureDetector_create(orb.FAST_THRESHOLD, True).detect(img)
    want = np.array([[k.pt[0], k.pt[1], k.response] for k in kp])
    xy, score = orb.fast_corners(torch.from_numpy(img))
    got = np.concatenate([xy.numpy(), score.numpy()[:, None]], axis=1).astype(np.float64)
    assert len(want) > 100
    np.testing.assert_array_equal(got, want)


_NTH_CPP = r"""
#include <algorithm>
#include <cstdio>
#include <vector>
int main() {
    int n, k;
    while (std::scanf("%d %d", &n, &k) == 2) {
        std::vector<std::pair<float, int>> v(n);
        for (int i = 0; i < n; i++) { std::scanf("%f", &v[i].first); v[i].second = i; }
        auto gt = [](const std::pair<float, int>& a, const std::pair<float, int>& b) {
            return a.first > b.first; };
        std::nth_element(v.begin(), v.begin() + k - 1, v.end(), gt);
        float amb = v[k - 1].first;
        auto end = std::partition(v.begin() + k, v.end(),
            [amb](const std::pair<float, int>& a) { return a.first >= amb; });
        std::printf("%d", (int)(end - v.begin()));
        for (auto it = v.begin(); it != end; ++it) std::printf(" %d", it->second);
        std::printf("\n");
    }
}
"""


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++ for libstdc++'s algorithms")
def test_retain_best_is_libstdcpps_order(tmp_path):
    src, exe = tmp_path / "nth.cpp", tmp_path / "nth"
    src.write_text(_NTH_CPP)
    subprocess.run(["g++", "-O1", "-o", str(exe), str(src)], check=True, timeout=120)
    rng = np.random.default_rng(0)
    cases = []
    for n, k, levels in ((5000, 1448, 40), (3000, 2999, 3), (4, 2, 2), (7, 3, 1),
                         (2000, 10, 1000), (1500, 724, 250), (60000, 20000, 7)):
        cases.append((rng.integers(20, 20 + levels, n).astype(np.float32), k))
    cases.append((rng.standard_normal(3000).astype(np.float32), 1000))
    cases.append((np.sort(rng.integers(0, 50, 4000)).astype(np.float32), 700))   # sorted
    cases.append((np.sort(rng.integers(0, 50, 4000))[::-1].astype(np.float32), 700))
    stdin = "".join(f"{len(r)} {k}\n" + " ".join(repr(float(x)) for x in r) + "\n"
                    for r, k in cases)
    out = subprocess.run([str(exe)], input=stdin, capture_output=True, text=True, check=True,
                         timeout=120).stdout.splitlines()
    for (r, k), line in zip(cases, out):
        want = [int(x) for x in line.split()[1:]]
        assert orb.retain_best(r.tolist(), k) == want, (len(r), k)
    assert len(out) == len(cases)


def test_level_budgets_fill_every_level():
    budgets = orb.level_budgets(3333)
    assert sum(budgets) == 3333
    img = _noise(1200, 2400, seed=11, sigma=1.0)      # level 7: 670 x 335
    octaves = np.array([o for *_, o, _ in _cv2_keypoints(img, 3333)])
    assert np.bincount(octaves, minlength=orb.N_LEVELS).tolist() == budgets
    for n in (333, 5000, 1, 0, 77):
        assert sum(orb.level_budgets(n)) == n and min(orb.level_budgets(n)) >= 0


@pytest.mark.parametrize("nfeatures", [3333, 333, 5000])
@pytest.mark.parametrize("name", ["kitti", "tum", "noise"])
def test_orb_detect_matches_cv2(name, nfeatures, frames):
    img = frames[name]
    want = _cv2_keypoints(img, nfeatures)
    assert len(want) > min(nfeatures // 2, 300)
    assert _port_keypoints(img, nfeatures) == want


@pytest.mark.parametrize("shape", [(376, 1241), (100, 130), (70, 90), (40, 50)])
def test_orb_detect_flat_and_small_images(shape):
    flat = np.full(shape, 77, np.uint8)
    assert _cv2_keypoints(flat, 3333) == _port_keypoints(flat, 3333) == []
    img = _noise(*shape, seed=shape[0], sigma=1.0)
    want = _cv2_keypoints(img, 500)
    assert _port_keypoints(img, 500) == want
    if shape[0] >= 100:
        assert want                                 # some levels too small, some not
