"""cv2.StereoSGBM (MODE_SGBM_3WAY) without OpenCV
(ops/sgbm_opencv.py::sgbm_3way, compute_disparity(backend="opencv")) against
an installed cv2 (OpenCV 5.0.0), on the CPU.

- sgbm_3way against `cv2.StereoSGBM_create(..., mode=SGBM_3WAY).compute`,
  np.array_equal on the int16 map: rendered stereo pairs from utils/synth
  (widths above numDisparities), occluded random textures, flat images and
  strong edges at all four borders; numDisparities 16, 64 and 128;
  blockSize 3, 5 and 7; each stage after the path sums switched off in turn
  through cv2's own parameters (uniquenessRatio 0, a disp12MaxDiff no
  disparity reaches: OpenCV reads values <= 0 as 1, speckleWindowSize 0);
  minDisparity and preFilterCap away from JAX's; images short enough that
  a stripe's start is clamped to row 0; few grey levels (ties everywhere:
  the winner's and the uniqueness test's SIMD rules);
- medianBlur(3) and filterSpeckles on their own against cv2's, with
  regions of exactly the window size and one more (the size rule is <=);
- compute_disparity(backend="opencv") of both packages gives the same
  float32 map, on grey and colour pairs (JAX's grey from cv2.cvtColor, the
  port's from frontend/image.py::opencv_gray);
- chip_smoke.py phase 15e's frame (1241 x 376, D 128): its input digest and
  cv2's map digest are the constants the card's run is held to, and the
  port's CPU map equals cv2's (~15 s on one thread);
- the arguments cv2 fails on or that the emulation refuses raise ValueError.
"""

import hashlib
import time

import cv2
import numpy as np
import pytest
import torch

from unified_cvo_tpu.frontend import stereo as j_stereo
from unified_cvo_tpu.utils import synth as j_synth
from unified_cvo_tpu_torch.frontend import stereo as t_stereo
from unified_cvo_tpu_torch.ops import sgbm_opencv as sg
from test_torch_stereo_native import _textured, occluded_pair

torch.set_num_threads(1)

CPU = "cpu"
CV_NAMES = dict(min_disparity="minDisparity", num_disparities="numDisparities",
                block_size="blockSize", p1="P1", p2="P2", disp12_max_diff="disp12MaxDiff",
                uniqueness_ratio="uniquenessRatio", speckle_window_size="speckleWindowSize",
                speckle_range="speckleRange", pre_filter_cap="preFilterCap")


def _cv2(left, right, **kw):
    m = cv2.StereoSGBM_create(**{CV_NAMES[k]: v for k, v in kw.items()},
                              mode=cv2.STEREO_SGBM_MODE_SGBM_3WAY)
    return m.compute(left, right)


def _settings(D, block, **stages):
    """JAX's settings at another D and block size (penalties 8 and 32 x
    block^2), updated by `stages`."""
    kw = dict(num_disparities=D, block_size=block, p1=8 * block * block,
              p2=32 * block * block, disp12_max_diff=1, uniqueness_ratio=10,
              speckle_window_size=100, speckle_range=2, pre_filter_cap=31)
    kw.update(stages)
    return kw


def _assert_cv2(left, right, kw, valid_share=None):
    want = _cv2(left, right, **kw)
    got = sg.sgbm_3way(torch.from_numpy(left), torch.from_numpy(right), **kw)
    assert got.dtype == torch.int16 and got.device.type == "cpu"
    bad = got.numpy() != want
    assert not bad.any(), (f"{int(bad.sum())} pixels differ, first at "
                           f"{tuple(int(i[0]) for i in np.nonzero(bad))}")
    if valid_share is not None:
        assert (want >= 0).mean() > valid_share
    return want


@pytest.fixture(scope="module")
def rendered():
    """Rendered corridor stereo pairs in cv2's grey: {width: (left, right)}
    at 620 x 188 (phase 9's frame at half width) and 320 x 120."""
    out = {}
    for w, h, fx in ((620, 188, 359.428), (320, 120, 185.5)):
        calib = j_synth.kitti_calibration(W=w, H=h, fx=fx)
        scene = j_synth.corridor_scene(seed=3)
        left, right, _ = j_synth.render_stereo(scene, calib,
                                               j_synth.corridor_trajectory(1)[0])
        out[w] = cv2.cvtColor(left, cv2.COLOR_BGR2GRAY), cv2.cvtColor(right,
                                                                      cv2.COLOR_BGR2GRAY)
    return out


STAGES = {
    "all": {},
    "no-uniqueness": dict(uniqueness_ratio=0),
    "no-lr-check": dict(disp12_max_diff=10000),
    "no-speckle": dict(speckle_window_size=0),
    "paths-only": dict(uniqueness_ratio=0, disp12_max_diff=10000, speckle_window_size=0),
}


@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("D,block", [(16, 3), (64, 5), (64, 7), (128, 7)])
def test_rendered_pairs_match_cv2(rendered, D, block, stage):
    for w, (left, right) in rendered.items():
        if w > D + 64:
            _assert_cv2(left, right, _settings(D, block, **STAGES[stage]), valid_share=0.3)


@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("h,w,shift,D,block", [(64, 96, 5, 16, 3), (120, 200, 9, 64, 7),
                                               (100, 300, 40, 128, 5), (220, 256, 12, 64, 3)])
def test_occluded_textures_match_cv2(h, w, shift, D, block, stage):
    left, right = occluded_pair(h, w, shift, seed=h)
    _assert_cv2(left, right, _settings(D, block, **STAGES[stage]))


def _borders(h, w):
    """Strong edges along all four borders: white bands at the left and
    right, grey rows at the top and bottom, a texture inside."""
    img = _textured(h, w, 11) // 2
    img[:, :3] = 255
    img[:, -3:] = 255
    img[:2] = 200
    img[-2:] = 40
    return img


@pytest.mark.parametrize("D,block", [(16, 7), (64, 3), (128, 5)])
def test_flat_images_and_border_edges_match_cv2(D, block):
    flat = np.full((60, D + 80), 128, np.uint8)
    want = _assert_cv2(flat, flat, _settings(D, block))
    # columns left of D are never matched; the right border's ftzero columns
    # make d = 0 unique along each row's right-to-left path
    assert (want[:, :D] == -16).all() and (want[:, D:] == 0).any()
    img = _borders(60, D + 80)
    _assert_cv2(img, np.roll(img, -3, 1), _settings(D, block))
    _assert_cv2(img, np.roll(img, -3, 1), _settings(D, block, uniqueness_ratio=0,
                                                    speckle_window_size=0))


@pytest.mark.parametrize("kw", [dict(min_disparity=-8), dict(min_disparity=5),
                                dict(pre_filter_cap=63), dict(pre_filter_cap=0),
                                dict(p1=0, p2=0), dict(disp12_max_diff=0),
                                dict(disp12_max_diff=-1), dict(uniqueness_ratio=50),
                                dict(block_size=4), dict(block_size=1)],
                         ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_other_settings_match_cv2(kw):
    left, right = occluded_pair(90, 180, 6, seed=7)
    _assert_cv2(left, right, _settings(32, 5, **kw))


@pytest.mark.parametrize("h", [3, 5, 8, 13, 37])
def test_short_images_keep_the_stripe_offset(h):
    """Stripes of ceil(h / 4) rows whose start clamps to row 0 shift their
    output rows (OpenCV's row offset), and rows past a stripe are invalid."""
    left, right = occluded_pair(h, 150, 4, seed=h)
    _assert_cv2(left, right, _settings(16, 7))
    _assert_cv2(left, right, _settings(16, 3, speckle_window_size=0))


@pytest.mark.parametrize("seed", range(6))
def test_ties_follow_the_simd_rules(seed):
    """A few grey levels: many disparities tie for the least cost, and
    rivals sit exactly at the uniqueness threshold."""
    rng = np.random.default_rng(seed)
    levels = int(rng.integers(2, 6))
    left = (rng.integers(0, levels, (40, 120)) * int(rng.integers(1, 40))).astype(np.uint8)
    right = np.roll(left, -int(rng.integers(0, 10)), 1)
    noise = rng.random(left.shape) < 0.2
    right[noise] = rng.integers(0, levels, int(noise.sum())) * 7
    block = int(rng.choice([1, 3, 5]))
    kw = dict(num_disparities=int(rng.choice([16, 32, 64])), block_size=block,
              p1=int(rng.integers(1, 20)), p2=int(rng.integers(20, 80)),
              pre_filter_cap=int(rng.choice([0, 31, 63])),
              uniqueness_ratio=int(rng.choice([5, 10, 20, 25])),
              disp12_max_diff=int(rng.choice([1, 1000])))
    _assert_cv2(left, right, kw)


def test_median_and_speckles_match_cv2():
    rng = np.random.default_rng(3)
    disp = rng.integers(-16, 400, (50, 70)).astype(np.int16)
    disp[rng.random(disp.shape) < 0.3] = -16
    np.testing.assert_array_equal(sg.median3(torch.from_numpy(disp)).numpy(),
                                  cv2.medianBlur(disp, 3))
    for shape in ((1, 9), (9, 1)):
        line = rng.integers(0, 99, shape).astype(np.int16)
        np.testing.assert_array_equal(sg.median3(torch.from_numpy(line)).numpy(),
                                      cv2.medianBlur(line, 3))
    # regions of exactly 100 pixels (removed) and 101 (kept), 4-connected, a
    # diagonal touch that does not join, values stepping by the range
    img = np.full((40, 60), -16, np.int16)
    img[2:12, 2:12] = 100                                  # 100 pixels
    img[2:12, 20:30] = 200
    img[12, 20] = 232                                      # 101 pixels, one step of 32
    img[13, 31] = 500                                      # diagonal only
    img[20:35, 40:59] = (np.arange(19) * 32)[None, :]      # one region, steps of 32
    img[20:25, 5:15] = rng.integers(0, 1000, (5, 10))      # noise: small regions
    for size, diff in ((100, 32), (100, 31), (0, 32), (285, 32)):
        want = img.copy()
        cv2.filterSpeckles(want, -16, size, diff)
        got = sg.filter_speckles(torch.from_numpy(img).to(torch.int32), -16, size, diff)
        np.testing.assert_array_equal(got.numpy(), want)


def test_compute_disparity_matches_jax_grey(rendered):
    left, right = rendered[320]
    want = j_stereo.compute_disparity(left, right, max_disparity=64, backend="opencv")
    got = t_stereo.compute_disparity(left, right, max_disparity=64, backend="opencv",
                                     device=CPU)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).mean() > 0.3


def test_compute_disparity_matches_jax_colour():
    left, right = occluded_pair(96, 200, 6, seed=9)
    rng = np.random.default_rng(4)
    tint = rng.integers(-40, 41, (1, 1, 3))
    lc = np.clip(np.stack([left] * 3, -1) + tint, 0, 255).astype(np.uint8)
    rc = np.clip(np.stack([right] * 3, -1) + tint, 0, 255).astype(np.uint8)
    want = j_stereo.compute_disparity(lc, rc, max_disparity=64, backend="opencv")
    got = t_stereo.compute_disparity(torch.from_numpy(lc), torch.from_numpy(rc),
                                     max_disparity=64, backend="opencv")
    assert got.device.type == "cpu"                   # a tensor's own device
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).mean() > 0.5


def test_phase15e_frame_digests_and_full_size():
    """chip_smoke.py phase 15e's constants recomputed from cv2, and the
    port's CPU map at 1241 x 376, D 128 equal to cv2's."""
    import chip_smoke

    _, frames, _ = chip_smoke.stereo_frames()
    left, right = frames[0]
    assert hashlib.sha256(left.tobytes() + right.tobytes()).hexdigest() == \
        chip_smoke.SGBM_INPUT_SHA256
    gl, gr = (cv2.cvtColor(im, cv2.COLOR_BGR2GRAY) for im in (left, right))
    kw = t_stereo.opencv_settings(128)
    want = _cv2(gl, gr, **kw)
    assert hashlib.sha256(want.astype("<i2").tobytes()).hexdigest() == \
        chip_smoke.SGBM_MAP_SHA256
    t0 = time.perf_counter()
    got = sg.sgbm_3way(torch.from_numpy(gl), torch.from_numpy(gr), **kw)
    seconds = time.perf_counter() - t0
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, 128:] >= 0).mean() > 0.8
    assert (want[:, :128] == -16).all()
    assert seconds < 120, seconds


@pytest.mark.parametrize("kw,shape", [
    (dict(num_disparities=20), (40, 120)),        # not a multiple of 16
    (dict(num_disparities=0), (40, 120)),
    (dict(num_disparities=64), (40, 64)),         # no matched column (cv2 fails too)
    (dict(num_disparities=64, block_size=7), (40, 67)),   # fewer columns than the block
    (dict(block_size=9, p2=2592, pre_filter_cap=31), (40, 120)),   # int16 sums can saturate
    (dict(uniqueness_ratio=100), (40, 120)),
    (dict(block_size=0), (40, 120)),
], ids=["D20", "D0", "no-columns", "narrow", "saturates", "uniqueness-100", "block-0"])
def test_bad_arguments_raise(kw, shape):
    z = np.zeros(shape, np.uint8)
    with pytest.raises(ValueError):
        sg.sgbm_3way(z, z, **kw)


def test_bad_inputs_raise():
    z = np.zeros((40, 120), np.uint8)
    with pytest.raises(ValueError, match="shape"):
        sg.sgbm_3way(z, z[:, :100])
    with pytest.raises(ValueError, match="uint8"):
        sg.sgbm_3way(z.astype(np.int32), z)
    with pytest.raises(ValueError, match="backend"):
        t_stereo.compute_disparity(z, z, backend="sgbm", device=CPU)
