"""The host frontend's port (frontend/{image,selector,stereo,pipeline}.py)
against the JAX package's host frontend on the CPU.

- CV_FAST: the port's one-pass scores and replayed threshold search against
  JAX's selector._fast_adaptive (cv2.FastFeatureDetector in a loop) on the
  same grey image, for rgbd, stereo and stereo with semantics, on rendered
  TUM and KITTI frames: uv equal, order included. The scores also give
  cv2's keypoints at each threshold 0..40.
- CANNY_EDGES and EDGES_ONLY against JAX's select_points: uv and types
  equal;
- make_raw_image, DSO_EDGES, FULL and pointcloud_from_rgbd (masks equal,
  xyz rtol 1e-6, features abs 1e-6), pointcloud_from_stereo on a given
  disparity.
- the capacity cap's indices against np.linspace at seeded n in
  4097-300000 (capacities 4096, 8192, 16384), where torch.linspace differs.
- the two grey levels on all 2^24 colours (one 4096 x 4096 image): the host
  frontend's (frontend/image.py::opencv_gray) equal to cv2.cvtColor's
  BGR2GRAY, which JAX's host frontend calls, and the device frontends'
  (frontend/device.py::device_gray_and_gradients) equal to JAX's device
  frontend's.

JAX runs as it is, on the installed cv2: nothing here patches its
cv2.cvtColor. The FAST tests feed both packages one grey image.
"""

import sys

import cv2
import numpy as np
import pytest
import torch

from unified_cvo_tpu.frontend import device as j_dev
from unified_cvo_tpu.frontend import image as j_image
from unified_cvo_tpu.frontend import pipeline as j_pipe
from unified_cvo_tpu.frontend import selector as j_sel
from unified_cvo_tpu.utils import synth as j_synth
from unified_cvo_tpu_torch import convert
from unified_cvo_tpu_torch.frontend import device as t_dev
from unified_cvo_tpu_torch.frontend import image as t_image
from unified_cvo_tpu_torch.frontend import pipeline as t_pipe
from unified_cvo_tpu_torch.frontend import selector as t_sel

torch.set_num_threads(1)

CPU = "cpu"


def every_colour():
    """All 2^24 BGR colours as one 4096 x 4096 uint8 image."""
    v = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(
        4096, 4096, 3)


def test_host_grey_is_cv2s_on_every_colour():
    """opencv_gray is cv2.cvtColor(COLOR_BGR2GRAY) on all 2^24 colours, and
    is not the device frontends' 14-bit rule, which parts from it on
    43864 colours by one."""
    img = every_colour()
    want = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    got = t_image.opencv_gray(torch.from_numpy(img))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    dev = t_dev.device_gray_and_gradients(torch.from_numpy(img))[0].numpy()
    diff = dev - want.astype(np.float32)
    assert int((diff != 0).sum()) == 43864 and float(np.abs(diff).max()) == 1.0


def test_device_grey_is_jaxs_on_every_colour():
    """device_gray_and_gradients' grey (and its gradients) equal JAX's
    device frontend's on all 2^24 colours."""
    img = every_colour()
    want = j_dev.device_gray_and_gradients(img)
    got = t_dev.device_gray_and_gradients(torch.from_numpy(img))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _port_calib(c):
    return convert.calibration_from_fields(c.intrinsic, c.baseline, c.depth_scale, c.cols,
                                           c.rows)


@pytest.fixture(scope="module")
def tum_frame():
    """A rendered 320 x 240 TUM frame of the TUM fixture's corridor
    (test_e2e_accuracy.py), its uint16 depth and the calibration."""
    calib = j_synth.tum_calibration()
    scene = j_synth.corridor_scene(5, half_width=2.5, floor_y=1.2, ceil_y=-1.2, length=30.0)
    T = j_synth.corridor_trajectory(2, step=0.08, yaw_rate=0.015, bob=0.005)[1]
    bgr, depth = j_synth.render_frame(scene, calib, T)
    d16 = np.clip(depth * calib.depth_scale, 0, 65535).astype(np.uint16)
    return bgr, d16, depth, calib


@pytest.fixture(scope="module")
def kitti_frame():
    """A rendered 512 x 320 KITTI-layout left image, its depth and the
    calibration."""
    calib = j_synth.kitti_calibration()
    scene = j_synth.corridor_scene(seed=3)
    T = j_synth.corridor_trajectory(2, step=0.35)[1]
    left, _, depth = j_synth.render_stereo(scene, calib, T)
    return left, depth, calib


def _frame(name, tum_frame, kitti_frame):
    return tum_frame[0] if name == "tum" else kitti_frame[0]


@pytest.mark.parametrize("frame,pt_type,num_classes", [
    ("tum", "rgbd", 0), ("kitti", "stereo", 0), ("kitti", "stereo", 19),
    ("tum", "stereo", 0), ("kitti", "rgbd", 0)])
def test_fast_adaptive_matches_jax(frame, pt_type, num_classes, tum_frame, kitti_frame):
    gray = cv2.cvtColor(_frame(frame, tum_frame, kitti_frame), cv2.COLOR_BGR2GRAY)
    uv_j, gt_j = j_sel._fast_adaptive(gray, pt_type, num_classes)
    uv_t, gt_t, thr = t_sel.fast_select(torch.from_numpy(gray), pt_type, num_classes)
    assert len(uv_j) > 1000
    np.testing.assert_array_equal(uv_t.numpy(), uv_j)
    np.testing.assert_array_equal(gt_t.numpy(), gt_j)


@pytest.mark.parametrize("frame", ["tum", "kitti"])
def test_fast_scores_give_cv2_keypoints_at_every_threshold(frame, tum_frame, kitti_frame):
    gray = cv2.cvtColor(_frame(frame, tum_frame, kitti_frame), cv2.COLOR_BGR2GRAY)
    score = t_sel.fast_scores(torch.from_numpy(gray))
    counts = t_sel.fast_histogram(score)
    for t in range(0, 41):
        kp = cv2.FastFeatureDetector_create(t, nonmaxSuppression=False).detect(gray)
        uv = np.array([[int(k.pt[0]), int(k.pt[1])] for k in kp], np.int64).reshape(-1, 2)
        vu = torch.nonzero(score >= t).numpy()
        np.testing.assert_array_equal(vu[:, ::-1], uv, err_msg=f"threshold {t}")
        assert int(counts[t]) == len(uv)


def test_fast_threshold_search_keeps_the_reference_quirks():
    """The first detection runs at 5 whatever `thresh` starts at; the climb
    stops at break_thresh; the descent stops at 0."""
    def flat(n_at):                 # counts[t] = n_at(t)
        return [n_at(t) for t in range(256)]

    # rgbd: 5 gives between num_min and num_want: threshold 5, not 9
    assert t_sel.fast_adaptive_threshold(flat(lambda t: 13000), "rgbd", 0) == 5
    # climbs to break_thresh 13 even if still over num_want
    assert t_sel.fast_adaptive_threshold(flat(lambda t: 99999), "rgbd", 0) == 13
    # descends to 0 if always under num_min
    assert t_sel.fast_adaptive_threshold(flat(lambda t: 10), "stereo", 0) == 0
    # stereo with semantics wants 28000: 26000 at 5 stays at 5
    assert t_sel.fast_adaptive_threshold(flat(lambda t: 26000), "stereo", 3) == 5
    assert t_sel.fast_adaptive_threshold(flat(lambda t: 26000), "stereo", 0) == 50


@pytest.mark.parametrize("grey", [False, True], ids=["bgr", "grey"])
@pytest.mark.parametrize("denoise", [False, True], ids=["raw", "opencv_nlm"])
def test_make_raw_image_matches_jax(grey, denoise, tum_frame):
    img = tum_frame[0][::2, ::2].copy()          # 160 x 120: cv2's NL-means is slow
    if grey:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    rj = j_image.make_raw_image(img, denoise=denoise)
    rt = t_image.make_raw_image(img, denoise=denoise, device=CPU)
    np.testing.assert_array_equal(rt.image.numpy(), rj.image)
    np.testing.assert_array_equal(rt.intensity.numpy(), rj.intensity)
    np.testing.assert_array_equal(rt.gradient.numpy(), rj.gradient)
    np.testing.assert_array_equal(rt.gradient_square.numpy(), rj.gradient_square)
    u = np.arange(0, img.shape[1], 7)
    v = np.arange(0, img.shape[0], 5)[: len(u)]
    u = u[: len(v)]
    np.testing.assert_array_equal(
        t_image.pixel_features(rt, torch.from_numpy(u), torch.from_numpy(v)).numpy(),
        j_image.pixel_features(rj, u, v))


def test_opencv_denoiser_without_opencv_gives_cv2s_output(tum_frame, monkeypatch):
    """The default engine needs no OpenCV: with cv2 hidden, it still gives
    the bytes cv2.fastNlMeansDenoisingColored gave on the same frame."""
    img = tum_frame[0]
    want = cv2.fastNlMeansDenoisingColored(img, None, 10, 10, 7, 21)
    monkeypatch.setitem(sys.modules, "cv2", None)
    raw = t_image.make_raw_image(img, denoise=True, device=CPU)
    np.testing.assert_array_equal(raw.image.numpy(), want)
    raw = t_image.make_raw_image(img, denoise=True, denoise_engine="tpu", device=CPU)
    assert raw.image.dtype == torch.uint8


@pytest.mark.parametrize("num_want", [1000, 3000, 10000])
def test_dso_and_full_selection_match_jax(num_want, tum_frame):
    rj = j_image.make_raw_image(tum_frame[0], denoise=False)
    rt = t_image.make_raw_image(tum_frame[0], denoise=False, device=CPU)
    uv_j, gt_j = j_sel.select_points(rj, "rgbd", j_sel.DSO_EDGES, expected_points=num_want)
    uv_t, gt_t = t_sel.select_points(rt, "rgbd", t_sel.DSO_EDGES, expected_points=num_want)
    assert len(uv_j) > 500
    np.testing.assert_array_equal(uv_t.numpy(), uv_j)
    np.testing.assert_array_equal(gt_t.numpy(), gt_j)
    uv_j, gt_j = j_sel.select_points(rj, "rgbd", j_sel.FULL)
    uv_t, gt_t = t_sel.select_points(rt, "rgbd", t_sel.FULL)
    np.testing.assert_array_equal(uv_t.numpy(), uv_j)
    np.testing.assert_array_equal(gt_t.numpy(), gt_j)


@pytest.mark.parametrize("method", [t_sel.CANNY_EDGES, t_sel.EDGES_ONLY])
def test_canny_and_orb_selection_raise(method, tum_frame):
    """CANNY_EDGES (cv2.ORB's keypoints through the port's exact ORB, then
    the edge and uniform draws) and EDGES_ONLY (Canny alone) no longer
    raise: each gives JAX's selection, uv and types equal, order included
    (tests/test_torch_stereo_native.py holds them on more cases). The name
    is the one of the days when CANNY_EDGES raised."""
    rj = j_image.make_raw_image(tum_frame[0], denoise=False)
    rt = t_image.make_raw_image(tum_frame[0], denoise=False, device=CPU)
    uv_j, gt_j = j_sel.select_points(rj, "stereo", method)
    uv_t, gt_t = t_sel.select_points(rt, "stereo", method)
    assert len(uv_j) > 100
    if method == t_sel.CANNY_EDGES:
        assert (gt_j[:, 1] == 1).sum() > 1000                 # the uniform draw
    np.testing.assert_array_equal(uv_t.numpy(), uv_j)
    np.testing.assert_array_equal(gt_t.numpy(), gt_j)


@pytest.mark.parametrize("capacity", [4096, 8192, 16384])
def test_capacity_cap_indices_are_numpys(capacity):
    rng = np.random.default_rng(capacity)
    ns = rng.integers(4097, 300001, 400)
    torch_differs = 0
    for n in map(int, ns):
        if n <= capacity:
            continue
        want = np.linspace(0, n - 1, capacity).astype(np.int64)
        np.testing.assert_array_equal(t_pipe.cap_indices(n, capacity, CPU).numpy(), want)
        lin = torch.linspace(0, n - 1, capacity, dtype=torch.float64).long().numpy()
        torch_differs += int(not np.array_equal(lin, want))
    # the sample holds cases where torch.linspace picks other indices (none
    # at 8192 in this sample: 0 of 1970)
    assert torch_differs > 0 or capacity == 8192


def _clouds_equal(pt, pj):
    np.testing.assert_array_equal(pt.mask.numpy(), np.asarray(pj.mask))
    np.testing.assert_allclose(pt.xyz.numpy(), np.asarray(pj.xyz), rtol=1e-6, atol=0)
    np.testing.assert_allclose(pt.features.numpy(), np.asarray(pj.features), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(pt.geometric_types.numpy(), np.asarray(pj.geometric_types))
    if pj.labels is None:
        assert pt.labels is None
    else:
        np.testing.assert_array_equal(pt.labels.numpy(), np.asarray(pj.labels))


@pytest.mark.parametrize("capacity,semantic", [(None, False), (4096, False), (4096, True)])
def test_pointcloud_from_rgbd_matches_jax(capacity, semantic, tum_frame):
    bgr, d16, _, calib = tum_frame
    sem = None
    if semantic:
        rng = np.random.default_rng(4)
        sem = rng.dirichlet(np.ones(19), bgr.shape[:2]).astype(np.float32)
    pj = j_pipe.pointcloud_from_rgbd(bgr, d16, calib, denoise=False, capacity=capacity,
                                     semantics=sem)
    pt = t_pipe.pointcloud_from_rgbd(bgr, d16, _port_calib(calib), denoise=False,
                                     capacity=capacity, semantics=sem, device=CPU)
    assert int(pt.mask.sum()) > 2000
    _clouds_equal(pt, pj)


def test_pointcloud_from_stereo_on_a_given_disparity_matches_jax(kitti_frame):
    left, depth, calib = kitti_frame
    disp = j_synth.gt_disparity(depth, calib)
    pj = j_pipe.pointcloud_from_stereo(left, left, calib, denoise=False, capacity=16384,
                                       disparity=disp)
    pt = t_pipe.pointcloud_from_stereo(left, left, _port_calib(calib), denoise=False,
                                       capacity=16384, disparity=disp, device=CPU)
    assert int(pt.mask.sum()) > 1000
    _clouds_equal(pt, pj)
