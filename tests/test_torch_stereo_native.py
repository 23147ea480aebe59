"""The host stereo frontend's disparity (ops/sgm.py::sgm_disparity_native,
frontend/stereo.py::compute_disparity) and its clouds against the JAX
package on the CPU.

- compute_disparity(backend="native") against JAX's native.sgm_disparity
  (the C++ census-SGM of native/cvo_native.cpp): np.array_equal on three
  textured pairs with an occlusion block (64 x 96 at D 32, 120 x 200 at D
  64, 220 x 256 at D 32), on test_native.py's constant shift, on a rendered
  KITTI-layout pair at half width, on a colour pair (grey by cv2's
  BGR2GRAY in both packages: the port's frontend/image.py::opencv_gray) and
  at penalties where the C++'s uint16 path costs saturate; the bad
  arguments raise as the C++ refuses them;
- the region speckle against a transcription of the C++'s flood fill;
- the device frontend's SGM keeps its density speckle (JAX's ops/sgm.py);
- compute_disparity(backend="opencv") gives JAX's map (cv2.StereoSGBM;
  tests/test_torch_sgbm_opencv.py holds it to cv2 stage by stage);
- backend="auto" follows JAX's rule: JAX's "auto" map where cv2 is
  importable (cv2.StereoSGBM), the native map where it is not;
- a colour pair whose grey the device frontends' 14-bit rule would change
  gives JAX's map on "native", "opencv" and "auto" (JAX on the installed
  cv2's cvtColor, unpatched);
- pointcloud_from_stereo on its own disparity against JAX's on the native
  backend for CV_FAST, DSO_EDGES, FULL, EDGES_ONLY and CANNY_EDGES: masks
  equal, xyz rtol/atol 1e-5; the EDGES_ONLY and CANNY_EDGES selections
  equal to JAX's.
"""

import importlib.util

import cv2
import numpy as np
import pytest
import torch

from unified_cvo_tpu import native
from unified_cvo_tpu.frontend import calibration as j_calib
from unified_cvo_tpu.frontend import image as j_image
from unified_cvo_tpu.frontend import pipeline as j_pipeline
from unified_cvo_tpu.frontend import selector as j_sel
from unified_cvo_tpu.frontend import stereo as j_stereo
from unified_cvo_tpu.ops import sgm as j_sgm
from unified_cvo_tpu.utils import synth as j_synth
from unified_cvo_tpu_torch import convert
from unified_cvo_tpu_torch.frontend import image as t_image
from unified_cvo_tpu_torch.frontend import pipeline as t_pipeline
from unified_cvo_tpu_torch.frontend import selector as t_sel
from unified_cvo_tpu_torch.frontend import stereo as t_stereo
from unified_cvo_tpu_torch.ops import sgm as t_sgm
from unified_cvo_tpu_torch.frontend import device as t_dev

torch.set_num_threads(1)

pytestmark = pytest.mark.usefixtures("native_built")

CPU = "cpu"


def _textured(h, w, seed):
    """8 x 8 blocks of random grey with +-3 noise."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h // 8 + 1, w // 8 + 1), np.uint8)
    img = np.kron(base, np.ones((8, 8), np.uint8))[:h, :w].astype(int)
    return np.clip(img + rng.integers(-3, 4, img.shape), 0, 255).astype(np.uint8)


def occluded_pair(h, w, shift, seed):
    """A textured left image, the right one shifted by `shift` px with a
    block of fresh noise: an occlusion the LR check and the speckle meet."""
    left = _textured(h, w, seed)
    right = np.roll(left, -shift, axis=1)
    rng = np.random.default_rng(seed + 1)
    right[h // 4:h // 2, w // 3:w // 2] = rng.integers(0, 255, (h // 2 - h // 4,
                                                              w // 2 - w // 3))
    return left, right


@pytest.fixture(scope="module")
def kitti_half():
    """The rendered KITTI-layout stereo pair of chip_smoke.py's phase 9 at
    half width (620 x 188), grey levels."""
    calib = j_synth.kitti_calibration(W=620, H=188, fx=359.428)
    scene = j_synth.corridor_scene(seed=3)
    left, right, _ = j_synth.render_stereo(scene, calib, j_synth.corridor_trajectory(1)[0])
    return cv2.cvtColor(left, cv2.COLOR_BGR2GRAY), cv2.cvtColor(right, cv2.COLOR_BGR2GRAY)


def _both(left, right, max_disp, **kw):
    want = native.sgm_disparity(left, right, max_disp=max_disp, **kw)
    got = t_sgm.sgm_disparity_native(torch.from_numpy(left), torch.from_numpy(right),
                                     max_disp=max_disp, **kw)
    return want, got


@pytest.mark.parametrize("h,w,max_disp,shift", [(64, 96, 32, 5), (120, 200, 64, 11),
                                                (220, 256, 32, 8)])
def test_native_disparity_is_the_cpp_bit_for_bit(h, w, max_disp, shift):
    left, right = occluded_pair(h, w, shift, seed=h)
    want = j_stereo.compute_disparity(left, right, max_disparity=max_disp, backend="native")
    got = t_stereo.compute_disparity(left, right, max_disparity=max_disp, backend="native",
                                     device=CPU)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).mean() > 0.8
    # "auto" is native where cv2 is not importable
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(importlib.util, "find_spec", lambda name, *a: None)
        auto = t_stereo.compute_disparity(left, right, max_disparity=max_disp, device=CPU)
    np.testing.assert_array_equal(auto.numpy(), want)


def test_native_disparity_constant_shift():
    """test_native.py's constant shift: 240 x 320, 8 px, D 32."""
    left = _textured(240, 320, 3)
    right = np.roll(left, -8, axis=1)
    want, got = _both(left, right, 32)
    np.testing.assert_array_equal(got.numpy(), want)
    core = want[20:-20, 48:-16]
    assert abs(np.median(core[core > 0]) - 8.0) < 0.5


def test_native_disparity_on_a_rendered_pair(kitti_half):
    left, right = kitti_half
    want, got = _both(left, right, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    # the region speckle has work to do on this scene
    before = t_sgm._sgm_until_median(torch.from_numpy(left), torch.from_numpy(right), 64,
                                     10, 120, np.float32(1.0) + np.float32(0.1))
    assert int(((before > 0) & (got <= 0)).sum()) > 100


def test_native_disparity_colour_pair():
    left, right = occluded_pair(96, 128, 6, seed=9)
    rng = np.random.default_rng(4)
    tint = rng.integers(-40, 41, (1, 1, 3))
    lc = np.clip(np.stack([left] * 3, -1) + tint, 0, 255).astype(np.uint8)
    rc = np.clip(np.stack([right] * 3, -1) + tint, 0, 255).astype(np.uint8)
    want = j_stereo.compute_disparity(lc, rc, max_disparity=32, backend="native")
    got = t_stereo.compute_disparity(torch.from_numpy(lc), torch.from_numpy(rc),
                                     max_disparity=32, backend="native")
    assert got.device.type == "cpu"                   # a tensor's own device
    np.testing.assert_array_equal(got.numpy(), want)


def _colour_pair():
    """A 96 x 160 pair of 4 x 4 blocks of random colours, every other block
    one that the device frontends' 14-bit grey rule rounds otherwise than
    cv2 does; the right image shifted by 6 px with a block of fresh
    colours."""
    rng = np.random.default_rng(12)
    pool = rng.integers(0, 256, (400000, 3), np.uint8)
    b, g, r = (pool[:, i].astype(np.int64) for i in range(3))
    parts = ((1868 * b + 9617 * g + 4899 * r + 8192) >> 14
             != (3735 * b + 19235 * g + 9798 * r + 16384) >> 15)
    base = rng.integers(0, 256, (24 * 40, 3), np.uint8)
    base[::2] = pool[parts][:480]
    left = np.kron(base.reshape(24, 40, 3), np.ones((4, 4, 1), np.uint8))
    right = np.roll(left, -6, axis=1)
    right[30:60, 60:90] = rng.integers(0, 256, (30, 30, 3))
    return left, right


@pytest.mark.parametrize("backend", ["native", "opencv", "auto"])
def test_compute_disparity_colour_pair_matches_jax(backend):
    """Colour in, every backend: the port's map equals JAX's, whose grey is
    the installed cv2's cvtColor. The pair is one where that grey and the
    device frontends' 14-bit rule part (on half the pixels), and so do the
    maps made from the two greys."""
    left, right = _colour_pair()
    grey = cv2.cvtColor(left, cv2.COLOR_BGR2GRAY)
    rule14 = t_dev.device_gray_and_gradients(torch.from_numpy(left))[0].numpy()
    assert int((rule14 != grey).sum()) > 6000
    want = j_stereo.compute_disparity(left, right, max_disparity=32, backend=backend)
    got = t_stereo.compute_disparity(left, right, max_disparity=32, backend=backend,
                                     device=CPU)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).mean() > 0.5
    other = t_stereo.compute_disparity(
        *(t_dev.device_gray_and_gradients(torch.from_numpy(im))[0].to(torch.uint8)
          for im in (left, right)), max_disparity=32, backend=backend, device=CPU)
    assert not torch.equal(other, got)


@pytest.mark.parametrize("kw", [dict(p1=10, p2=60000), dict(p1=30000, p2=65000),
                                dict(p1=0, p2=0), dict(uniqueness=0.0),
                                dict(uniqueness=0.25)],
                         ids=["p2-saturates", "both-saturate", "no-penalty", "unique-0",
                              "unique-0.25"])
def test_native_disparity_penalties_and_uniqueness(kw):
    left, right = occluded_pair(64, 96, 5, seed=1)
    want, got = _both(left, right, 32, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("max_disp", [0, -3, 257, 512])
def test_native_disparity_rejects_bad_args(max_disp):
    z = np.zeros((4, 4), np.uint8)
    with pytest.raises(RuntimeError):
        native.sgm_disparity(z, z, max_disp=max_disp)
    with pytest.raises(RuntimeError):
        t_stereo.compute_disparity(z, z, max_disparity=max_disp, backend="native", device=CPU)
    with pytest.raises(RuntimeError):
        t_sgm.sgm_disparity_native(torch.zeros((0, 4), dtype=torch.uint8),
                                   torch.zeros((0, 4), dtype=torch.uint8), 16)


def test_opencv_backend_is_not_ported():
    """The name is the test's from before the StereoSGBM backend was ported
    (ops/sgbm_opencv.py): it now gives JAX's float32 map exactly, which the
    native backend's differs from."""
    left, right = occluded_pair(64, 160, 5, seed=2)
    want = j_stereo.compute_disparity(left, right, max_disparity=32, backend="opencv")
    got = t_stereo.compute_disparity(left, right, max_disparity=32, backend="opencv",
                                     device=CPU)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).mean() > 0.5
    native_map = t_stereo.compute_disparity(left, right, max_disparity=32, backend="native",
                                            device=CPU)
    assert not torch.equal(native_map, got)


def test_auto_backend_follows_jax_rule(monkeypatch):
    """backend="auto" is JAX's rule: cv2.StereoSGBM where cv2 is importable
    (here: the port's map equals JAX's "auto" map, which is cv2's), the
    native census-SGM where importlib finds no cv2."""
    left, right = occluded_pair(64, 160, 5, seed=2)
    assert importlib.util.find_spec("cv2") is not None and t_stereo.auto_backend() == "opencv"
    want = j_stereo.compute_disparity(left, right, max_disparity=32)
    np.testing.assert_array_equal(
        want, j_stereo.compute_disparity(left, right, max_disparity=32, backend="opencv"))
    got = t_stereo.compute_disparity(left, right, max_disparity=32, device=CPU)
    np.testing.assert_array_equal(got.numpy(), want)
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None)
    assert t_stereo.auto_backend() == "native"
    native_map = j_stereo.compute_disparity(left, right, max_disparity=32, backend="native")
    got = t_stereo.compute_disparity(left, right, max_disparity=32, device=CPU)
    np.testing.assert_array_equal(got.numpy(), native_map)
    assert not np.array_equal(native_map, want)


def _flood_speckle(disp, min_size=120, max_diff=1.0):
    """cvo_native.cpp's speckle loop, transcribed."""
    d = disp.copy().reshape(-1)
    h, w = disp.shape
    label = np.full(h * w, -1)
    for start in range(h * w):
        if label[start] >= 0 or d[start] <= 0:
            continue
        stack, region = [start], []
        label[start] = start
        while stack:
            i = stack.pop()
            region.append(i)
            y, x = divmod(i, w)
            for yy, xx in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1)):
                if not (0 <= yy < h and 0 <= xx < w):
                    continue
                j = yy * w + xx
                if label[j] >= 0 or d[j] <= 0:
                    continue
                if np.abs(np.float32(d[j] - d[i])) <= np.float32(max_diff):
                    label[j] = start
                    stack.append(j)
        if len(region) < min_size:
            d[region] = -1.0
    return d.reshape(h, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_speckle_regions_is_the_flood_fill(seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(1, 12, (6, 8)).astype(np.float32)
    disp = np.kron(base, np.ones((8, 8), np.float32))
    disp += rng.uniform(-0.6, 0.6, disp.shape).astype(np.float32)
    disp[rng.random(disp.shape) < 0.15] = -1.0
    want = _flood_speckle(disp, min_size=40)
    got = t_sgm.speckle_regions(torch.from_numpy(disp), min_size=40).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want <= 0).sum() > (disp <= 0).sum()


def test_device_sgm_keeps_the_density_speckle():
    """The device frontend's SGM (JAX ops/sgm.py): after the refactor into
    shared stages, still JAX's output."""
    left, right = occluded_pair(64, 96, 5, seed=5)
    want = np.asarray(j_sgm.sgm_disparity_device(left.astype(np.float32),
                                                 right.astype(np.float32), max_disp=32))
    got = t_sgm.sgm_disparity_device(torch.from_numpy(left).float(),
                                     torch.from_numpy(right).float(), max_disp=32)
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def stereo_frame():
    """A rendered 512 x 320 KITTI-layout stereo pair and its calibration."""
    calib = j_synth.kitti_calibration()
    scene = j_synth.corridor_scene(seed=3)
    T = j_synth.corridor_trajectory(2, step=0.35)[1]
    left, right, _ = j_synth.render_stereo(scene, calib, T)
    return left, right, calib


def _port_calib(c):
    return convert.calibration_from_fields(c.intrinsic, c.baseline, c.depth_scale, c.cols,
                                           c.rows)


@pytest.mark.parametrize("method", ["CV_FAST", "DSO_EDGES", "FULL", "EDGES_ONLY",
                                    "CANNY_EDGES"])
def test_pointcloud_from_stereo_matches_jax(method, stereo_frame):
    left, right, calib = stereo_frame
    cap = None if method == "FULL" else 16384
    cj = j_pipeline.pointcloud_from_stereo(left, right, calib, method=method, denoise=False,
                                           capacity=cap, stereo_backend="native")
    ct = t_pipeline.pointcloud_from_stereo(left, right, _port_calib(calib), method=method,
                                           denoise=False, capacity=cap, stereo_backend="native",
                                           device=CPU)
    np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))
    assert float(ct.mask.sum()) > 500
    np.testing.assert_allclose(ct.xyz.numpy(), np.asarray(cj.xyz), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ct.features.numpy(), np.asarray(cj.features), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(ct.geometric_types.numpy(),
                                  np.asarray(cj.geometric_types))


def test_pointcloud_from_stereo_takes_a_tensor_disparity(stereo_frame):
    left, right, calib = stereo_frame
    pc = _port_calib(calib)
    disp = t_stereo.compute_disparity(left, right, backend="native", device=CPU)
    a = t_pipeline.pointcloud_from_stereo(left, right, pc, denoise=False, disparity=disp,
                                          device=CPU)
    b = t_pipeline.pointcloud_from_stereo(left, right, pc, denoise=False,
                                          disparity=disp.numpy(), device=CPU)
    c = t_pipeline.pointcloud_from_stereo(left, right, pc, denoise=False,
                                          stereo_backend="native", device=CPU)
    for x in (b, c):
        assert torch.equal(a.xyz, x.xyz) and torch.equal(a.mask, x.mask)


@pytest.mark.parametrize("expected,seed", [(10000, 0), (2000, 3), (400, 7)])
def test_edges_only_selection_matches_jax(expected, seed, stereo_frame):
    left = stereo_frame[0]
    rj = j_image.make_raw_image(left, denoise=False)
    rt = t_image.make_raw_image(left, denoise=False, device=CPU)
    uv_j, gt_j = j_sel.select_points(rj, "stereo", j_sel.EDGES_ONLY, expected, seed)
    uv_t, gt_t = t_sel.select_points(rt, "stereo", t_sel.EDGES_ONLY, expected, seed)
    assert len(uv_j) > 50
    np.testing.assert_array_equal(uv_t.numpy(), uv_j)
    np.testing.assert_array_equal(gt_t.numpy(), gt_j)


@pytest.mark.parametrize("expected,seed,denoise", [(10000, 0, False), (2000, 3, True),
                                                   (400, 7, False)])
def test_canny_edges_selection_matches_jax(expected, seed, denoise, stereo_frame):
    """CANNY_EDGES: ORB's expected // 3 keypoints first (cv2's order), the
    edge draw, the uniform draw: uv and types equal to JAX's, also on the
    exact NL-means' image."""
    left = stereo_frame[0]
    rj = j_image.make_raw_image(left, denoise=denoise)
    rt = t_image.make_raw_image(left, denoise=denoise, device=CPU)
    uv_j, gt_j = j_sel.select_points(rj, "stereo", j_sel.CANNY_EDGES, expected, seed)
    uv_t, gt_t = t_sel.select_points(rt, "stereo", t_sel.CANNY_EDGES, expected, seed)
    assert len(uv_j) > expected // 2
    np.testing.assert_array_equal(uv_t.numpy(), uv_j)
    np.testing.assert_array_equal(gt_t.numpy(), gt_j)
