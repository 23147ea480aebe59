"""The device frontends in torch (unified_cvo_tpu_torch/frontend/device.py)
against the JAX package's frontend/device.py on the CPU, on the same arrays.

Grey levels, gradients, block thresholds and the DSO selection are exact
(the selection's slot order included: ties go to the lower cell, as
jnp.argsort's stable order gives them); the clouds have equal masks, xyz
within rtol 1e-5 atol 1e-5 and features within abs 1e-5 (1e-3 after
NL-means, whose weights are exponentials summed in another order)."""

import dataclasses

import numpy as np
import pytest
import torch

from unified_cvo_tpu.frontend import device as j_dev
from unified_cvo_tpu.frontend.calibration import Calibration as JaxCalibration
from unified_cvo_tpu.utils import synth as j_synth
from unified_cvo_tpu_torch import convert
from unified_cvo_tpu_torch.frontend import device as t_dev

torch.set_num_threads(1)


def _scene(h=128, w=192, seed=0):
    """test_device_frontend.py's textured BGR image and uint16 depth map."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = (110 + 70 * np.sin(xx / 13.0) + 45 * ((xx // 20 + yy // 15) % 2)
           + rng.normal(scale=6, size=(h, w))).clip(0, 255)
    bgr = np.stack([img, np.roll(img, 7, 1), np.roll(img, 3, 0)], -1).astype(np.uint8)
    depth = (2000 + 1500 * np.sin(yy / 30.0) + 500 * (xx / w)).astype(np.uint16)
    return bgr, depth


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_calib(jc):
    return convert.calibration_from_fields(**dataclasses.asdict(jc))


def _clouds_agree(pj, pt, feat_tol):
    assert pt.xyz.shape == np.asarray(pj.xyz).shape
    np.testing.assert_array_equal(pt.mask.numpy(), np.asarray(pj.mask))
    np.testing.assert_allclose(pt.xyz.numpy(), np.asarray(pj.xyz), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pt.features.numpy(), np.asarray(pj.features), rtol=0,
                               atol=feat_tol)
    np.testing.assert_array_equal(pt.geometric_types.numpy(), np.asarray(pj.geometric_types))
    assert pt.labels is None


@pytest.mark.parametrize("color", [True, False], ids=["bgr", "grey"])
def test_gray_and_gradients_equal(color):
    bgr, _ = _scene(seed=2)
    img = bgr if color else bgr[..., 1].astype(np.float32)
    want = j_dev.device_gray_and_gradients(img)
    got = t_dev.device_gray_and_gradients(_t(img))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("shape", [(128, 192), (100, 150)])
def test_block_thresholds_match_jax(shape):
    bgr, _ = _scene(*shape, seed=4)
    gs = np.asarray(j_dev.device_gray_and_gradients(bgr)[2])
    want = np.asarray(j_dev.dso_block_thresholds(gs))
    got = t_dev.dso_block_thresholds(_t(gs))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", ["over_budget_ties", "capacity_above_cells"])
def test_selection_equals_jax_in_order(case):
    """Over budget on an integer image, whose squared gradients tie often
    (the order decides which cells win and the cloud's slot order), and
    with more capacity than the pot grid has cells (96 x 96 at pot 3: 1024
    cells, capacity 2048, as test_device_frontend.py's regression)."""
    if case == "over_budget_ties":
        bgr, _ = _scene(seed=3)
        cap = 600
    else:
        bgr, _ = _scene(96, 96, seed=1)
        cap = 2048
    gs = np.asarray(j_dev.device_gray_and_gradients(bgr)[2])
    ths = np.asarray(j_dev.dso_block_thresholds(gs))
    uv_j, valid_j = (np.asarray(a) for a in j_dev.dso_select_device(gs, ths, 3, cap))
    uv_t, valid_t = t_dev.dso_select_device(_t(gs), _t(ths), 3, cap)
    assert uv_t.dtype == torch.int32 and uv_t.shape == (cap, 2)
    np.testing.assert_array_equal(valid_t.numpy(), valid_j)
    np.testing.assert_array_equal(uv_t.numpy(), uv_j)
    if case == "over_budget_ties":
        assert valid_j.all()
        scores = gs[uv_j[:, 1], uv_j[:, 0]]
        assert len(np.unique(scores)) < len(scores) // 2     # ties decided the order
    else:
        assert 0 < valid_j.sum() <= 1024


@pytest.mark.parametrize("denoise", [False, True], ids=["raw", "nlm"])
def test_rgbd_cloud_matches_jax(denoise):
    bgr, depth = _scene(seed=5)
    K = np.array([[120.0, 0, 96.0], [0, 120.0, 64.0], [0, 0, 1]], np.float32)
    jc = JaxCalibration(intrinsic=K, depth_scale=1000.0, cols=192, rows=128)
    pj = j_dev.device_pointcloud_from_rgbd(bgr, depth, jc, pot=3, capacity=2048,
                                           denoise=denoise)
    pt = t_dev.device_pointcloud_from_rgbd(bgr, depth, _port_calib(jc), pot=3,
                                           capacity=2048, denoise=denoise, device="cpu")
    assert pt.mask.sum() > 100
    _clouds_agree(pj, pt, 1e-3 if denoise else 1e-5)


def test_stereo_cloud_matches_jax():
    """A rendered corridor pair (256 x 160, D = 64), BGR left and BGR right
    as the KITTI reader gives them."""
    K = np.array([[200.0, 0, 128.0], [0, 200.0, 80.0], [0, 0, 1]], np.float32)
    jc = JaxCalibration(intrinsic=K, baseline=0.5, cols=256, rows=160)
    T = np.eye(4)
    T[:3, 3] = [0.02, 0.0, 0.12]
    left, right, _ = j_synth.render_stereo(j_synth.corridor_scene(seed=7), jc, T)
    kw = dict(capacity=4096, max_disp=64, v_min=20, v_bottom_margin=10)
    pj = j_dev.device_pointcloud_from_stereo(left, right, jc, **kw)
    pt = t_dev.device_pointcloud_from_stereo(left, right, _port_calib(jc), device="cpu", **kw)
    assert pt.mask.sum() > 500
    _clouds_agree(pj, pt, 1e-5)
