"""Census-SGM stereo in torch (unified_cvo_tpu_torch/ops/sgm.py) against the
JAX package's ops/sgm.py on the CPU, on the same seeded inputs.

Costs and aggregates are int32 in both packages and must be equal; the
disparity must have equal valid masks and agree to abs 1e-5 (the only
float steps are the subpixel division and the median's selection)."""

import numpy as np
import pytest
import torch

from unified_cvo_tpu.ops import sgm as j_sgm
from unified_cvo_tpu_torch.ops import sgm as t_sgm
from unified_cvo_tpu_torch.utils import synth as t_synth
from unified_cvo_tpu_torch.frontend.calibration import Calibration

torch.set_num_threads(1)

DISP_TOL = 1e-5


def _textured(h, w, seed=3):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h // 8, w // 8), np.uint8)
    return np.kron(base, np.ones((8, 8), np.uint8))


def _gray(im):
    return (0.299 * im[..., 2] + 0.587 * im[..., 1] + 0.114 * im[..., 0]).astype(np.uint8)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def small_pair():
    rng = np.random.default_rng(0)
    left = rng.integers(0, 255, (24, 40), np.uint8)
    right = np.roll(left, -3, axis=1)
    right[5:9, 10:20] = rng.integers(0, 255, (4, 10), np.uint8)   # an occluder
    return left, right


@pytest.fixture(scope="module")
def shift_pair():
    """The textured constant shift of test_sgm.py (240 x 320, 8 px, D = 32)."""
    left = _textured(240, 320)
    return left, np.roll(left, -8, axis=1)


@pytest.fixture(scope="module")
def corridor_pair():
    """A rendered corridor pair as test_sgm.py renders it (160 x 256, D = 64)."""
    K = np.array([[200.0, 0, 128.0], [0, 200.0, 80.0], [0, 0, 1]], np.float32)
    calib = Calibration(K, baseline=0.5, cols=256, rows=160)
    left, right, _ = t_synth.render_stereo(t_synth.corridor_scene(seed=7), calib, np.eye(4))
    return _gray(left), _gray(right)


def test_popcount_counts_every_bit_pattern_of_24_bits():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.integers(0, 1 << 24, 4096), [0, (1 << 24) - 1, 1 << 23]])
    want = np.array([bin(int(v)).count("1") for v in x])
    got = t_sgm._popcount24(torch.from_numpy(x.astype(np.int32))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", ["small", "shift"])
def test_census_equals_jax(which, small_pair, shift_pair):
    left, _ = small_pair if which == "small" else shift_pair
    got = t_sgm.census_5x5(_t(left))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_sgm.census_5x5(left)))


@pytest.mark.parametrize("D", [8, 16])
def test_cost_volume_equals_jax(D, small_pair):
    left, right = small_pair
    want = np.asarray(j_sgm._cost_volume(j_sgm.census_5x5(left), j_sgm.census_5x5(right), D))
    got = t_sgm._cost_volume(t_sgm.census_5x5(_t(left)), t_sgm.census_5x5(_t(right)), D)
    assert got.dtype == torch.int32 and got.shape == (24, 40, D)
    np.testing.assert_array_equal(got.numpy(), want)


def test_aggregate_equals_jax_int32(small_pair):
    """All six paths, the diagonal shifts and the scanline starts: 24 x 40,
    D = 16, int32-equal."""
    left, right = small_pair
    cost = np.asarray(j_sgm._cost_volume(j_sgm.census_5x5(left), j_sgm.census_5x5(right), 16))
    want = np.asarray(j_sgm._aggregate(cost, 16, 10, 120))
    got = t_sgm._aggregate(_t(cost), 16, 10, 120)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _disparity_agrees(left, right, D):
    want = np.asarray(j_sgm.sgm_disparity_device(left, right, max_disp=D))
    got = t_sgm.sgm_disparity_device(_t(left), _t(right), max_disp=D).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=DISP_TOL)
    return got


def test_disparity_constant_shift_matches_jax(shift_pair):
    disp = _disparity_agrees(*shift_pair, 32)
    core = disp[20:-20, 48:-16]
    valid = core[core > 0]
    assert len(valid) > 0.8 * core.size
    assert abs(np.median(valid) - 8.0) < 0.5


def test_disparity_rendered_corridor_matches_jax(corridor_pair):
    disp = _disparity_agrees(*corridor_pair, 64)
    assert (disp > 0).mean() > 0.3
