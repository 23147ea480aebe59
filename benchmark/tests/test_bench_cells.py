"""Each cell's traffic, driver and reference at a tiny size on the CPU: a
sound run comes out correct, the traffic is the same for the same seed,
and the result line has the benchmark's keys."""

import math

import numpy as np
import pytest
import torch

import bench_tiny
import harness


@pytest.mark.parametrize("cell", sorted(bench_tiny.TINY))
def test_tiny_run_is_correct(cell):
    res = bench_tiny.run(cell)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert "setup_s" in res["metrics"]
    for c in res["checks"].values():
        assert math.isfinite(c["value"]) and c["value"] <= c["limit"]


def test_fleet_traffic_repeats_by_seed():
    fleet = harness.load_module("traffic", "fleet")
    spec = dict(drives=3, points=400, pairs=2, noise_m=0.005, wobble_amp=[1.0, 2.0])
    a, b = fleet.make(spec, 2 ** 31 + 5, "cpu"), fleet.make(spec, 2 ** 31 + 5, "cpu")
    c = fleet.make(spec, 2 ** 31 + 6, "cpu")
    assert torch.equal(a.frames, b.frames) and torch.equal(a.T_true, b.T_true)
    assert not torch.equal(a.frames, c.frames)
    assert a.frames.shape == (3, 3, 400, 3)
    # frame k + 1 is frame k moved by the true motion, up to the noise and
    # the wrap at 55 m
    z = a.frames[:, :, :, 2]
    assert float(z.min()) > 1.5 and float(z.max()) < 55.5
    R = a.T_true[0, 0, :3, :3].double()
    assert torch.allclose(R @ R.T, torch.eye(3, dtype=torch.float64), atol=1e-6)


def test_stereo_traffic_repeats_by_seed():
    gen = harness.load_module("traffic", "stereo_corridor")
    spec = dict(bench_tiny.STEREO["traffic"], step_m=0.35, yaw_rate=0.01, bob_m=0.01,
                length_m=60.0, half_width_m=4.0, floor_y=1.6, ceil_y=-2.2, tex_scale_m=0.04)
    cam = dict(bench_tiny.STEREO["camera"], baseline=0.5372)
    a, b = gen.make(spec, cam, 99, "cpu"), gen.make(spec, cam, 99, "cpu")
    assert all(np.array_equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))
    left, right = a[0]
    assert left.shape == (180, 320, 3) and left.dtype == np.uint8
    assert not np.array_equal(left, right) and left.std() > 10


def test_reference_pose_error_is_zero_for_the_inverse_motion():
    import cvo_ref

    fleet = harness.load_module("traffic", "fleet")
    T = torch.as_tensor(fleet.exp_se3(fleet.XI_BASE + 0.01), dtype=torch.float64)
    assert cvo_ref.pose_error(torch.linalg.inv(T), T) < 1e-12
    assert abs(cvo_ref.pose_error(torch.eye(4, dtype=torch.float64), T)
               - float(np.linalg.norm(fleet.XI_BASE + 0.01))) < 1e-9


def test_tf32_rounding():
    import cvo_ref

    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.14159, 1e-20])
    y = cvo_ref.tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0 and y[2] == 1.0 + 2 ** -9
    assert abs(float(y[3]) + 3.14159) < 3.14159 * 2 ** -11
    assert torch.all((y.view(torch.int32) & 0x1FFF) == 0)
