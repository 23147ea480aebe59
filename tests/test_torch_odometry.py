"""The odometry drivers with the device frontend, and the numpy copies they
read, against the JAX package on the CPU.

- kitti_odometry.run_sequence(frontend="device") on the 3-frame stereo
  fixture of test_apps_drivers.py, and tum_odometry.run_sequence with the
  device frontend and NL-means on a 3-frame synth.write_tum_sequence at
  160 x 120: each accumulated pose within |log dT| < 5e-3 of JAX's (the
  North star's tolerance; iteration counts are not compared). Both packages
  read the same files, written once.
- run_frames over the same images in memory gives run_sequence's poses.
- the stereo host frontend, not ported (compute_disparity), raises;
  --semantic with the device frontend raises as in JAX.
- the copies (utils.metrics, read_calibration, the pose-row writers and
  readers, synth's texture and renderer) give JAX's values.

Run as a script, it drives `chip_smoke.py` phases 9 and 10's rendered
frames (KITTI stereo at 1241 x 376, TUM RGB-D at 640 x 480 with NL-means)
through JAX's device frontend and JAX's driver loop on the CPU, with the
phases' settings (KITTI_COLOR_BENCH, the 1500-iteration cap, capacities
32768 and 16384), and prints each pair's pose error against the rendered
trajectory and its relative pose as an se(3) log; `--port` also runs the
port on the CPU and prints its gap to JAX (a few minutes each). `--spread`
runs instead JAX's first pair of the phase alone, from the identity, from
the identity moved by +-1e-6 m along x and along z, and with the source
cloud moved by one ulp, and prints how far each run ends from the unmoved
one (with `--port`, the port's runs too): JAX's own spread on that pair, which
`chip_smoke.JAX_MISSES` holds the card to where JAX misses the bench bound:

    JAX_PLATFORMS=cpu python tests/test_torch_odometry.py [stereo|rgbd] [--spread] [--port]
"""

import dataclasses
import io
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":      # as a script: the repo root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import cv2
import numpy as np
import pytest
import torch

from unified_cvo_tpu.apps import kitti_odometry as j_kitti
from unified_cvo_tpu.apps import tum_odometry as j_tum
from unified_cvo_tpu.datasets import kitti as j_kitti_ds
from unified_cvo_tpu.datasets import tum as j_tum_ds
from unified_cvo_tpu.frontend import calibration as j_calib
from unified_cvo_tpu.utils import logging as j_logging
from unified_cvo_tpu.utils import metrics as j_metrics
from unified_cvo_tpu.utils import synth as j_synth
from unified_cvo_tpu_torch import convert
from unified_cvo_tpu_torch.apps import kitti_odometry as t_kitti
from unified_cvo_tpu_torch.apps import tum_odometry as t_tum
from unified_cvo_tpu_torch.config import read_cvo_params_yaml
from unified_cvo_tpu_torch.datasets import kitti as t_kitti_ds
from unified_cvo_tpu_torch.datasets import tum as t_tum_ds
from unified_cvo_tpu_torch.frontend import calibration as t_calib
from unified_cvo_tpu_torch.frontend import pipeline as t_pipeline
from unified_cvo_tpu_torch.ops import lie as t_lie
from unified_cvo_tpu_torch.utils import logging as t_logging
from unified_cvo_tpu_torch.utils import metrics as t_metrics
from unified_cvo_tpu_torch.utils import synth as t_synth

torch.set_num_threads(1)

POSE_TOL = 5e-3
MAX_ITER = 300
CAPACITY = 4096
SHORT_ITER = 20      # the in-memory run against the file run: equal bits, any length


def _quiet(*a):
    pass


def _gap(A, B):
    E = np.linalg.inv(A) @ B
    xi = t_lie.se3_log(torch.from_numpy(E[:3, :3]), torch.from_numpy(E[:3, 3]))
    return float(torch.linalg.vector_norm(xi))


def _texture(h, w, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h // 8, w // 8), np.uint8)
    return np.stack([np.kron(base, np.ones((8, 8), np.uint8))] * 3, axis=-1)


@pytest.fixture(scope="module")
def params_yaml(tmp_path_factory):
    path = tmp_path_factory.mktemp("params") / "colour.yaml"
    path.write_text("ell_init: 0.5\nell_init_first_frame: 0.5\nell_min: 0.05\n"
                    "ell_max: 1.0\nis_using_intensity: 1\n")
    return str(path)


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    """test_apps_drivers.py's 3 stereo frames: constant disparity 8 px
    (depth 6.25 at fx = 100, b = 0.5); frame-to-frame +2 px shift."""
    d = tmp_path_factory.mktemp("kitti")
    (d / "image_2").mkdir()
    (d / "image_3").mkdir()
    (d / "cvo_calib.txt").write_text("100.0 100.0 128.0 110.0 0.5 256 220")
    img = _texture(220, 256, seed=7)
    for i in range(3):
        left = np.roll(img, -2 * i, axis=1)
        cv2.imwrite(str(d / "image_2" / f"{i:06d}.png"), left)
        cv2.imwrite(str(d / "image_3" / f"{i:06d}.png"), np.roll(left, -8, axis=1))
    return str(d)


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    """3 rendered RGB-D frames at 160 x 120 in the TUM fixture's corridor
    (test_e2e_accuracy.py), written once by the JAX package's writer."""
    d = str(tmp_path_factory.mktemp("tum"))
    calib = j_synth.tum_calibration(W=160, H=120, fx=125.0)
    scene = j_synth.corridor_scene(5, half_width=2.5, floor_y=1.2, ceil_y=-1.2, length=30.0)
    traj = j_synth.corridor_trajectory(3, step=0.08, yaw_rate=0.015, bob=0.005)
    j_synth.write_tum_sequence(d, scene, traj, calib)
    return d


@pytest.fixture(scope="module")
def kitti_runs(kitti_dir, params_yaml, tmp_path_factory):
    out = tmp_path_factory.mktemp("kitti_out")
    kw = dict(max_iter=MAX_ITER, capacity=CAPACITY, frontend="device", log=_quiet)
    pj = j_kitti.run_sequence(kitti_dir, params_yaml, str(out / "jax.txt"), **kw)
    pt = t_kitti.run_sequence(kitti_dir, params_yaml, str(out / "port.txt"), device="cpu",
                              **kw)
    return pj, pt, out


def test_kitti_device_frontend_matches_jax(kitti_runs):
    pj, pt, out = kitti_runs
    assert pt.shape == pj.shape == (3, 4, 4)
    gaps = [_gap(a, b) for a, b in zip(pj, pt)]
    assert max(gaps) < POSE_TOL, gaps
    # the fixture moves ~0.1 m a frame along x
    assert 0.05 < pt[1][0, 3] < 0.2, pt[1]
    rows_j = np.loadtxt(out / "jax.txt")
    rows_t = np.loadtxt(out / "port.txt")
    assert rows_t.shape == rows_j.shape == (3, 12)
    np.testing.assert_allclose(rows_t.reshape(-1, 3, 4), pt[:, :3, :4], atol=1e-8)


def test_kitti_run_frames_in_memory_equals_run_sequence(kitti_dir, params_yaml, tmp_path):
    kw = dict(max_iter=SHORT_ITER, capacity=CAPACITY, frontend="device", device="cpu",
              log=_quiet)
    pt = t_kitti.run_sequence(kitti_dir, params_yaml, str(tmp_path / "port.txt"), **kw)
    calib = t_calib.read_calibration(f"{kitti_dir}/cvo_calib.txt", "stereo")
    frames = [(cv2.imread(f"{kitti_dir}/image_2/{i:06d}.png"),
               cv2.imread(f"{kitti_dir}/image_3/{i:06d}.png")) for i in range(3)]
    out = io.StringIO()
    poses, records = t_kitti.run_frames(iter(frames), calib, read_cvo_params_yaml(params_yaml),
                                      out=out, **kw)
    np.testing.assert_array_equal(poses, pt)
    assert len(out.getvalue().splitlines()) == 2 and len(records) == 2
    for rec in records:
        assert rec.info.iterations == rec.info.host_reads > 0 and rec.ret == 0
        assert rec.info.final_ell.device.type == "cpu"
        assert rec.wait_seconds > 0 and rec.frontend_seconds > 0


def test_tum_device_frontend_with_nlm_matches_jax(tum_dir, params_yaml, tmp_path):
    kw = dict(max_iter=MAX_ITER, capacity=CAPACITY, device_frontend=True, log=_quiet)
    pj, ts_j = j_tum.run_sequence(tum_dir, params_yaml, str(tmp_path / "jax.txt"), **kw)
    pt, ts_t = t_tum.run_sequence(tum_dir, params_yaml, str(tmp_path / "port.txt"),
                                  device="cpu", **kw)
    assert ts_t == ts_j and pt.shape == pj.shape == (3, 4, 4)
    gaps = [_gap(a, b) for a, b in zip(pj, pt)]
    assert max(gaps) < POSE_TOL, gaps
    rows_j = np.loadtxt(tmp_path / "jax.txt", dtype=str)
    rows_t = np.loadtxt(tmp_path / "port.txt", dtype=str)
    assert rows_t.shape == rows_j.shape == (3, 8)
    assert list(rows_t[:, 0]) == list(rows_j[:, 0])


def test_host_frontend_raises_until_ported(kitti_dir, tum_dir, params_yaml, tmp_path):
    calib = t_calib.read_calibration(f"{kitti_dir}/cvo_calib.txt", "stereo")
    params = read_cvo_params_yaml(params_yaml)
    with pytest.raises(NotImplementedError, match="1.9"):
        t_kitti.run_sequence(kitti_dir, params_yaml, str(tmp_path / "a.txt"), device="cpu")
    with pytest.raises(NotImplementedError, match="1.9"):
        t_kitti.run_frames([], calib, params, device="cpu")
    # the RGB-D host frontend is ported (test_torch_local_mapping.py drives
    # the TUM driver with it); the stereo one still lacks compute_disparity
    left = np.zeros((32, 48, 3), np.uint8)
    with pytest.raises(NotImplementedError, match="1.9"):
        t_pipeline.pointcloud_from_stereo(left, left, calib, denoise=False, device="cpu")
    with pytest.raises(ValueError, match="semantic"):
        t_kitti.run_sequence(kitti_dir, params_yaml, str(tmp_path / "c.txt"), semantic=True,
                             frontend="device", device="cpu")


def test_kitti_max_disp_follows_the_width_rule():
    """JAX's rule (kitti_odometry.py:80-85): 128 at KITTI's full width (and
    when the calibration gives none), 64 below 900 columns."""
    assert [t_kitti.max_disp_for(c) for c in (1241, 900, 0, 899, 620)] == [128, 128, 128, 64, 64]


# ---------------------------------------------------------------- the copies


def _trajectory(n, seed):
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4), (n, 1, 1))
    for i in range(1, n):
        xi = torch.from_numpy(rng.normal(scale=[0.02, 0.02, 0.02, 0.3, 0.1, 1.0]))
        R, t = t_lie.se3_exp(xi, 1.0)
        step = np.eye(4)
        step[:3, :3], step[:3, 3] = R.numpy(), t.numpy()
        poses[i] = poses[i - 1] @ step
    return poses


def test_metrics_copy_equals_jax():
    gt = _trajectory(60, 0)
    est = gt @ _trajectory(2, 1)[1]            # a constant offset
    est[:, :3, 3] += np.random.default_rng(3).normal(scale=0.05, size=(60, 3))
    for scale in (False, True):
        assert t_metrics.ate_rmse(gt, est, scale) == j_metrics.ate_rmse(gt, est, scale)
        a, b = (m.umeyama_alignment(est[:, :3, 3], gt[:, :3, 3], scale)
                for m in (t_metrics, j_metrics))
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
    assert t_metrics.rpe_rmse(gt, est, 3) == j_metrics.rpe_rmse(gt, est, 3)
    lengths = (5.0, 10.0, 20.0)
    assert (t_metrics.kitti_seq_error(gt, est, step=2, lengths=lengths)
            == j_metrics.kitti_seq_error(gt, est, step=2, lengths=lengths))


@pytest.mark.parametrize("kind", ["stereo", "rgbd"])
def test_read_calibration_copy_equals_jax(kind, tmp_path):
    path = tmp_path / "cvo_calib.txt"
    path.write_text("718.856 718.856 607.1928 185.2157 0.5372 1241 376\n")
    want = j_calib.read_calibration(str(path), kind)
    got = t_calib.read_calibration(str(path), kind)
    assert dataclasses.asdict(got).keys() == dataclasses.asdict(want).keys()
    np.testing.assert_array_equal(got.intrinsic, want.intrinsic)
    assert (got.baseline, got.depth_scale, got.cols, got.rows) == \
        (want.baseline, want.depth_scale, want.cols, want.rows)
    port = convert.calibration_from_fields(**dataclasses.asdict(want))
    assert (port.fx, port.fy, port.cx, port.cy, port.baseline, port.depth_scale) == \
        (want.fx, want.fy, want.cx, want.cy, want.baseline, want.depth_scale)


def test_pose_row_writers_and_readers_equal_jax(tmp_path):
    poses = _trajectory(5, 4)
    for mod, name in ((j_kitti_ds, "j"), (t_kitti_ds, "t")):
        with open(tmp_path / f"{name}_kitti.txt", "w") as f:
            for T in poses:
                mod.write_kitti_pose_row(f, T)
    for mod, name in ((j_tum_ds, "j"), (t_tum_ds, "t")):
        with open(tmp_path / f"{name}_tum.txt", "w") as f:
            for i, T in enumerate(poses):
                mod.write_tum_pose_row(f, f"{1000 + 0.1 * i:.4f}", T)
    for kind in ("kitti", "tum"):
        assert (tmp_path / f"t_{kind}.txt").read_text() == (tmp_path / f"j_{kind}.txt").read_text()
    np.testing.assert_array_equal(t_kitti_ds.read_kitti_poses(str(tmp_path / "t_kitti.txt")),
                                  j_kitti_ds.read_kitti_poses(str(tmp_path / "j_kitti.txt")))
    st, pt = t_tum_ds.read_tum_trajectory(str(tmp_path / "t_tum.txt"))
    sj, pj = j_tum_ds.read_tum_trajectory(str(tmp_path / "j_tum.txt"))
    assert st == sj
    np.testing.assert_array_equal(pt, pj)


def test_metrics_logger_and_phase_timer_write_jax_rows(tmp_path):
    """The same jsonl rows as JAX's logger (clock fields aside); phase_timer
    waits for its `sync`, a callable or a tensor."""
    waited = []
    for mod, name in ((j_logging, "j"), (t_logging, "t")):
        log = mod.MetricsLogger(str(tmp_path / f"{name}.jsonl"))
        log.log(frame=1, iterations=300, final_ell=np.float32(0.25))
        with mod.phase_timer("frontend", log, sync=lambda: waited.append(name)):
            pass
        log.close()
        log.log(frame=2)                   # closed: dropped
    with t_logging.phase_timer("align", None, sync=torch.zeros(3)):
        pass
    with pytest.raises(TypeError):
        with t_logging.phase_timer("align", None, sync=3):
            pass
    assert waited == ["j", "t"]
    rows = {}
    for name in ("j", "t"):
        lines = [json.loads(s) for s in (tmp_path / f"{name}.jsonl").read_text().splitlines()]
        rows[name] = [{k: v for k, v in r.items() if k not in ("t", "seconds")} for r in lines]
        assert all(r["t"] > 0 for r in lines) and lines[1]["seconds"] >= 0
    assert rows["t"] == rows["j"] == [{"frame": 1, "iterations": 300, "final_ell": 0.25},
                                      {"phase": "frontend"}]


def test_synth_texture_copy_matches_jax():
    got = t_synth._texture(512, 512, np.random.default_rng(11))
    want = j_synth._texture(512, 512, np.random.default_rng(11))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_synth_render_stereo_copy_matches_jax():
    kw = dict(W=320, H=200, fx=160.0)
    T = j_synth.corridor_trajectory(3, step=0.35)[2]
    got = t_synth.render_stereo(t_synth.corridor_scene(3), t_synth.kitti_calibration(**kw), T)
    want = j_synth.render_stereo(j_synth.corridor_scene(3), j_synth.kitti_calibration(**kw), T)
    for g, w in zip(got[:2], want[:2]):
        diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
        assert diff.max() <= 1
        assert (diff == 0).mean() >= 0.999
    np.testing.assert_array_equal(got[2], want[2])


# ------------------------------------------------------ script: chip phases


def _chip_phase_chain(kind: str, port: bool):
    """chip_smoke.py phase 9 (`stereo`) or 10 (`rgbd`) on the CPU: the same
    rendered frames through JAX's frontend and driver loop, and optionally
    the port's. Returns [(pose error, se(3) log of the pair's transform)]
    of each package."""
    import chip_smoke
    from unified_cvo_tpu.apps._odometry_common import run_pipelined
    from unified_cvo_tpu.config import CvoParams as JaxParams
    from unified_cvo_tpu.frontend import device as j_dev
    from unified_cvo_tpu_torch.apps import f2f_sequence as f2f
    from unified_cvo_tpu_torch.config import KITTI_COLOR_BENCH

    frames_of = chip_smoke.stereo_frames if kind == "stereo" else chip_smoke.rgbd_frames
    calib, frames, traj = frames_of()
    jc = j_calib.Calibration(**dataclasses.asdict(calib))
    if kind == "stereo":
        def j_build(f):
            return j_dev.device_pointcloud_from_stereo(
                f[0], f[1], jc, capacity=t_kitti.CAPACITY,
                max_disp=t_kitti.max_disp_for(calib.cols))
    else:
        def j_build(f):
            return j_dev.device_pointcloud_from_rgbd(f[0], f[1], jc, capacity=t_tum.CAPACITY,
                                                     denoise=True)
    true = [np.linalg.inv(traj[k + 1]) @ traj[k] for k in range(len(frames) - 1)]

    def row(k, T, ell):
        T = np.asarray(T, np.float32)
        xi = t_lie.se3_log(torch.from_numpy(T[:3, :3]), torch.from_numpy(T[:3, 3]))
        return f2f.pose_errors([T], [true[k]])[0], xi.numpy().astype(np.float64), float(ell)

    jax_rows = []
    jp = JaxParams(**dataclasses.asdict(KITTI_COLOR_BENCH))
    t0 = time.perf_counter()
    run_pipelined(j_build(frames[0]), range(len(frames) - 1),
                  lambda i: (j_build(frames[i + 1]), None), jp, jp.first_frame(),
                  lambda i, T, ret, info, *_: jax_rows.append(row(i, T, info.final_ell)),
                  max_iter=chip_smoke.MAX_ITER,
                  fetch_depth=1)
    print(f"{kind}: JAX on the CPU, {len(jax_rows)} pairs in {time.perf_counter() - t0:.1f} s")
    port_rows = []
    if port:
        t0 = time.perf_counter()
        if kind == "stereo":
            poses, records = t_kitti.run_frames(frames, calib, KITTI_COLOR_BENCH,
                                                max_iter=chip_smoke.MAX_ITER,
                                                frontend="device", device="cpu", log=_quiet)
        else:
            poses, _, records = t_tum.run_frames(frames, calib, KITTI_COLOR_BENCH,
                                                 max_iter=chip_smoke.MAX_ITER,
                                                 device_frontend=True, device="cpu",
                                                 log=_quiet)
        port_rows = [row(k, np.linalg.inv(poses[k]) @ poses[k + 1], records[k].info.final_ell)
                     for k in range(len(poses) - 1)]
        print(f"{kind}: the port on the CPU in {time.perf_counter() - t0:.1f} s")
    return jax_rows, port_rows


def _first_pair_spread(kind: str, port: bool):
    """The first pair of chip_smoke.py phase 9 (`stereo`) or 10 (`rgbd`) as
    the driver loop aligns it (the first-frame parameters, the identity
    guess) through JAX on the CPU, then again with the guess's translation
    moved by +-1e-6 m along x and along z, and with every source coordinate
    moved by one ulp (two seeds); with `port`, the same runs through the
    port's frontend and align on the CPU. Prints each run's pose error, final
    ell, iterations, list builds, se(3) log and distance |log dT| from JAX's
    unmoved run."""
    import jax.numpy as jnp

    import chip_smoke
    from unified_cvo_tpu.config import CvoParams as JaxParams
    from unified_cvo_tpu.frontend import device as j_dev
    from unified_cvo_tpu.models.align import align as j_align
    from unified_cvo_tpu_torch.apps import f2f_sequence as f2f
    from unified_cvo_tpu_torch.config import KITTI_COLOR_BENCH
    from unified_cvo_tpu_torch.frontend import device as t_dev
    from unified_cvo_tpu_torch.models.align import align as t_align

    frames_of = chip_smoke.stereo_frames if kind == "stereo" else chip_smoke.rgbd_frames
    calib, frames, traj = frames_of()
    jc = j_calib.Calibration(**dataclasses.asdict(calib))
    if kind == "stereo":
        kw = dict(capacity=t_kitti.CAPACITY, max_disp=t_kitti.max_disp_for(calib.cols))
        j_clouds = [j_dev.device_pointcloud_from_stereo(f[0], f[1], jc, **kw) for f in frames[:2]]
        t_clouds = [t_dev.device_pointcloud_from_stereo(f[0], f[1], calib, device="cpu", **kw)
                    for f in frames[:2]] if port else None
    else:
        kw = dict(capacity=t_tum.CAPACITY, denoise=True)
        j_clouds = [j_dev.device_pointcloud_from_rgbd(f[0], f[1], jc, **kw) for f in frames[:2]]
        t_clouds = [t_dev.device_pointcloud_from_rgbd(f[0], f[1], calib, device="cpu", **kw)
                    for f in frames[:2]] if port else None
    true = np.linalg.inv(traj[1]) @ traj[0]
    params = KITTI_COLOR_BENCH.first_frame()
    jp = JaxParams(**dataclasses.asdict(params))

    def ulp(xyz, seed):            # every coordinate one ulp up or down
        up = np.random.default_rng(seed).integers(0, 2, xyz.shape).astype(bool)
        return np.where(up, np.nextafter(xyz, np.inf), np.nextafter(xyz, -np.inf))

    cases = [(f"guess t[{'xyz'[axis]}] {dt:+.0e} m", axis, dt, None)
             for axis, dt in ((0, 0.0), (0, 1e-6), (0, -1e-6), (2, 1e-6), (2, -1e-6))]
    cases += [(f"source xyz +-1 ulp (seed {seed})", 0, 0.0, seed) for seed in (0, 1)]
    packages = ["JAX"] + (["port"] if port else [])
    ref = None
    for package in packages:
        for label, axis, dt, seed in cases:
            guess = np.eye(4, dtype=np.float32)
            guess[axis, 3] = dt
            t0 = time.perf_counter()
            if package == "JAX":
                src, tgt = j_clouds
                if seed is not None:
                    src = src._replace(xyz=jnp.asarray(ulp(np.asarray(src.xyz), seed)))
                T, _, info = j_align(src, tgt, jnp.asarray(guess), jp,
                                     max_iter=chip_smoke.MAX_ITER)
            else:
                src, tgt = t_clouds
                if seed is not None:
                    src = dataclasses.replace(
                        src, xyz=torch.from_numpy(ulp(src.xyz.numpy(), seed)))
                T, _, info = t_align(src, tgt, guess, params, device="cpu",
                                     max_iter=chip_smoke.MAX_ITER)
            T = np.asarray(T, np.float64)
            ref = T if ref is None else ref
            xi = t_lie.se3_log(torch.from_numpy(T[:3, :3]), torch.from_numpy(T[:3, 3])).numpy()
            print(f"{kind} pair 0, {package}, {label}: pose error "
                  f"{f2f.pose_errors([T.astype(np.float32)], [true])[0]:.6f}, final ell "
                  f"{float(info.final_ell):.6f}, iterations {int(info.iterations)}, builds "
                  f"{int(info.nl_rebuilds)}, {_gap(ref, T):.3g} from JAX's unmoved run, log "
                  f"{np.array2string(xi, precision=9, max_line_width=200)} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)


def main(argv):
    import jax

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    kinds = [k for k in ("stereo", "rgbd") if k in argv] or ["stereo", "rgbd"]
    if "--spread" in argv:
        for kind in kinds:
            _first_pair_spread(kind, "--port" in argv)
        return 0
    for kind in kinds:
        jax_rows, port_rows = _chip_phase_chain(kind, "--port" in argv)
        for k, (err, xi, ell) in enumerate(jax_rows):
            line = (f"  pair {k}: JAX pose error {err:.6f}, final ell {ell:.6f}, log "
                    f"{np.array2string(xi, precision=9, max_line_width=200)}")
            if port_rows:
                pe, pxi, pell = port_rows[k]
                gap = _gap(*(np.asarray(t_lie.rt_to_mat44(*t_lie.se3_exp(
                    torch.from_numpy(v), 1.0)), np.float64) for v in (xi, pxi)))
                line += f"; port {pe:.6f}, final ell {pell:.6f}, {gap:.3g} from JAX's pose"
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
