"""The local-mapping driver's port (apps/local_mapping.py) and the TUM driver
on the host frontend's port, against the JAX package on the CPU.

Fixture: test_apps_drivers.py::test_local_mapping_driver's rendered TUM
corridor (5 frames at 320 x 240, capacity 4096, 3 classes, keyframe
threshold 0.99), written once by the JAX package's writer, with a colour
params YAML written here (the reference presets are not in the repo):
test_torch_odometry.py's with an iteration cap of 900. At a cap of 300 the
pairs stop mid-descent and the trajectory is chaotic at the tolerance's
scale: JAX against itself, with the first guess moved by +-1e-6 m along x
or z, parts by up to 5.8e-3 over the 4 pairs (the port: 7.5e-3), so no
port can be held to 5e-3 there. At 900 JAX's own spread is 2.2e-4 and the
port lies 2.2e-4 from JAX. From `JAX_PLATFORMS=cpu python
tests/test_torch_local_mapping.py --fixture-spread CAP 1e-6,0 -1e-6,0
0,1e-6 0,-1e-6` at CAP 300 and 900.

- online: trajectories within 5e-3 (|log dT|, the North star's tolerance),
  keyframe counts equal, map sizes within 1%.
- offline, along the rendered trajectory: the occupied maps agree (the
  voxels that carry evidence and a clear class: same centres and classes;
  alpha within rtol 1e-5 plus JAX's own float32 prefix-sum bound, see
  test_torch_posegraph_bki.py).
- the TUM driver with its default host frontend (OpenCV's NL-means
  included) against JAX's on 3 frames: poses within 5e-3.
- the online mode's odometry replay (run_frames(odometry=...)) reproduces
  the run it came from exactly.

Where JAX's code converts a colour image to grey, the test gives it OpenCV
4's BGR2GRAY, the port's (test_torch_frontend_host.py).
"""

import sys
from pathlib import Path

if __name__ == "__main__":      # as a script: the repo root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import cv2
import numpy as np
import pytest
import torch

from unified_cvo_tpu.apps import local_mapping as j_lm
from unified_cvo_tpu.apps import tum_odometry as j_tum
from unified_cvo_tpu.datasets.tum import read_tum_trajectory, write_tum_pose_row
from unified_cvo_tpu.models import bki as j_bki
from unified_cvo_tpu.utils import synth as j_synth
from unified_cvo_tpu_torch.apps import local_mapping as t_lm
from unified_cvo_tpu_torch.apps import tum_odometry as t_tum
from unified_cvo_tpu_torch.ops import lie as t_lie

torch.set_num_threads(1)

POSE_TOL = 5e-3
KW = dict(max_frames=5, resolution=0.1, capacity=4096, num_classes=3,
          keyframe_function_angle=0.99, log=lambda *a: None)
_CV_CVTCOLOR = cv2.cvtColor


def _opencv4_gray(img, code, *a, **kw):
    if code != cv2.COLOR_BGR2GRAY:
        return _CV_CVTCOLOR(img, code, *a, **kw)
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    return ((1868 * b + 9617 * g + 4899 * r + 8192) >> 14).astype(np.uint8)


@pytest.fixture(autouse=True)
def jax_opencv4(monkeypatch):
    monkeypatch.setattr(cv2, "cvtColor", _opencv4_gray)


def write_fixture(root, max_iter=900):
    """test_local_mapping_driver's sequence, the colour params YAML at the
    iteration cap `max_iter` and the rendered trajectory under `root`:
    (sequence dir, YAML path, trajectory path, poses)."""
    d = str(root / "seq")
    calib = j_synth.tum_calibration()
    scene = j_synth.corridor_scene(5, half_width=2.5, floor_y=1.2, ceil_y=-1.2, length=30.0)
    traj = j_synth.corridor_trajectory(5, step=0.08, yaw_rate=0.015, bob=0.005)
    j_synth.write_tum_sequence(d, scene, traj, calib)
    yaml = root / "colour.yaml"
    yaml.write_text("ell_init: 0.5\nell_init_first_frame: 0.5\nell_min: 0.05\n"
                    f"ell_max: 1.0\nis_using_intensity: 1\nMAX_ITER: {max_iter}\n")
    gt = str(root / "gt.txt")
    with open(gt, "w") as f:
        for i, T in enumerate(traj):
            write_tum_pose_row(f, f"{1000.0 + 0.1 * i:.4f}", T)
    return d, str(yaml), gt, traj


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    root = tmp_path_factory.mktemp("local_mapping")
    return (*write_fixture(root), root)


def _gap(A, B):
    E = np.linalg.inv(A) @ B
    xi = t_lie.se3_log(torch.from_numpy(E[:3, :3]), torch.from_numpy(E[:3, 3]))
    return float(torch.linalg.vector_norm(xi))


def test_online_local_mapping_matches_jax(seq):
    d, yaml, _, traj, root = seq
    kj = j_lm.run_sequence(d, yaml, str(root / "on_j"), denoise=False, **KW)
    kt = t_lm.run_sequence(d, yaml, str(root / "on_t"), denoise=False, device="cpu", **KW)
    assert kt[:2] == kj[:2] and kt[0] == 5 and kt[1] >= 2
    assert abs(kt[2] - kj[2]) <= 0.01 * kj[2] and kt[2] > 1000
    _, ej = read_tum_trajectory(str(root / "on_j_traj.txt"))
    _, et = read_tum_trajectory(str(root / "on_t_traj.txt"))
    gaps = [_gap(a, b) for a, b in zip(ej, et)]
    assert len(gaps) == 5 and max(gaps) < POSE_TOL, gaps
    m = np.load(str(root / "on_t_map.npz"))
    assert m["centers"].shape == (kt[2], 3) and np.isfinite(m["centers"]).all()


def test_offline_local_mapping_matches_jax(seq):
    d, yaml, gt, _, root = seq
    kj = j_lm.run_sequence(d, yaml, str(root / "off_j"), trajectory=gt, denoise=False, **KW)
    res = t_lm.run_frames(_frames(d), _calib(d), _params(yaml),
                          trajectory=t_lm._load_trajectory(gt), denoise=False, device="cpu",
                          **KW)
    assert res.frames == kj[0] == 5 and res.pose_graph is None
    mj = np.load(str(root / "off_j_map.npz"))
    m = res.global_map
    atol = 2.0 ** -23 * float((m.alpha.double() - m.prior).sum())
    res_ = KW["resolution"]

    def by_key(centers, sems, alpha):
        keys = j_bki._pack_keys(np.floor(centers / res_).astype(np.int64))
        return dict(zip(keys.tolist(), zip(sems.tolist(), alpha)))

    ej = by_key(mj["centers"], mj["semantics"], mj["alpha"])
    et = by_key(res.centers, res.semantics, res.alpha)
    sure = 0
    for key, (sem, a) in ej.items():
        top2 = np.sort(a)[-2:]
        if (a - m.prior).max() > 1e-4 and top2[1] - top2[0] > max(1e-4 * top2[1], 2 * atol):
            assert key in et and et[key][0] == sem, key
            np.testing.assert_allclose(et[key][1], a, rtol=1e-5, atol=atol)
            sure += 1
    assert sure > 10000 and abs(len(et) - len(ej)) <= 0.01 * len(ej), (sure, len(et), len(ej))


def _frames(d):
    from unified_cvo_tpu_torch.datasets.tum import TumHandler

    tum = TumHandler(d)
    while True:
        pair = tum.read_next_rgbd()
        if pair is None:
            return
        ts = tum.timestamp()
        tum.next()
        yield pair[0], pair[1], ts


def _calib(d):
    from unified_cvo_tpu_torch.datasets.tum import TumHandler

    return TumHandler(d).calibration()


def _params(yaml):
    from unified_cvo_tpu_torch.config import read_cvo_params_yaml

    return read_cvo_params_yaml(yaml)


def test_odometry_replay_reproduces_the_online_run(seq):
    """run_frames fed an online run's odometry (as chip_smoke.py phase 12a
    reruns the card's back end on the CPU) reproduces that run exactly:
    keyframes, trajectory and maps. The camera holds still at frame 3: at
    1024 points and 10 iterations a moving pair's function angle is about
    0.0065 and the still pair's 0.010, so at the threshold 0.008 frame 3 is
    fused into keyframe 2's map, and the window of 2 slides."""
    d, yaml, _, _, _ = seq
    frames = list(_frames(d))
    frames = frames[:3] + [frames[2]] + frames[3:]
    params = _params(yaml).replace(MAX_ITER=10)
    kw = dict(num_classes=3, capacity=1024, keyframe_function_angle=0.008, window_size=2,
              denoise=False, device="cpu", log=lambda *a: None)
    res = t_lm.run_frames(frames, _calib(d), params, **kw)
    rep = t_lm.run_frames(frames, _calib(d), params, odometry=res.odometry, **kw)
    assert [k.frame_id for k in res.keyframes] == [k.frame_id for k in rep.keyframes] \
        == [0, 1, 2, 4, 5], [fa for _, fa in res.odometry]
    assert res.pose_graph.window_lo == rep.pose_graph.window_lo == 3
    assert rep.align_infos == [] and len(rep.odometry) == 5
    for (_, a), (_, b) in zip(res.trajectory, rep.trajectory):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(res.keyframes, rep.keyframes):
        assert torch.equal(a.local_map.keys, b.local_map.keys)
        assert torch.equal(a.local_map.alpha, b.local_map.alpha)
    np.testing.assert_array_equal(res.centers, rep.centers)
    np.testing.assert_array_equal(res.alpha, rep.alpha)


def test_tum_driver_host_frontend_matches_jax(seq, tmp_path):
    """tum_odometry's default frontend (the host pipeline, OpenCV's
    NL-means) in both packages over 3 frames."""
    d, yaml, _, _, _ = seq
    kw = dict(max_frames=3, max_iter=300, capacity=4096, log=lambda *a: None)
    pj, ts_j = j_tum.run_sequence(d, yaml, str(tmp_path / "jax.txt"), **kw)
    pt, ts_t = t_tum.run_sequence(d, yaml, str(tmp_path / "port.txt"), device="cpu", **kw)
    assert ts_t == ts_j and pt.shape == pj.shape == (3, 4, 4)
    gaps = [_gap(a, b) for a, b in zip(pj, pt)]
    assert max(gaps) < POSE_TOL, gaps


def test_tum_frames_match_the_jax_writer(tmp_path):
    """synth.tum_frames (the in-memory frames of chip_smoke.py's loop
    closure phase) equals what JAX's write_tum_sequence writes, depth noise
    included: test_e2e_accuracy.py's room at 160 x 120, 3 frames."""
    from unified_cvo_tpu_torch.datasets.tum import TumHandler
    from unified_cvo_tpu_torch.utils import synth as t_synth

    calib = j_synth.tum_calibration(W=160, H=120, fx=125.0)
    scene = j_synth.room_scene(7, half=6.0, n_pillars=3)
    traj = j_synth.loop_trajectory(3, radius=2.5)
    j_synth.write_tum_sequence(str(tmp_path), scene, traj, calib, depth_noise=0.005)
    tum = TumHandler(str(tmp_path))
    t_scene = t_synth.room_scene(7, half=6.0, n_pillars=3)
    for bgr, d16, ts in t_synth.tum_frames(t_scene, traj, calib, depth_noise=0.005):
        rgb, depth = tum.read_next_rgbd()
        assert ts == tum.timestamp()
        np.testing.assert_array_equal(bgr, rgb)
        np.testing.assert_array_equal(d16, depth)
        tum.next()
    assert tum.read_next_rgbd() is None


# ---------------------------------------------------------------------------
# As a script: chip_smoke.py phase 12b's loop closure through JAX on the CPU,
# from the identity or, with `--spread DX,DZ ...`, with the first guess moved
# by each (DX, 0, DZ) metres:
#   JAX_PLATFORMS=cpu python tests/test_torch_local_mapping.py
#   JAX_PLATFORMS=cpu python tests/test_torch_local_mapping.py --spread 1e-6,0 -1e-6,0 0,1e-6
# or, with `--fixture-spread CAP DX,DZ ...`, JAX's own spread on the online
# test's fixture at the iteration cap CAP (fixture_spread):
#   JAX_PLATFORMS=cpu python tests/test_torch_local_mapping.py --fixture-spread 300 \
#       1e-6,0 -1e-6,0 0,1e-6 0,-1e-6


def fixture_spread(max_iter, shifts):
    """test_online_local_mapping_matches_jax's run at the iteration cap
    `max_iter`: JAX as the test runs it, JAX with the first pair's guess
    moved by each (DX, 0, DZ) metres, and the port on the CPU. Prints each
    run's per-frame gap (|log dT|) to JAX's unmoved trajectory."""
    import importlib
    import json
    import tempfile

    j_align = importlib.import_module("unified_cvo_tpu.models.align")

    root = Path(tempfile.mkdtemp())
    d, yaml, _, _ = write_fixture(root, max_iter)
    j_lm.run_sequence(d, yaml, str(root / "j"), denoise=False, **KW)
    _, ref = read_tum_trajectory(str(root / "j_traj.txt"))
    runs = {}
    plain = j_align.align
    for shift in shifts:
        calls = []

        def moved(src, tgt, guess, *a, **kw):
            if not calls:
                guess = guess.at[:3, 3].add(np.asarray(shift, np.float32))
            calls.append(1)
            return plain(src, tgt, guess, *a, **kw)

        j_align.align = moved
        try:
            j_lm.run_sequence(d, yaml, str(root / "m"), denoise=False, **KW)
        finally:
            j_align.align = plain
        runs[f"jax {shift}"] = read_tum_trajectory(str(root / "m_traj.txt"))[1]
    t_lm.run_sequence(d, yaml, str(root / "t"), denoise=False, device="cpu", **KW)
    runs["port"] = read_tum_trajectory(str(root / "t_traj.txt"))[1]
    for name, poses in runs.items():
        print(json.dumps({"max_iter": max_iter, "run": name,
                          "gaps": [_gap(a, b) for a, b in zip(ref, poses)]}), flush=True)


def jax_loop_closure(frames, traj, calib, params_fields, loop_iter=300, capacity=4096,
                     guess_shift=(0.0, 0.0, 0.0)):
    """test_e2e_accuracy.py::test_online_slam_loop_closure_e2e's pipeline in
    the JAX package on the given in-memory frames (the host frontend without
    NL-means, as the card runs it): returns its keyframes, ATEs, closure
    function angles, surface occupancy and centre states. `guess_shift`
    moves the first pair's initial guess (metres)."""
    import jax.numpy as jnp

    from unified_cvo_tpu.config import CvoParams
    from unified_cvo_tpu.frontend.pipeline import pointcloud_from_rgbd
    from unified_cvo_tpu.models.align import align, function_angle
    from unified_cvo_tpu.models.bki import SemanticBKIMap
    from unified_cvo_tpu.models.posegraph import PoseGraph, PoseGraphConfig, RelativePose
    from unified_cvo_tpu.utils.metrics import ate_rmse
    from unified_cvo_tpu.utils.pointcloud import to_numpy_valid

    params = CvoParams().replace(**params_fields)
    clouds = [pointcloud_from_rgbd(rgb, d, calib, capacity=capacity, denoise=False)
              for rgb, d, _ in frames]
    pg = PoseGraph(PoseGraphConfig(window_size=0, optimize_iters=8, robust_delta=0.05))
    pg.add_first_frame(0)
    kf_clouds, kf_frames = [clouds[0]], [0]
    odo, world_T, kf_T, prev_rel, fa_track = [np.eye(4)], np.eye(4), np.eye(4), np.eye(4), []
    first = params.replace(ell_init=0.5, ell_max=1.0)
    ell = jnp.float32(max(params.ell_init * 0.5, params.ell_min))
    for k in range(1, len(clouds)):
        guess = np.linalg.inv(prev_rel)
        if k == 1:
            guess[:3, 3] += guess_shift
        T_rel, _, _ = align(clouds[k - 1], clouds[k], jnp.asarray(guess, jnp.float32),
                            first if k == 1 else params, max_iter=loop_iter, chunk=2048)
        rel = np.asarray(T_rel, np.float64)
        prev_rel = rel
        kf_T = kf_T @ rel
        world_T = world_T @ rel
        odo.append(world_T.copy())
        fa = float(function_angle(clouds[k - 1], clouds[k], jnp.asarray(T_rel, jnp.float32),
                                  ell, params, approximate=False))
        fa_track.append(fa)
        if pg.add_frame(k, kf_T, function_angle=fa):
            kf_T = np.eye(4)
            kf_clouds.append(clouds[k])
            kf_frames.append(k)
            world_T = pg.keyframe_poses[-1].copy()
    gt_kf = traj[kf_frames]
    ate_odo = ate_rmse(gt_kf, np.stack([odo[k] for k in kf_frames]))
    T_lc, _, _ = align(kf_clouds[0], kf_clouds[-1], jnp.asarray(np.eye(4), jnp.float32),
                       params.replace(ell_init=0.5, ell_max=1.0), max_iter=500, chunk=2048)
    fa_lc = float(function_angle(kf_clouds[0], kf_clouds[-1], jnp.asarray(T_lc), ell, params,
                                 approximate=False))
    pg.factors.append(RelativePose(curr_id=len(pg.keyframe_poses) - 1, ref_id=0,
                                   transform=np.asarray(T_lc, np.float64), inner_product=fa_lc))
    pg.optimize()
    ate_opt = ate_rmse(gt_kf, np.stack(pg.keyframe_poses))
    m = SemanticBKIMap(resolution=0.1, num_classes=4, ell=0.2, free_resolution=100.0)
    for kc, T in zip(kf_clouds, pg.keyframe_poses):
        xyz = to_numpy_valid(kc)["xyz"]
        m.insert_pointcloud(xyz @ T[:3, :3].T + T[:3, 3], None, origin=T[:3, 3])
    surf = to_numpy_valid(kf_clouds[0])["xyz"][::7]
    T0 = np.linalg.inv(traj[0])
    ctr = np.array([[0.0, -0.3, 0.0], [0.3, 0.0, 0.3], [-0.3, 0.1, -0.3]])
    return {"keyframes": len(kf_frames), "ate_odometry_m": float(ate_odo),
            "ate_closed_m": float(ate_opt), "fa_closure": fa_lc,
            "fa_tracking_median": float(np.median(fa_track)),
            "surface_occupancy": float((m.query(surf)[0] == 1).mean()),
            "centre_states": m.query(ctr @ T0[:3, :3].T + T0[:3, 3])[0].tolist()}


if __name__ == "__main__":
    import json
    import time

    import chip_smoke
    from unified_cvo_tpu_torch.utils import synth as t_synth

    cv2.cvtColor = _opencv4_gray        # the port's grey level, on the JAX side
    if "--fixture-spread" in sys.argv:
        at = sys.argv.index("--fixture-spread")
        fixture_spread(int(sys.argv[at + 1]),
                       [(float(a), 0.0, float(c)) for a, c in
                        [s.split(",") for s in sys.argv[at + 2:]]])
        sys.exit(0)
    calib = j_synth.tum_calibration()
    scene = t_synth.room_scene(7, half=6.0, n_pillars=3)
    traj = t_synth.loop_trajectory(chip_smoke.LOOP_FRAMES, radius=2.5)
    frames = list(t_synth.tum_frames(scene, traj, calib, depth_noise=0.005))
    fields = {k: getattr(chip_smoke.colour_yaml_params(), k) for k in (
        "ell_init", "ell_init_first_frame", "ell_min", "ell_max", "is_using_intensity")}
    shifts = [(0.0, 0.0, 0.0)]
    if "--spread" in sys.argv:      # the first guess moved by +-1e-6 m along x, +1e-6 m along z
        shifts = [(float(a), 0.0, float(c)) for a, c in
                  [s.split(",") for s in sys.argv[sys.argv.index("--spread") + 1:]]]
    for shift in shifts:
        t0 = time.time()
        out = jax_loop_closure(frames, traj, calib, fields, loop_iter=chip_smoke.LOOP_ITER,
                               guess_shift=shift)
        print(json.dumps({"guess_shift": shift, "seconds": time.time() - t0, **out}),
              flush=True)
