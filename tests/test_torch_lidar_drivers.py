"""The lidar odometry drivers and the evaluation CLIs of the port against
the JAX package on the CPU.

- kitti_lidar_odometry.run_sequence, plain and with `semantic=True`, on 3
  rendered 32-beam scans of test_e2e_accuracy.py's lidar room (5 mm
  noise, SemanticKITTI .label files from synth.lidar_height_labels), and
  lyft_lidar_odometry.run_sequence on 3 rendered 40-beam sweeps of its
  Lyft room, capacity 4096, 300 iterations: each accumulated pose within
  |log dT| < 5e-3 of JAX's (the North star's tolerance). Both packages
  read the same files, written once.
- test_apps_drivers.py's ground-and-wall scans (2048 random points) are
  chaotic at its 60 iterations: JAX against itself, the guess of the
  second pair moved by +-1e-6 m, parts by up to 0.035 m, and by up to
  0.11 with the first scan moved by one ulp (ROADMAP section 3). There the
  port's semantic driver is held to what JAX's test holds: the labels
  read, every row finite.
- run_frames over the same scans in memory gives run_sequence's poses;
  method="legoloam" runs the LeGO-LOAM frontend (64 beams over the HDL-64
  elevations its range image assumes) through the same loop.
- evaluate_odometry and evaluate_ate print JAX's lines.
- the Lyft reader equals JAX's.

Run as a script, it drives `chip_smoke.py` phase 13's rendered sequences
(64 x 1800 HDL-64 scans, capacity 16384, 300 iterations a pair: the KITTI
lidar driver over 3 pairs, one LeGO-LOAM pair, one semantic pair, the Lyft
driver over 2 pairs) through JAX's drivers on the CPU and prints each
pair's pose error against the rendered trajectory, the ATE and the RPE;
`--port` also runs the port on the CPU and prints its gap to JAX (about
ten minutes with it):

    JAX_PLATFORMS=cpu python tests/test_torch_lidar_drivers.py [--port]
"""

import contextlib
import io
import sys
import tempfile
import time
from pathlib import Path

if __name__ == "__main__":      # as a script: the repo root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import pytest
import torch

from unified_cvo_tpu.apps import evaluate_ate as j_ate
from unified_cvo_tpu.apps import evaluate_odometry as j_eval
from unified_cvo_tpu.apps import kitti_lidar_odometry as j_lidar
from unified_cvo_tpu.apps import lyft_lidar_odometry as j_lyft
from unified_cvo_tpu.datasets import lyft as j_lyft_ds
from unified_cvo_tpu_torch.apps import evaluate_ate as t_ate
from unified_cvo_tpu_torch.apps import evaluate_odometry as t_eval
from unified_cvo_tpu_torch.apps import kitti_lidar_odometry as t_lidar
from unified_cvo_tpu_torch.apps import lyft_lidar_odometry as t_lyft
from unified_cvo_tpu_torch.config import read_cvo_params_yaml
from unified_cvo_tpu_torch.datasets import lyft as t_lyft_ds
from unified_cvo_tpu_torch.datasets.kitti import KittiHandler, write_kitti_pose_row
from unified_cvo_tpu_torch.ops import lie as t_lie
from unified_cvo_tpu_torch.utils import synth

torch.set_num_threads(1)

POSE_TOL = 5e-3
SHORT_ITER = 20      # the in-memory run against the file run: equal bits, any length


def _quiet(*a):
    pass


def _gap(A, B):
    E = np.linalg.inv(A) @ B
    xi = t_lie.se3_log(torch.from_numpy(E[:3, :3]), torch.from_numpy(E[:3, 3]))
    return float(torch.linalg.vector_norm(xi))


def _ground_and_wall(rng, n=2048):
    ground = np.stack([rng.uniform(2, 40, n // 2), rng.uniform(-15, 15, n // 2),
                       np.full(n // 2, -1.7)], axis=1)
    wall = np.stack([rng.uniform(2, 40, n // 2), np.full(n // 2, 8.0),
                     rng.uniform(-1.5, 3.0, n // 2)], axis=1)
    return np.concatenate([ground, wall]).astype(np.float32)


@pytest.fixture(scope="module")
def semantic_kitti_dir(tmp_path_factory):
    """test_apps_drivers.py's semantic_kitti_lidar_dir: 3 velodyne scans and
    SemanticKITTI .label files (road, building, unlabeled, a moving car);
    the sensor advances 0.4 m along +x a frame."""
    d = tmp_path_factory.mktemp("semkitti")
    (d / "velodyne").mkdir()
    (d / "labels").mkdir()
    rng = np.random.default_rng(3)
    n = 2048
    pts = _ground_and_wall(rng, n)
    raw_ids = np.concatenate([np.full(n // 2, 40, np.uint32), np.full(n // 2, 50, np.uint32)])
    raw_ids[:40] = 0
    raw_ids[40:60] = 252
    labels32 = raw_ids | (np.uint32(7) << 16)
    inten = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    for i in range(3):
        moved = pts.copy()
        moved[:, 0] -= 0.4 * i
        np.concatenate([moved, inten], axis=1).astype(np.float32).tofile(
            str(d / "velodyne" / f"{i:06d}.bin"))
        labels32.tofile(str(d / "labels" / f"{i:06d}.label"))
    return str(d)


def _room(seed, half):
    return synth.room_scene(seed, half=half, floor_y=1.8, ceil_y=-3.0, n_pillars=4)


@pytest.fixture(scope="module")
def rendered_kitti_dir(tmp_path_factory):
    """3 frames of test_e2e_accuracy.py's lidar sequence (32 beams x 720,
    5 mm noise) with height-band SemanticKITTI labels, and its trajectory."""
    d = str(tmp_path_factory.mktemp("lidar_seq"))
    traj = synth.corridor_trajectory(3, step=0.15, yaw_rate=0.02, bob=0.0)
    synth.write_kitti_lidar_sequence(d, _room(11, 8.0), traj, n_beams=32, n_az=720,
                                     noise=0.005, labels=True)
    return d, traj


@pytest.fixture(scope="module")
def lyft_dir(tmp_path_factory):
    """3 sweeps of test_e2e_accuracy.py's Lyft sequence (40 beams x 720)."""
    d = str(tmp_path_factory.mktemp("lyft_seq"))
    traj = synth.corridor_trajectory(3, step=0.2, yaw_rate=0.02, bob=0.0)
    synth.write_lyft_lidar_sequence(d, _room(13, 9.0), traj, n_beams=40, n_az=720,
                                    noise=0.005)
    return d


@pytest.fixture(scope="module")
def hdl64_dir(tmp_path_factory):
    """3 frames of the lidar room at 64 beams x 1800 over the HDL-64
    elevations (-2 to 24.9 deg below level), LeGO-LOAM's geometry."""
    d = str(tmp_path_factory.mktemp("hdl64_seq"))
    traj = synth.corridor_trajectory(3, step=0.15, yaw_rate=0.02, bob=0.0)
    synth.write_kitti_lidar_sequence(d, _room(11, 8.0), traj, n_beams=64, n_az=1800,
                                     noise=0.005, fov_deg=(-2.0, 24.9))
    return d


def _yaml(tmp_path_factory, name, text):
    path = tmp_path_factory.mktemp("params") / name
    path.write_text(text)
    return str(path)


LIDAR_YAML = ("ell_init: 0.5\nell_init_first_frame: 0.8\nell_min: 0.05\n"
              "ell_max: 1.2\nis_using_intensity: 1\n")
SEMANTIC = "is_using_semantics: 1\ns_ell: 0.5\ns_sigma: 0.8\n"


@pytest.fixture(scope="module")
def lidar_yaml(tmp_path_factory):
    """test_e2e_accuracy.py's lidar YAML."""
    return _yaml(tmp_path_factory, "lidar.yaml", LIDAR_YAML)


@pytest.fixture(scope="module")
def semantic_yaml(tmp_path_factory):
    return _yaml(tmp_path_factory, "sem_lidar.yaml", LIDAR_YAML + SEMANTIC)


def _both(j_run, t_run, args, tmp_path, **kw):
    pj = j_run(*args[:2], str(tmp_path / "jax.txt"), log=_quiet, **kw)
    pt = t_run(*args[:2], str(tmp_path / "port.txt"), log=_quiet, device="cpu", **kw)
    assert pt.shape == pj.shape == (3, 4, 4)
    rows_j, rows_t = np.loadtxt(tmp_path / "jax.txt"), np.loadtxt(tmp_path / "port.txt")
    assert rows_t.shape == rows_j.shape == (3, 12)
    np.testing.assert_allclose(rows_t.reshape(-1, 3, 4), pt[:, :3, :4], atol=1e-8)
    gaps = [_gap(a, b) for a, b in zip(pj, pt)]
    assert max(gaps) < POSE_TOL, gaps
    return pt


RUN = dict(capacity=4096, chunk=2048, max_iter=300)


@pytest.mark.parametrize("semantic", [False, True], ids=["plain", "semantic"])
def test_kitti_lidar_driver_matches_jax(semantic, rendered_kitti_dir, lidar_yaml,
                                        semantic_yaml, tmp_path):
    d, traj = rendered_kitti_dir
    yaml = semantic_yaml if semantic else lidar_yaml
    pt = _both(j_lidar.run_sequence, t_lidar.run_sequence, (d, yaml), tmp_path,
               semantic=semantic, **RUN)
    # the corridor steps 0.15 m a frame
    assert 0.1 < np.linalg.norm(pt[2][:3, 3] - pt[1][:3, 3]) < 0.2, pt


@pytest.fixture(scope="module")
def velodyne_sweep_dir(tmp_path_factory):
    """The first 2 frames of rendered_kitti_dir's sequence with each beam
    sweeping azimuth the other way, as a velodyne does: ring_ids finds a
    ring at every 4 -> 1 quadrant wrap."""
    d = str(tmp_path_factory.mktemp("lidar_velodyne_sweep"))
    traj = synth.corridor_trajectory(2, step=0.15, yaw_rate=0.02, bob=0.0)
    synth.write_kitti_lidar_sequence(d, _room(11, 8.0), traj, n_beams=32, n_az=720,
                                     noise=0.005, velodyne_sweep=True)
    return d


def test_kitti_lidar_driver_matches_jax_on_a_velodyne_sweep(velodyne_sweep_dir, lidar_yaml,
                                                             tmp_path):
    from unified_cvo_tpu.frontend import lidar as j_fl
    from unified_cvo_tpu_torch.frontend import lidar as t_fl

    scan = KittiHandler(velodyne_sweep_dir, "lidar").read_next_lidar()
    rings = j_fl.ring_ids(scan[:, :3])
    assert rings.max() >= 30                  # 32 beams: a ring at each wrap
    np.testing.assert_array_equal(t_fl.ring_ids(torch.from_numpy(scan[:, :3])).numpy(), rings)
    pj = j_lidar.run_sequence(velodyne_sweep_dir, lidar_yaml, str(tmp_path / "jax.txt"),
                              log=_quiet, **RUN)
    pt = t_lidar.run_sequence(velodyne_sweep_dir, lidar_yaml, str(tmp_path / "port.txt"),
                              log=_quiet, device="cpu", **RUN)
    assert pt.shape == pj.shape == (2, 4, 4)
    gaps = [_gap(a, b) for a, b in zip(pj, pt)]
    assert max(gaps) < POSE_TOL, gaps
    # the corridor steps 0.15 m; the first pair (ell 0.8) ends ~0.1 m in both
    assert 0.05 < np.linalg.norm(pt[1][:3, 3]) < 0.25, pt


def test_lyft_driver_matches_jax(lyft_dir, lidar_yaml, tmp_path):
    pt = _both(j_lyft.run_sequence, t_lyft.run_sequence, (lyft_dir, lidar_yaml), tmp_path,
               **RUN)
    assert 0.15 < np.linalg.norm(pt[2][:3, 3] - pt[1][:3, 3]) < 0.25, pt


def test_semantic_driver_on_the_ground_and_wall_fixture(semantic_kitti_dir, semantic_yaml,
                                                        tmp_path):
    out = str(tmp_path / "sem_lidar_traj.txt")
    poses = t_lidar.run_sequence(semantic_kitti_dir, semantic_yaml, out, semantic=True,
                                 capacity=4096, chunk=1024, max_iter=60, log=_quiet,
                                 device="cpu")
    assert poses.shape == (3, 4, 4) and np.isfinite(poses).all()
    rows = np.loadtxt(out)
    assert rows.shape == (3, 12) and np.isfinite(rows).all()


@pytest.mark.parametrize("writer,width", [("write_kitti_lidar_sequence", 4),
                                          ("write_lyft_lidar_sequence", 5)])
def test_lidar_writers_at_their_defaults_write_jaxs_scans(writer, width, tmp_path):
    """Points equal; intensities within the textures' 1e-4 (of 255) that
    the copy's numpy upsampling leaves against cv2's (test_torch_odometry.py)."""
    from unified_cvo_tpu.utils import synth as j_synth

    traj = synth.corridor_trajectory(2, step=0.15, yaw_rate=0.02, bob=0.0)
    for name, mod in (("jax", j_synth), ("port", synth)):
        getattr(mod, writer)(str(tmp_path / name), mod.room_scene(11, half=8.0), traj,
                             n_beams=8, n_az=90, noise=0.005)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.bin"))
    assert len(files) == 2
    for f in files:
        want, got = (np.fromfile(tmp_path / side / f, np.float32).reshape(-1, width)
                     for side in ("jax", "port"))
        assert np.array_equal(got[:, :3], want[:, :3])
        np.testing.assert_allclose(got[:, 3:], want[:, 3:], rtol=0, atol=1e-6)


def test_lyft_reader_equals_jax(lyft_dir):
    a, b = j_lyft_ds.LyftHandler(lyft_dir), t_lyft_ds.LyftHandler(lyft_dir)
    assert a.names == b.names and len(b) == 3
    for _ in range(4):
        pa, pb = a.read_next_lidar(), b.read_next_lidar()
        assert (pa is None and pb is None) or np.array_equal(pa, pb)
        a.next()
        b.next()


@pytest.mark.parametrize("method", ["loam", "legoloam"])
def test_run_frames_in_memory_equals_run_sequence(method, hdl64_dir, lidar_yaml, tmp_path):
    d = hdl64_dir
    kw = dict(max_iter=SHORT_ITER, capacity=4096, chunk=2048, method=method, device="cpu",
              log=_quiet)
    pt = t_lidar.run_sequence(d, lidar_yaml, str(tmp_path / "port.txt"), **kw)
    kitti = KittiHandler(d, "lidar")
    scans = []
    for _ in range(3):
        scans.append(kitti.read_next_lidar())
        kitti.next()
    out = io.StringIO()
    poses, records = t_lidar.run_frames(iter(scans), read_cvo_params_yaml(lidar_yaml),
                                        out=out, **kw)
    np.testing.assert_array_equal(poses, pt)
    assert len(out.getvalue().splitlines()) == 2 and len(records) == 2
    for rec in records:
        assert rec.info.iterations == rec.info.host_reads > 0 and rec.ret == 0


def _printed(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _trajectory(n, seed):
    rng = np.random.default_rng(seed)
    T = np.tile(np.eye(4), (n, 1, 1))
    for i in range(1, n):
        a = rng.normal(0, 0.01, 3)
        R = t_lie.so3_exp(torch.from_numpy(a)).numpy()
        T[i, :3, :3] = T[i - 1, :3, :3] @ R
        T[i, :3, 3] = T[i - 1, :3, 3] + T[i - 1, :3, :3] @ np.array([0.0, 0.0, 1.5])
    return T


def test_evaluate_odometry_prints_jax_lines(tmp_path):
    gt_dir, res_dir = tmp_path / "gt", tmp_path / "res"
    gt_dir.mkdir()
    res_dir.mkdir()
    for seq, seed in (("00", 1), ("04", 2)):
        gt, est = _trajectory(300, seed), _trajectory(300, seed + 10)
        (gt_dir / seq).mkdir()
        for path, poses in ((gt_dir / seq / f"{seq}.txt", gt), (res_dir / f"{seq}.txt", est)):
            with open(path, "w") as f:
                for T in poses:
                    write_kitti_pose_row(f, T)
    (res_dir / "07.txt").write_text("")
    argv = [str(gt_dir), str(res_dir)]
    assert _printed(t_eval.main, argv) == _printed(j_eval.main, argv)
    rc, text = _printed(t_eval.main, argv)
    assert rc == 0 and "avg" in text and "missing" in text


@pytest.mark.parametrize("extra", [[], ["--scale", "--rpe", "--delta", "2"]])
def test_evaluate_ate_prints_jax_lines(tmp_path, extra):
    gt, est = _trajectory(40, 5), _trajectory(40, 6)
    for name, poses in (("gt.txt", gt), ("est.txt", est)):
        with open(tmp_path / name, "w") as f:
            for T in poses:
                write_kitti_pose_row(f, T)
    argv = [str(tmp_path / "gt.txt"), str(tmp_path / "est.txt"), *extra]
    rc, text = _printed(t_ate.main, argv)
    assert rc == 0 and "ate rmse" in text
    assert (rc, text) == _printed(j_ate.main, argv)


def _chip_phase(port: bool):
    """chip_smoke.py phase 13 on the CPU: its sequences through JAX's drivers
    (the LeGO-LOAM pair through JAX's frontend and align), and optionally
    the port's. Prints one line per run."""
    import os

    import chip_smoke
    from unified_cvo_tpu.config import read_cvo_params_yaml as j_read
    from unified_cvo_tpu.frontend.lidar import pointcloud_from_lidar as j_cloud
    from unified_cvo_tpu.models.align import align as j_align
    from unified_cvo_tpu_torch.apps import f2f_sequence as f2f
    from unified_cvo_tpu_torch.utils import metrics

    root = tempfile.mkdtemp(prefix="lidar_phase_")
    kdir, traj, ldir, ltraj = chip_smoke.lidar_sequences(root)
    yaml, sem_yaml = os.path.join(root, "lidar.yaml"), os.path.join(root, "semantic.yaml")
    cap, it = t_lidar.CAPACITY, chip_smoke.LIDAR_ITER

    def report(label, poses, tr):
        n = len(poses) - 1
        rel = [np.linalg.inv(poses[k]) @ poses[k + 1] for k in range(n)]
        true = [np.linalg.inv(tr[k + 1]) @ tr[k] for k in range(n)]
        errs = f2f.pose_errors(rel, true)
        print(f"{label}: pose errors {[round(float(e), 6) for e in errs]}, ATE "
              f"{metrics.ate_rmse(tr[:len(poses)], poses):.6f} m, RPE "
              f"{metrics.rpe_rmse(tr[:len(poses)], poses):.6f} m", flush=True)

    def legoloam_pair(build, align_fn, params, eye):
        reader = KittiHandler(kdir, "lidar")
        clouds = []
        for _ in range(2):
            clouds.append(build(reader.read_next_lidar()))
            reader.next()
        T = np.asarray(align_fn(clouds[0], clouds[1], eye, params.first_frame())[0], np.float64)
        return np.stack([np.eye(4), T])

    runs = [
        ("kitti", lambda pkg: pkg[0].run_sequence(kdir, yaml, os.path.join(root, "k.txt"),
                                                  max_iter=it, capacity=cap, log=_quiet,
                                                  **pkg[2]), traj),
        ("semantic", lambda pkg: pkg[0].run_sequence(kdir, sem_yaml, os.path.join(root, "s.txt"),
                                                     max_frames=2, max_iter=it, capacity=cap,
                                                     semantic=True, log=_quiet, **pkg[2]), traj),
        ("lyft", lambda pkg: pkg[1].run_sequence(ldir, yaml, os.path.join(root, "l.txt"),
                                                 max_iter=it, capacity=cap, log=_quiet,
                                                 **pkg[2]), ltraj),
    ]
    pkgs = [("JAX", (j_lidar, j_lyft, {}))]
    if port:
        pkgs.append(("port", (t_lidar, t_lyft, {"device": "cpu"})))
    got = {}
    for name, fn, tr in runs:
        for who, pkg in pkgs:
            t0 = time.perf_counter()
            got[name, who] = fn(pkg)
            report(f"{name} ({who}, {time.perf_counter() - t0:.1f} s)", got[name, who], tr)
    t0 = time.perf_counter()
    got["legoloam", "JAX"] = legoloam_pair(
        lambda s: j_cloud(s, capacity=cap, method="legoloam"),
        lambda a, b, g, p: j_align(a, b, g, p, max_iter=it), j_read(yaml), np.eye(4, dtype=np.float32))
    report(f"legoloam (JAX, {time.perf_counter() - t0:.1f} s)", got["legoloam", "JAX"], traj)
    if port:
        from unified_cvo_tpu_torch.frontend.lidar import pointcloud_from_lidar as t_cloud
        from unified_cvo_tpu_torch.models.align import align as t_align

        t0 = time.perf_counter()
        got["legoloam", "port"] = legoloam_pair(
            lambda s: t_cloud(s, capacity=cap, method="legoloam", device="cpu"),
            lambda a, b, g, p: t_align(a, b, torch.from_numpy(g), p, max_iter=it, device="cpu"),
            read_cvo_params_yaml(yaml), np.eye(4, dtype=np.float32))
        report(f"legoloam (port, {time.perf_counter() - t0:.1f} s)", got["legoloam", "port"],
               traj)
        for name in ("kitti", "semantic", "lyft", "legoloam"):
            gaps = [_gap(a, b) for a, b in zip(got[name, "JAX"], got[name, "port"])]
            print(f"{name}: the port's poses lie {[round(g, 6) for g in gaps]} from JAX's")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    _chip_phase("--port" in sys.argv[1:])
