"""The bundle-adjustment apps, their helpers and the TartanAir driver of the
port against the JAX package on the CPU.

- utils/voxel.py::voxel_downsample_indices, the graph file round trip
  (datasets/graph.py, each package reading what the other wrote),
  apps/_ba_common.py::downsample_edge_surface and read_pose_rows_subset:
  equal to JAX's;
- the TartanAir reader (datasets/tartanair.py) gives JAX's arrays, and
  synth.write_tartan_sequence writes what JAX's writes;
- irls_bunny after tests/test_irls.py::test_irls_bunny_random_recovers_poses
  (its bounds: 0.02 rad, 0.05 m a frame), its poses within 5e-3 of JAX's app
  on the same cloud;
- irls_tartan --translation-only and covis_tartan after
  test_apps_drivers.py:77 and :101 (same fixture, YAMLs and checks), the
  trajectories against JAX's within 5e-3;
- tartan_odometry after test_apps_drivers.py:63, at its default frontend
  (FAST after OpenCV's NL-means, the exact port), each pose within 5e-3 of
  JAX's.

Run as a script, it prints JAX's own spread on the tartan_odometry case:
how far JAX's poses move when the first pair's guess moves by +-1e-6 m
along x and z, beside the port's gap to JAX (about two minutes):

    JAX_PLATFORMS=cpu python tests/test_torch_ba_apps.py
"""

import os
import sys
from pathlib import Path

if __name__ == "__main__":      # as a script: the repo root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import cv2
import numpy as np
import pytest
import torch

from unified_cvo_tpu.apps import _ba_common as j_ba
from unified_cvo_tpu.apps import covis_tartan as j_covis
from unified_cvo_tpu.apps import irls_bunny as j_bunny
from unified_cvo_tpu.apps import irls_tartan as j_irls_tartan
from unified_cvo_tpu.apps import tartan_odometry as j_tartan
from unified_cvo_tpu.datasets import graph as j_graph
from unified_cvo_tpu.datasets import tartanair as j_tartan_ds
from unified_cvo_tpu.utils import pointcloud as j_pc
from unified_cvo_tpu.utils import synth as j_synth
from unified_cvo_tpu.utils import voxel as j_voxel
from unified_cvo_tpu_torch.apps import _ba_common as t_ba
from unified_cvo_tpu_torch.apps import covis_tartan as t_covis
from unified_cvo_tpu_torch.apps import irls_bunny as t_bunny
from unified_cvo_tpu_torch.apps import irls_tartan as t_irls_tartan
from unified_cvo_tpu_torch.apps import tartan_odometry as t_tartan
from unified_cvo_tpu_torch.datasets import graph as t_graph
from unified_cvo_tpu_torch.datasets import tartanair as t_tartan_ds
from unified_cvo_tpu_torch.datasets.pcd import read_pcd
from unified_cvo_tpu_torch.ops import lie as t_lie
from unified_cvo_tpu_torch.utils import pointcloud as t_pc
from unified_cvo_tpu_torch.utils import synth as t_synth
from unified_cvo_tpu_torch.utils import voxel as t_voxel

torch.set_num_threads(1)

CPU = "cpu"
POSE_TOL = 5e-3


def _quiet(*a):
    pass


def _gap(A, B):
    E = np.linalg.inv(A) @ B
    xi = t_lie.se3_log(torch.from_numpy(E[:3, :3]), torch.from_numpy(E[:3, 3]))
    return float(torch.linalg.vector_norm(xi))


def _xyzq_poses(path):
    from scipy.spatial.transform import Rotation

    rows = np.atleast_2d(np.loadtxt(path))
    T = np.tile(np.eye(4), (len(rows), 1, 1))
    T[:, :3, 3] = rows[:, :3]
    T[:, :3, :3] = Rotation.from_quat(rows[:, 3:7]).as_matrix()
    return T


# ------------------------------------------------------------- helpers


@pytest.mark.parametrize("voxel", [0.0, 0.05, 0.3, 1.2])
def test_voxel_downsample_indices_match_jax(voxel):
    rng = np.random.default_rng(3)
    xyz = (rng.normal(size=(3000, 3)) * [2.0, 0.5, 4.0]).astype(np.float32)
    np.testing.assert_array_equal(t_voxel.voxel_downsample_indices(xyz, voxel),
                                  j_voxel.voxel_downsample_indices(xyz, voxel))
    feats = rng.uniform(size=(3000, 5)).astype(np.float32)
    for a, b in zip(t_voxel.voxel_downsample(xyz, voxel, feats, None),
                    j_voxel.voxel_downsample(xyz, voxel, feats, None)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("with_poses", [False, True])
def test_graph_files_round_trip_between_packages(with_poses, tmp_path):
    rng = np.random.default_rng(4)
    frames = [3, 7, 11, 20]
    edges = [(0, 1), (1, 2), (2, 3), (0, 3)]
    poses = rng.normal(size=(4, 3, 4)) if with_poses else None
    for writer, reader in ((t_graph.write_graph_file, j_graph.read_graph_file),
                           (j_graph.write_graph_file, t_graph.read_graph_file),
                           (t_graph.write_graph_file, t_graph.read_graph_file)):
        path = str(tmp_path / "graph.txt")
        writer(path, frames, edges, poses)
        want = j_graph.read_graph_file(path)
        got = reader(path)
        assert got[0] == want[0] == frames and got[1] == want[1] == edges
        if with_poses:
            np.testing.assert_array_equal(got[2], want[2])
            np.testing.assert_allclose(got[2], poses, rtol=1e-8)
        else:
            assert got[2] is None


def test_downsample_edge_surface_matches_jax():
    rng = np.random.default_rng(5)
    e_xyz = rng.uniform(-2, 2, size=(900, 3)).astype(np.float32)
    f_xyz = rng.uniform(-2, 2, size=(2500, 3)).astype(np.float32)
    e_f = rng.uniform(size=(900, 5)).astype(np.float32)
    f_f = rng.uniform(size=(2500, 5)).astype(np.float32)
    j_out = j_ba.downsample_edge_surface(
        j_pc.make_pointcloud(e_xyz, features=e_f, bucket=64),
        j_pc.make_pointcloud(f_xyz, features=f_f, bucket=64), 0.1, 0.4)
    t_out = t_ba.downsample_edge_surface(
        t_pc.make_pointcloud(e_xyz, features=e_f, bucket=64, device=CPU),
        t_pc.make_pointcloud(f_xyz, features=f_f, bucket=64, device=CPU), 0.1, 0.4,
        device=CPU)
    for name in ("xyz", "mask", "features", "geometric_types"):
        np.testing.assert_array_equal(getattr(t_out, name).numpy(),
                                      np.asarray(getattr(j_out, name)), err_msg=name)


def test_read_pose_rows_subset_and_writers_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    rows = rng.normal(size=(9, 12))
    path = str(tmp_path / "poses.txt")
    np.savetxt(path, rows)
    np.testing.assert_array_equal(t_ba.read_pose_rows_subset(path, [0, 4, 8]),
                                  j_ba.read_pose_rows_subset(path, [0, 4, 8]))
    poses = t_ba.read_pose_rows_subset(path, list(range(9)))
    R = np.linalg.qr(rng.normal(size=(9, 3, 3)))[0]
    poses[:, :, :3] = R * np.sign(np.linalg.det(R))[:, None, None]
    for name in ("write_kitti_traj", "write_xyzq_traj"):
        getattr(t_ba, name)(str(tmp_path / "t.txt"), poses)
        getattr(j_ba, name)(str(tmp_path / "j.txt"), poses)
        assert open(tmp_path / "t.txt").read() == open(tmp_path / "j.txt").read()


# ------------------------------------------------------------- irls_bunny


def test_irls_bunny_recovers_poses_and_matches_jax(monkeypatch):
    """test_irls.py's bounds on the app's own fixture (3 frames of the
    1024-point synthetic bunny, twist sigma 0.1)."""
    j_out = {}
    solve = j_bunny.irls.irls_solve

    def keep(*a, **kw):
        j_out["poses"], hist = solve(*a, **kw)
        return j_out["poses"], hist

    monkeypatch.setattr(j_bunny.irls, "irls_solve", keep)
    assert j_bunny.main(["-", "3", "0.1"]) == 0
    base = t_bunny.synthetic_bunny()
    np.testing.assert_array_equal(base, j_bunny.synthetic_bunny())
    poses, true_poses, _ = t_bunny.bunny_ba(base, 3, 0.1, log=_quiet, device=CPU)
    for ang, dt in t_bunny.pose_errors(poses, true_poses):
        assert ang < 0.02 and dt < 0.05, (ang, dt)
    h = np.array([[0, 0, 0, 1.0]])
    for a, b in zip(poses, np.asarray(j_out["poses"])):
        assert _gap(np.vstack([a, h]), np.vstack([b, h])) < POSE_TOL
    assert t_bunny.main(["-", "2", "0.05"], device=CPU) == 0


# ------------------------------------------------------------- TartanAir


def _texture(h, w, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h // 8, w // 8), np.uint8)
    img = np.kron(base, np.ones((8, 8), np.uint8))
    return np.stack([img] * 3, axis=-1)


def write_tartan_plane(d):
    """test_apps_drivers.py's 3-frame constant-depth (z=3) textured scene;
    the camera translates +x by 5 px a frame (0.046875 m)."""
    (d / "image_left").mkdir()
    (d / "depth_left").mkdir()
    img = _texture(480, 640, seed=11)
    depth = np.full((480, 640), 3.0, np.float32)
    for i in range(3):
        cv2.imwrite(str(d / "image_left" / f"{i:06d}_left.png"), np.roll(img, -5 * i, axis=1))
        np.save(str(d / "depth_left" / f"{i:06d}_left_depth.npy"), depth)
    return str(d)


@pytest.fixture(scope="module")
def tartan_dir(tmp_path_factory):
    return write_tartan_plane(tmp_path_factory.mktemp("tartan"))


def _write_yaml(path, voxel):
    """test_apps_drivers.py's `_write_yaml`."""
    path.write_text(
        "ell_init: 0.5\nell_init_first_frame: 0.5\nell_min: 0.05\n"
        "ell_max: 1.0\nmax_iter: 60\nis_using_intensity: 1\n"
        "multiframe_ell_init: 0.5\nmultiframe_ell_min: 0.15\n"
        "multiframe_ell_decay_rate: 0.7\nmultiframe_max_iters: 10\n"
        "multiframe_iterations_per_solve: 4\nmultiframe_min_nonzeros: 10\n"
        f"multiframe_downsample_voxel_size: {voxel}\n"
    )
    return str(path)


@pytest.fixture(scope="module")
def fast_params_yaml(tmp_path_factory):
    return _write_yaml(tmp_path_factory.mktemp("params") / "fast.yaml", 0.3)


@pytest.fixture(scope="module")
def coarse_params_yaml(tmp_path_factory):
    return _write_yaml(tmp_path_factory.mktemp("params") / "coarse.yaml", 1.2)


def test_tartanair_reader_and_writer_match_jax(tartan_dir, tmp_path):
    j_h, t_h = j_tartan_ds.TartanAirHandler(tartan_dir), t_tartan_ds.TartanAirHandler(tartan_dir)
    assert len(t_h) == len(j_h) == 3 and t_h.names == j_h.names
    for i in range(3):
        j_h.set_start_index(i)
        t_h.set_start_index(i)
        for a, b in zip(t_h.read_next_rgbd(), j_h.read_next_rgbd()):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    t_h.set_start_index(3)
    assert t_h.read_next_rgbd() is None
    c_t, c_j = t_h.calibration(), j_h.calibration()
    np.testing.assert_array_equal(c_t.intrinsic, c_j.intrinsic)
    assert (c_t.depth_scale, c_t.cols, c_t.rows) == (c_j.depth_scale, c_j.cols, c_j.rows)
    # the writers: one rendered frame each, read back by JAX's reader
    scene = j_synth.corridor_scene(9, half_width=3.0, floor_y=1.4, ceil_y=-1.6, length=30.0)
    traj = j_synth.corridor_trajectory(1, step=0.1)
    j_synth.write_tartan_sequence(str(tmp_path / "j"), scene, traj)
    t_synth.write_tartan_sequence(str(tmp_path / "t"), scene, traj)
    a = j_tartan_ds.TartanAirHandler(str(tmp_path / "t")).read_next_rgbd()
    b = j_tartan_ds.TartanAirHandler(str(tmp_path / "j")).read_next_rgbd()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_tartan_odometry_matches_jax(tartan_dir, fast_params_yaml, tmp_path):
    kw = dict(max_iter=60, capacity=2048, chunk=1024, log=_quiet)
    j_poses = j_tartan.run_sequence(tartan_dir, fast_params_yaml, str(tmp_path / "j.txt"), **kw)
    out = str(tmp_path / "t.txt")
    records = []
    poses = t_tartan.run_sequence(tartan_dir, fast_params_yaml, out, device=CPU,
                                  records=records, **kw)
    assert poses.shape[0] == 3 and len(records) == 2
    rows = np.loadtxt(out)
    assert rows.shape == (3, 7)
    t1 = poses[1][:3, 3]
    assert 0.01 < np.linalg.norm(t1) < 0.15, t1
    gaps = [_gap(a, b) for a, b in zip(poses, j_poses)]
    assert max(gaps) < POSE_TOL, gaps
    np.testing.assert_allclose(_xyzq_poses(out), poses, atol=1e-5)   # 9 digits a row


def test_irls_tartan_translation_only_matches_jax(tartan_dir, fast_params_yaml, tmp_path):
    graph = str(tmp_path / "graph.txt")
    init = np.tile(np.eye(3, 4, dtype=np.float64), (3, 1, 1))
    init[1, 0, 3] = 0.03
    init[2, 0, 3] = 0.07
    t_graph.write_graph_file(graph, [0, 1, 2], [(0, 1), (1, 2), (0, 2)],
                             np.concatenate([init, np.tile([[[0, 0, 0, 1.0]]], (3, 1, 1))], 1))
    prefix, j_prefix = str(tmp_path / "ba"), str(tmp_path / "jax")
    assert j_irls_tartan.main([tartan_dir, fast_params_yaml, graph, j_prefix,
                               "--translation-only"]) == 0
    rc = t_irls_tartan.main([tartan_dir, fast_params_yaml, graph, prefix,
                             "--translation-only"], device=CPU, log=_quiet)
    assert rc == 0
    before = np.loadtxt(prefix + "_before.txt")
    after = np.loadtxt(prefix + "_after.txt")
    assert before.shape == after.shape == (3, 7)
    np.testing.assert_allclose(after[:, 3:6], 0.0, atol=1e-6)
    np.testing.assert_allclose(after[:, 6], 1.0, atol=1e-6)
    np.testing.assert_allclose(after[0, :3], 0.0, atol=1e-8)
    gaps = [_gap(a, b) for a, b in zip(_xyzq_poses(prefix + "_after.txt"),
                                       _xyzq_poses(j_prefix + "_after.txt"))]
    assert max(gaps) < POSE_TOL, gaps


def test_covis_tartan_matches_jax(tartan_dir, coarse_params_yaml, tmp_path):
    graph = str(tmp_path / "graph.txt")
    t_graph.write_graph_file(graph, [0, 1, 2], [(0, 1), (1, 2)])
    out_dir, j_dir = str(tmp_path / "covis"), str(tmp_path / "jax")
    assert j_covis.main([tartan_dir, coarse_params_yaml, graph, "1", j_dir]) == 0
    assert t_covis.main([tartan_dir, coarse_params_yaml, graph, "1", out_dir],
                        device=CPU, log=_quiet) == 0
    for f in ["before_BA.pcd", "after_BA.pcd", "traj_before.txt",
              "traj_after.txt", "0.pcd", "1.pcd", "2.pcd"]:
        assert os.path.exists(os.path.join(out_dir, f)), f
    for f in ["0.pcd", "1.pcd", "2.pcd", "before_BA.pcd"]:
        (xa, ca), (xb, cb) = (read_pcd(os.path.join(d, f)) for d in (out_dir, j_dir))
        np.testing.assert_array_equal(xa, xb, err_msg=f)
        np.testing.assert_array_equal(ca, cb, err_msg=f)
    gaps = [_gap(a, b) for a, b in zip(_xyzq_poses(os.path.join(out_dir, "traj_after.txt")),
                                       _xyzq_poses(os.path.join(j_dir, "traj_after.txt")))]
    assert max(gaps) < POSE_TOL, gaps


def jax_tartan_spread():
    """JAX's tartan_odometry on the test's case, from the identity and with
    the first pair's guess moved by +-1e-6 m along x and z; the port once."""
    import tempfile

    from unified_cvo_tpu.apps import _odometry_common as j_common

    kw = dict(max_iter=60, capacity=2048, chunk=1024, log=_quiet)
    align = j_common.align
    with tempfile.TemporaryDirectory() as root:
        root = Path(root)
        (root / "tartan").mkdir()
        d = write_tartan_plane(root / "tartan")
        yaml = _write_yaml(root / "fast.yaml", 0.3)
        base = j_tartan.run_sequence(d, yaml, str(root / "j.txt"), **kw)
        gaps = {}
        for axis, sign in ((0, 1), (0, -1), (2, 1), (2, -1)):
            calls = []

            def moved(src, tgt, guess, *a, **k):
                if not calls:
                    guess = guess.at[axis, 3].add(sign * 1e-6)
                calls.append(1)
                return align(src, tgt, guess, *a, **k)

            j_common.align = moved
            try:
                run = j_tartan.run_sequence(d, yaml, str(root / "m.txt"), **kw)
            finally:
                j_common.align = align
            gaps["+-"[sign < 0] + "xyz"[axis]] = max(_gap(a, b) for a, b in zip(run, base))
        port = t_tartan.run_sequence(d, yaml, str(root / "t.txt"), device=CPU, **kw)
        port_gap = max(_gap(a, b) for a, b in zip(port, base))
    print(f"JAX's spread over +-1e-6 m first guesses: {gaps}; largest "
          f"{max(gaps.values()):.3e}; the port's gap to JAX {port_gap:.3e} "
          f"(tolerance {POSE_TOL})")


if __name__ == "__main__":
    jax_tartan_spread()
