"""The KITTI stereo apps on the host frontend's port against the JAX package
on the CPU, on test_apps_drivers.py's 3-frame stereo fixture (220 x 256,
constant disparity 8 px, +2 px a frame). kitti_odometry's cases are in
tests/test_torch_stereo_odometry.py, which shares this file's fixtures (a
file of their own, so that pytest-xdist runs them beside these).

- irls_kitti.main: the trajectories it writes, within 1e-4 of JAX's;
- depth_filtering.run: both PCDs equal (colours) and within 1e-5 m;
- indicator_sweep.main: the CSV rows equal.

Both packages' compute_disparity take cv2.StereoSGBM for "auto" where cv2
imports (the port its exact emulation, seconds a frame on the CPU), and the
native census-SGM where it does not. So the tests run both pipelines on
the native backend
(`jax_native_disparity` pins both packages' "auto" to it). indicator_sweep builds 32768-point clouds, whose
function angle the port's dense CPU path takes ~50 s for; the test builds
them at 2048 points in both packages (`small_sweep_clouds`).

kitti_odometry's fixture is chaotic mid-descent: at 60 iterations a pair
JAX's own poses move by up to 1.2e-2 (denoised) and 2.1e-2 (raw) when the
first guess moves by +-1e-6 m, and the port on one CPU thread ends 1.85e-2
(denoised) and 9.1e-3 (raw) from JAX. At 150 iterations the pairs have
converged: the port lies 1.3e-3 from JAX on the denoised frames. Run as a
script, it prints JAX's own spread on each kitti_odometry case at its
settings (the first pair's guess moved by +-1e-6 m along x and z) and the
port's gap to JAX (~3 minutes); with
`--chip`, each pair's pose error of JAX's driver on chip_smoke.py phase
15c's frames at 1241 x 376 (with `--port`, the port's on the CPU too; with
`--opencv`, phase 15e's pair, frames 0 -> 1 on the StereoSGBM backend):

    JAX_PLATFORMS=cpu python tests/test_torch_stereo_apps.py [--chip [--port] [--opencv]]
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

from unified_cvo_tpu.apps import depth_filtering as j_df
from unified_cvo_tpu.apps import indicator_sweep as j_sweep
from unified_cvo_tpu.apps import irls_kitti as j_irls
from unified_cvo_tpu.apps import kitti_odometry as j_kitti
from unified_cvo_tpu.frontend import pipeline as j_pipeline
from unified_cvo_tpu_torch.apps import depth_filtering as t_df
from unified_cvo_tpu_torch.apps import indicator_sweep as t_sweep
from unified_cvo_tpu_torch.apps import irls_kitti as t_irls
from unified_cvo_tpu_torch.apps import kitti_odometry as t_kitti
from unified_cvo_tpu_torch.datasets.graph import write_graph_file
from unified_cvo_tpu_torch.datasets.pcd import read_pcd
from unified_cvo_tpu_torch.frontend import stereo as t_stereo
from unified_cvo_tpu_torch.ops import lie as t_lie

torch.set_num_threads(1)

CPU = "cpu"
POSE_TOL = 5e-3
ODO = dict(capacity=1024, chunk=1024)
SWEEP_CAPACITY = 2048
N_CLASSES = 4


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


def write_kitti_fixture(d: Path) -> str:
    """test_apps_drivers.py's kitti_dir, with its semantic test's 4-class
    quadrant labels beside it."""
    (d / "image_2").mkdir()
    (d / "image_3").mkdir()
    (d / "image_semantic").mkdir()
    (d / "cvo_calib.txt").write_text("100.0 100.0 128.0 110.0 0.5 256 220")
    img = _texture(220, 256, seed=7)
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    onehot = np.eye(N_CLASSES, dtype=np.float32)[(2 * (yy > h // 2) + (xx > w // 2)).astype(int)]
    for i in range(3):
        left = np.roll(img, -2 * i, axis=1)
        cv2.imwrite(str(d / "image_2" / f"{i:06d}.png"), left)
        cv2.imwrite(str(d / "image_3" / f"{i:06d}.png"), np.roll(left, -8, axis=1))
        np.roll(onehot, -2 * i, axis=1).tofile(str(d / "image_semantic" / f"{i:06d}.bin"))
    return str(d)


def write_yaml(path: Path, voxel: float) -> str:
    path.write_text(
        "ell_init: 0.5\nell_init_first_frame: 0.5\nell_min: 0.05\n"
        "ell_max: 1.0\nmax_iter: 60\nis_using_intensity: 1\n"
        "multiframe_ell_init: 0.5\nmultiframe_ell_min: 0.15\n"
        "multiframe_ell_decay_rate: 0.7\nmultiframe_max_iters: 10\n"
        "multiframe_iterations_per_solve: 4\nmultiframe_min_nonzeros: 10\n"
        f"multiframe_downsample_voxel_size: {voxel}\n")
    return str(path)


def write_track(path: Path, step: float) -> str:
    rows = []
    for i in range(3):
        T = np.eye(3, 4)
        T[0, 3] = step * i
        rows.append(T.ravel())
    np.savetxt(path, np.asarray(rows))
    return str(path)


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    return write_kitti_fixture(tmp_path_factory.mktemp("kitti"))


@pytest.fixture(scope="module")
def fast_yaml(tmp_path_factory):
    return write_yaml(tmp_path_factory.mktemp("params") / "fast.yaml", 0.3)


@pytest.fixture(scope="module")
def coarse_yaml(tmp_path_factory):
    return write_yaml(tmp_path_factory.mktemp("params") / "coarse.yaml", 1.2)


def _native(compute_disparity):
    def native(left, right, max_disparity=128, backend="auto"):
        return compute_disparity(left, right, max_disparity, "native")
    return native


def pin_native():
    """Both packages' "auto" disparity on the native census-SGM, as on a
    machine without OpenCV."""
    j_pipeline.compute_disparity = _native(j_pipeline.compute_disparity)
    t_stereo.auto_backend = lambda: "native"


@pytest.fixture
def jax_native_disparity(monkeypatch, native_built):
    """JAX's stereo pipeline and the port's "auto" on the native census-SGM,
    as on a machine without OpenCV."""
    monkeypatch.setattr(j_pipeline, "compute_disparity", _native(j_pipeline.compute_disparity))
    monkeypatch.setattr(t_stereo, "auto_backend", lambda: "native")


CASES = {"defaults": dict(denoise=True, max_iter=150),
         "semantic": dict(denoise=False, semantic=True, num_classes=N_CLASSES, max_iter=150)}


def run_both(kitti_dir, yaml, out: Path, case: str):
    """(JAX's poses, the port's poses, the port's rows file) of one case."""
    kw = dict(log=_quiet, **ODO, **CASES[case])
    pj = j_kitti.run_sequence(kitti_dir, yaml, str(out / "jax.txt"), stereo_backend="native",
                              **kw)
    pt = t_kitti.run_sequence(kitti_dir, yaml, str(out / "port.txt"), device=CPU, **kw)
    return pj, pt, str(out / "port.txt")


def test_irls_kitti_matches_jax(kitti_dir, coarse_yaml, tmp_path, jax_native_disparity):
    graph = str(tmp_path / "graph.txt")
    write_graph_file(graph, [0, 1, 2], [(0, 1), (1, 2), (0, 2)])
    track = write_track(tmp_path / "track.txt", 0.11)
    gt = write_track(tmp_path / "gt.txt", 0.125)
    jp, tp = str(tmp_path / "jax"), str(tmp_path / "port")
    assert j_irls.main([kitti_dir, coarse_yaml, graph, jp, track, gt]) == 0
    assert t_irls.main([kitti_dir, coarse_yaml, graph, tp, track, gt], device=CPU,
                       log=_quiet) == 0
    for part in ("_before.txt", "_gt.txt"):
        np.testing.assert_array_equal(np.loadtxt(tp + part), np.loadtxt(jp + part))
    before, after = np.loadtxt(tp + "_before.txt"), np.loadtxt(tp + "_after.txt")
    assert after.shape == (3, 12) and np.abs(after[:, 3] - before[:, 3]).max() < 0.2
    assert np.abs(after - before).max() > 1e-3          # the solve moved the poses
    np.testing.assert_allclose(after, np.loadtxt(jp + "_after.txt"), atol=1e-4)


def test_depth_filtering_matches_jax(kitti_dir, coarse_yaml, tmp_path, jax_native_disparity):
    track = write_track(tmp_path / "track.txt", 0.125)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    assert j_df.run(kitti_dir, coarse_yaml, track, 0, 3, 1.0, 0.1, jd, frame_capacity=4096,
                    top_k=32) == 0
    assert t_df.run(kitti_dir, coarse_yaml, track, 0, 3, 1.0, 0.1, td, frame_capacity=4096,
                    top_k=32, device=CPU, log=_quiet) == 0
    for f in ("before_depth_filtering.pcd", "after_depth_filtering.pcd"):
        (xa, ca), (xb, cb) = (read_pcd(os.path.join(d, f)) for d in (td, jd))
        assert xa.shape == xb.shape and len(xa) > 0, f
        np.testing.assert_allclose(xa, xb, rtol=0, atol=1e-5, err_msg=f)
        np.testing.assert_array_equal(ca, cb, err_msg=f)
    z = read_pcd(os.path.join(td, "after_depth_filtering.pcd"))[0][:, 2]
    assert np.median(np.abs(z - 6.25)) < 1.0


@pytest.fixture
def small_sweep_clouds(monkeypatch):
    for mod in (j_sweep, t_sweep):
        build = mod.pointcloud_from_stereo
        monkeypatch.setattr(mod, "pointcloud_from_stereo",
                            lambda *a, _b=build, **k: _b(*a, **{**k, "capacity": SWEEP_CAPACITY}))


def test_indicator_sweep_matches_jax(kitti_dir, fast_yaml, tmp_path, jax_native_disparity,
                                     small_sweep_clouds):
    jc, tc = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    args = ["1.0", "0", "2", "1"]
    assert j_sweep.main([kitti_dir, fast_yaml, jc, *args]) == 0
    assert t_sweep.main([kitti_dir, fast_yaml, tc, *args], device=CPU, log=_quiet) == 0
    rows_t, rows_j = open(tc).read().splitlines(), open(jc).read().splitlines()
    assert rows_t == rows_j and len(rows_t) == 3
    assert all(0.0 < float(r.split(",")[1]) <= 1.0 for r in rows_t[1:])


def jax_kitti_spread():
    """JAX's kitti_odometry on each case, from the identity and with the
    first pair's guess moved by +-1e-6 m along x and z; the port once."""
    import tempfile

    from unified_cvo_tpu.apps import _odometry_common as j_common

    pin_native()
    align = j_common.align
    with tempfile.TemporaryDirectory() as root:
        root = Path(root)
        (root / "kitti").mkdir()
        d = write_kitti_fixture(root / "kitti")
        yaml = write_yaml(root / "fast.yaml", 0.3)
        for case in CASES:
            kw = dict(log=_quiet, stereo_backend="native", **ODO, **CASES[case])
            base, port, _ = run_both(d, yaml, root, case)
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
                    run = j_kitti.run_sequence(d, yaml, str(root / "m.txt"), **kw)
                finally:
                    j_common.align = align
                gaps["+-"[sign < 0] + "xyz"[axis]] = max(_gap(a, b) for a, b in zip(run, base))
            port_gap = max(_gap(a, b) for a, b in zip(port, base))
            print(f"{case}: JAX's spread over +-1e-6 m first guesses {gaps}; largest "
                  f"{max(gaps.values()):.3e}; the port's gap to JAX {port_gap:.3e} "
                  f"(tolerance {POSE_TOL})", flush=True)


def chip_phase_chain(port: bool, opencv: bool = False):
    """chip_smoke.py phase 15c's inputs through JAX's kitti_odometry on the
    CPU at the same settings (the host frontend at its defaults, JAX on its
    native census-SGM, the phase's YAML), and with
    `port` the port's driver on the CPU: each pair's pose error against the
    rendered trajectory and its relative pose as an se(3) log. With
    `opencv`, phase 15e's pair instead: frames 0 -> 1 on
    stereo_backend="opencv" (cv2.StereoSGBM in JAX)."""
    import tempfile

    import chip_smoke
    from unified_cvo_tpu_torch.apps import f2f_sequence as f2f

    if not opencv:
        pin_native()
    with tempfile.TemporaryDirectory() as root:
        _, runs = chip_smoke.write_stereo_host_inputs(root)
        if opencv:
            seq, yaml, _, traj = runs["phase 15c"]
            runs = {"phase 15e": (seq, yaml, {"max_frames": 2, "stereo_backend": "opencv"},
                                  traj[:2])}
        for label, (seq, yaml, kw, traj) in runs.items():
            packages = [("JAX", j_kitti)] + ([("port", t_kitti)] if port else [])
            for name, mod in packages:
                extra = ({"device": CPU} if name == "port" else
                         {} if opencv else {"stereo_backend": "native"})
                t0 = time.perf_counter()
                poses = mod.run_sequence(seq, yaml, os.path.join(root, "out.txt"), log=_quiet,
                                         **kw, **extra)
                rel = [np.linalg.inv(poses[k]) @ poses[k + 1] for k in range(len(poses) - 1)]
                true = [np.linalg.inv(traj[k + 1]) @ traj[k] for k in range(len(rel))]
                errs = f2f.pose_errors(rel, true)
                for k, (e, T) in enumerate(zip(errs, rel)):
                    xi = t_lie.se3_log(torch.from_numpy(T[:3, :3]), torch.from_numpy(T[:3, 3]))
                    print(f"{label} pair {k}, {name}: pose error {e:.6f}, log "
                          f"{np.array2string(xi.numpy(), precision=9, max_line_width=200)} "
                          f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    import time

    torch.set_num_threads(4)
    if "--chip" in sys.argv:
        chip_phase_chain("--port" in sys.argv, "--opencv" in sys.argv)
    else:
        jax_kitti_spread()
