"""The port's tools against the JAX package's on the CPU:

- utils/logging.py: `debug_nans` (a NaN-producing op raises
  FloatingPointError inside the context, not outside it, not for an Inf;
  `enable=False` turns an enclosing check off; the previous state comes
  back) and `profiler_trace` (a Chrome trace file; nothing with None);
- apps/evaluate_semantics.py: the confusion matrix, IoU, mean IoU and
  accuracy against JAX's on random labels with ignored and invalid ids
  (integers equal, floats equal); the CLI on .npy and on 8-bit grey, 16-bit
  grey and colour PNGs, against JAX's `_load` and printout;
- apps/viewer.py: PNGs of a trajectory and of two PCDs written in
  tmp_path, decoded pixels equal to JAX's viewer's; without matplotlib
  the functions raise ImportError naming it;
- apps/gicp_align_two.py: `gicp_align` on test_apps_drivers.py's surface
  fixture against JAX's (T and rmse within 1e-9 abs, the same iteration
  count), and its CLI on two PCDs;
- datasets/prefetch.py: `PrefetchLoader` and `read_npy` against JAX's
  native loader (native_built), and the KITTI velodyne and TartanAir
  readers that use them against JAX's readers.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from unified_cvo_tpu.apps import evaluate_semantics as j_sem
from unified_cvo_tpu.apps import gicp_align_two as j_gicp
from unified_cvo_tpu.apps import viewer as j_viewer
from unified_cvo_tpu.datasets import kitti as j_kitti
from unified_cvo_tpu.datasets import tartanair as j_tartan
from unified_cvo_tpu_torch.apps import evaluate_semantics as t_sem
from unified_cvo_tpu_torch.apps import gicp_align_two as t_gicp
from unified_cvo_tpu_torch.apps import viewer as t_viewer
from unified_cvo_tpu_torch.datasets import kitti as t_kitti
from unified_cvo_tpu_torch.datasets import prefetch
from unified_cvo_tpu_torch.datasets import tartanair as t_tartan
from unified_cvo_tpu_torch.datasets.pcd import write_pcd
from unified_cvo_tpu_torch.utils.logging import debug_nans, profiler_trace

torch.set_num_threads(1)

CPU = "cpu"


# ------------------------------------------------------------------ logging


def test_debug_nans_raises_inside_the_context_only():
    x = torch.tensor(-1.0)
    with debug_nans():
        with pytest.raises(FloatingPointError):
            torch.log(x) + 1
        assert torch.isinf(torch.tensor(1.0) / 0)             # an Inf alone passes
        with debug_nans(False):
            assert torch.isnan(torch.log(x) + 1)              # turned off inside
        with pytest.raises(FloatingPointError):               # and back on after
            torch.log(x)
        with debug_nans():                                    # nested: still on
            with pytest.raises(FloatingPointError):
                torch.sqrt(x)
        with pytest.raises(FloatingPointError):
            torch.sqrt(x)
    assert torch.isnan(torch.log(x) + 1)                      # off after the context
    assert torch.equal(torch.arange(3) * 2, torch.tensor([0, 2, 4]))


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with profiler_trace(str(tmp_path / "trace"), device=CPU) as path:
        torch.ones(1000).cumsum(0).sum()
    assert os.path.dirname(path) == str(tmp_path / "trace")
    text = open(path).read()
    assert os.path.getsize(path) > 100 and "traceEvents" in text and "cumsum" in text
    with profiler_trace(None) as nothing:
        torch.ones(3).sum()
    assert nothing is None
    assert os.listdir(tmp_path) == ["trace"]


# -------------------------------------------------------- evaluate_semantics


def _labels(seed, shape=(96, 128), num_classes=7):
    rng = np.random.default_rng(seed)
    gt = rng.integers(-1, num_classes + 2, shape)             # out of range both ways
    pred = np.where(rng.random(shape) < 0.6, gt, rng.integers(-2, num_classes + 3, shape))
    return gt, pred


@pytest.mark.parametrize("seed,ignore", [(0, ()), (1, (2,)), (2, (0, 5))])
def test_evaluate_semantics_matches_jax(seed, ignore):
    gt, pred = _labels(seed)
    gt[gt == 4] = 3                                           # a class absent from GT
    pred[pred == 4] = 3                                       # and from the prediction
    want = j_sem.evaluate(gt, pred, 7, ignore)
    got = t_sem.evaluate(gt, pred, 7, ignore, device=CPU)
    assert got["confusion"].dtype == torch.int64
    np.testing.assert_array_equal(got["confusion"].numpy(), want["confusion"])
    np.testing.assert_array_equal(got["iou"].numpy(), want["iou"])      # NaN where JAX's
    assert np.isnan(want["iou"][4])
    assert got["mean_iou"] == want["mean_iou"] and got["accuracy"] == want["accuracy"]
    conf = t_sem.confusion_matrix(torch.from_numpy(gt), torch.from_numpy(pred), 7, ignore,
                                  device=CPU)
    assert torch.equal(conf, got["confusion"])


@pytest.mark.parametrize("kind", ["npy", "gray8", "gray16", "colour"])
def test_evaluate_semantics_cli_matches_jax(kind, tmp_path, capsys):
    gt, pred = _labels(3, num_classes=19)
    paths = []
    for name, a in (("gt", gt), ("pred", pred)):
        a = np.clip(a, 0, 255)
        if kind == "npy":
            p = str(tmp_path / f"{name}.npy")
            np.save(p, a)
        else:
            p = str(tmp_path / f"{name}.png")
            if kind == "gray8":
                img = a.astype(np.uint8)
            elif kind == "gray16":
                img = (a * 257).astype(np.uint16)             # labels past 255
            else:                                             # blue keeps the labels
                img = np.stack([a, (a * 7) % 256, (a * 13) % 256], -1).astype(np.uint8)
            assert cv2.imwrite(p, img)
        paths.append(p)
        np.testing.assert_array_equal(t_sem._load(p), j_sem._load(p))
    args = paths + ["--num-classes", "19" if kind != "gray16" else "5200", "--ignore", "0"]
    assert j_sem.main(args) == 0
    want = capsys.readouterr().out
    assert t_sem.main(args, device=CPU) == 0
    assert capsys.readouterr().out == want and "mean IoU" in want


# -------------------------------------------------------------------- viewer


def _traj_file(path, n, step, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        T = np.eye(3, 4)
        T[:, 3] = [step * i + rng.normal(0, 0.01), 0.0, 0.5 * step * i]
        rows.append(T.ravel())
    np.savetxt(path, np.asarray(rows))
    return str(path)


def _pcd_files(tmp_path):
    rng = np.random.default_rng(4)
    a = str(tmp_path / "a.pcd")
    b = str(tmp_path / "b.pcd")
    xyz = rng.uniform(-2, 2, (400, 3)).astype(np.float32)
    write_pcd(a, xyz, rng.random((400, 3)).astype(np.float32))
    write_pcd(b, xyz + np.float32([0.1, 0.0, 0.05]))
    return [a, b]


def test_viewer_writes_jax_pictures(tmp_path):
    trajs = [_traj_file(tmp_path / "gt.txt", 30, 0.5, 0),
             _traj_file(tmp_path / "est.txt", 30, 0.48, 1)]
    pcds = _pcd_files(tmp_path)
    for tag, mod in (("jax", j_viewer), ("port", t_viewer)):
        mod.plot_trajectories(str(tmp_path / f"traj_{tag}.png"), trajs, labels=["gt", "est"])
        mod.plot_pcds(str(tmp_path / f"pcd_{tag}.png"), pcds)
    for name in ("traj", "pcd"):
        port, jax_ = (cv2.imread(str(tmp_path / f"{name}_{t}.png")) for t in ("port", "jax"))
        assert os.path.getsize(tmp_path / f"{name}_port.png") > 10000
        np.testing.assert_array_equal(port, jax_)
    assert t_viewer.main(["traj", str(tmp_path / "cli.png"), *trajs]) == 0
    assert os.path.getsize(tmp_path / "cli.png") > 10000


def test_viewer_names_matplotlib_where_it_is_absent(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    traj = _traj_file(tmp_path / "t.txt", 5, 0.5, 0)
    with pytest.raises(ImportError, match="matplotlib"):
        t_viewer.plot_trajectories(str(tmp_path / "t.png"), [traj])
    with pytest.raises(ImportError, match="matplotlib"):
        t_viewer.plot_pcds(str(tmp_path / "p.png"), _pcd_files(tmp_path))


# ---------------------------------------------------------------------- GICP


def _gicp_fixture():
    """test_apps_drivers.py::test_gicp_baseline_recovers_rigid_motion's
    surface and motion."""
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-4, 4, (400, 3)).astype(np.float64)
    xyz[:, 2] = 0.2 * np.sin(xyz[:, 0]) + 0.1 * xyz[:, 1]
    th = 0.05
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    t = np.array([0.1, -0.05, 0.02])
    return xyz, (xyz - t) @ R, R, t


@pytest.mark.parametrize("max_iter,k,max_corr", [(40, 12, 1.0), (8, 20, 2.0), (40, 6, 0.5)])
def test_gicp_matches_jax(max_iter, k, max_corr):
    xyz, tgt, R, t = _gicp_fixture()
    Tj, it_j, rmse_j = j_gicp.gicp_align(xyz, tgt, max_iter=max_iter, k=k, max_corr=max_corr)
    Tt, it_t, rmse_t = t_gicp.gicp_align(xyz, tgt, max_iter=max_iter, k=k, max_corr=max_corr,
                                         device=CPU)
    assert Tt.dtype == np.float64
    np.testing.assert_allclose(Tt, Tj, rtol=0, atol=1e-9)
    assert it_t == it_j and (it_j < max_iter or max_iter == 8)   # 8 stops at the cap
    np.testing.assert_allclose(rmse_t, rmse_j, rtol=0, atol=1e-9)      # both ~1e-13 at the fit
    if max_corr == 1.0:
        np.testing.assert_allclose(Tt[:3, :3], R, atol=5e-3)
        np.testing.assert_allclose(Tt[:3, 3], t, atol=2e-2)


def test_gicp_cli(tmp_path, capsys):
    xyz, tgt, _, _ = _gicp_fixture()
    a, b = str(tmp_path / "s.pcd"), str(tmp_path / "t.pcd")
    write_pcd(a, xyz.astype(np.float32))
    write_pcd(b, tgt.astype(np.float32))
    assert t_gicp.main([a, b, "--max-iter", "20", "--k", "12", "--max-corr", "1.0"],
                       device=CPU) == 0
    out = capsys.readouterr().out
    assert "GICP baseline: 400 fixed, 400 moving" in out and "Transform is" in out


# ------------------------------------------------------------------ prefetch


def _velodyne_dir(d, n=3, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(d / "velodyne")
    for i in range(n):
        rng.normal(0, 10, (1000 + 37 * i, 4)).astype(np.float32).tofile(
            str(d / "velodyne" / f"{i:06d}.bin"))
    (d / "cvo_calib.txt").write_text("100.0 100.0 128.0 110.0 0.5 256 220")
    return str(d)


def test_prefetch_loader_matches_jax_native(tmp_path, native_built):
    from unified_cvo_tpu import native

    seq = _velodyne_dir(tmp_path)
    bins = sorted(str(p) for p in (tmp_path / "velodyne").iterdir())
    rng = np.random.default_rng(1)
    npys = []
    for dt in (np.float32, np.float64, np.uint8, np.int64, np.int16):
        p = str(tmp_path / f"a_{np.dtype(dt).name}.npy")
        np.save(p, (rng.random((7, 5, 3)) * 100).astype(dt))
        npys.append(p)
    jl, tl = native.PrefetchLoader(2), prefetch.PrefetchLoader(2)
    jobs = [(p, 0) for p in bins] + [(p, 1) for p in npys]
    tickets = [(jl.submit(p, kind), tl.submit(p, kind)) for p, kind in jobs]
    for (p, kind), (tj, tt) in zip(reversed(jobs), reversed(tickets)):
        want, got = jl.get(tj), tl.get(tt)
        assert got.dtype == want.dtype and got.shape == want.shape, p
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.fromfile(p, np.float32) if kind == 0
                                      else native.read_npy(p))
        np.testing.assert_array_equal(prefetch.read_npy(p) if kind == 1 else got, want)
    with pytest.raises(IOError):
        tl.get(tickets[0][1])                                  # handed over once
    with pytest.raises(IOError):
        tl.get(tl.submit(str(tmp_path / "missing.bin"), tl.RAW_F32))
    jl.close()
    tl.close()
    assert seq


def test_kitti_velodyne_reader_matches_jax(tmp_path, native_built):
    seq = _velodyne_dir(tmp_path, n=4, seed=2)
    hj, ht = j_kitti.KittiHandler(seq, "lidar"), t_kitti.KittiHandler(seq, "lidar")
    n = 0
    while True:
        a, b = hj.read_next_lidar(), ht.read_next_lidar()
        if a is None:
            assert b is None
            break
        np.testing.assert_array_equal(b, a)
        assert len(ht._pending) == (1 if ht.curr_index + 1 < len(ht) else 0)
        hj.next()
        ht.next()
        n += 1
    assert n == 4


def test_tartanair_readers_match_jax(tmp_path, native_built):
    rng = np.random.default_rng(5)
    for sub in ("image_left", "depth_left", "seg_left"):
        os.makedirs(tmp_path / sub)
    for i in range(2):
        cv2.imwrite(str(tmp_path / "image_left" / f"{i:06d}_left.png"),
                    rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
        np.save(str(tmp_path / "depth_left" / f"{i:06d}_left_depth.npy"),
                rng.uniform(0.5, 20, (48, 64)).astype(np.float32))
        np.save(str(tmp_path / "seg_left" / f"{i:06d}_left_seg.npy"),
                rng.integers(0, 12, (48, 64)).astype(np.uint8))
    hj, ht = j_tartan.TartanAirHandler(str(tmp_path)), t_tartan.TartanAirHandler(str(tmp_path))
    for _ in range(2):
        for a, b in zip(hj.read_next_rgbd_semantic(8), ht.read_next_rgbd_semantic(8)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)
        hj.next()
        ht.next()
    assert hj.read_next_rgbd() is None and ht.read_next_rgbd() is None
