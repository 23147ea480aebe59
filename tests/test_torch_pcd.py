"""The PCD reader and writer and the two-cloud demo of the port against the
JAX package on the CPU.

- read_pcd of the port and of JAX give the same arrays on ASCII files
  (the port's write_pcd, with and without colour) and on binary files
  (packed-float and packed-uint colour, a float64 field and a 2-count
  field), and write_pcd writes JAX's bytes.
- load_demo_cloud builds JAX's padded cloud.
- align_two_pcd on a small colour pair: the port's transform within
  |log dT| < 5e-3 of the one JAX's demo applied (read back from its
  after_align.pcd), function_angle before and after within 1e-4 of the
  values JAX prints, and the angle grows.
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from unified_cvo_tpu.apps import align_two_pcd as j_demo
from unified_cvo_tpu.datasets import pcd as j_pcd
from unified_cvo_tpu.utils.pointcloud import to_numpy_valid as j_valid
from unified_cvo_tpu_torch.apps import align_two_pcd as t_demo
from unified_cvo_tpu_torch.datasets import pcd as t_pcd
from unified_cvo_tpu_torch.ops import lie as t_lie
from unified_cvo_tpu_torch.utils.pointcloud import to_numpy_valid as t_valid

torch.set_num_threads(1)

POSE_TOL = 5e-3
ANGLE_TOL = 1e-4
DEMO_ITER = 100


def _coloured(n, seed):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (n, 3)).astype(np.float32) / 255.0
    return xyz, rgb


@pytest.mark.parametrize("with_rgb", [True, False])
def test_ascii_round_trip_equals_jax(tmp_path, with_rgb):
    xyz, rgb = _coloured(200, 1)
    rgb = rgb if with_rgb else None
    t_pcd.write_pcd(str(tmp_path / "t.pcd"), xyz, rgb)
    j_pcd.write_pcd(str(tmp_path / "j.pcd"), xyz, rgb)
    assert (tmp_path / "t.pcd").read_bytes() == (tmp_path / "j.pcd").read_bytes()
    got, want = t_pcd.read_pcd(str(tmp_path / "t.pcd")), j_pcd.read_pcd(str(tmp_path / "t.pcd"))
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[0], xyz)
    if with_rgb:
        assert np.array_equal(got[1], want[1])
        np.testing.assert_allclose(got[1], rgb, atol=1 / 255)
    else:
        assert got[1] is None and want[1] is None


def _binary_pcd(path, fields, sizes, types, counts, arr):
    n = len(arr)
    head = ("# .PCD v0.7\nVERSION 0.7\n"
            f"FIELDS {' '.join(fields)}\nSIZE {' '.join(map(str, sizes))}\n"
            f"TYPE {' '.join(types)}\nCOUNT {' '.join(map(str, counts))}\n"
            f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA binary\n")
    with open(path, "wb") as f:
        f.write(head.encode("ascii"))
        f.write(arr.tobytes())


@pytest.mark.parametrize("rgb_type", ["F", "U"])
def test_binary_files_read_as_jax_reads_them(tmp_path, rgb_type):
    xyz, rgb = _coloured(300, 2)
    packed = ((np.round(rgb * 255).astype(np.uint32) << np.uint32(16))[:, 0]
              | (np.round(rgb * 255).astype(np.uint32)[:, 1] << np.uint32(8))
              | np.round(rgb * 255).astype(np.uint32)[:, 2])
    dt = np.dtype([("x", "f4"), ("y", "f4"), ("z", "f8"), ("normal", "f4", (2,)),
                   ("rgb", "f4" if rgb_type == "F" else "u4")])
    arr = np.zeros(len(xyz), dt)
    arr["x"], arr["y"], arr["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    arr["normal"] = 1.5
    arr["rgb"] = packed.view(np.float32) if rgb_type == "F" else packed
    path = str(tmp_path / "b.pcd")
    _binary_pcd(path, ["x", "y", "z", "normal", "rgb"], [4, 4, 8, 4, 4],
                ["F", "F", "F", "F", rgb_type], [1, 1, 1, 2, 1], arr)
    got, want = t_pcd.read_pcd(path), j_pcd.read_pcd(path)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert np.array_equal(got[0], xyz)
    np.testing.assert_allclose(got[1], rgb, atol=1 / 255)


def test_load_demo_cloud_equals_jax(tmp_path):
    xyz, rgb = _coloured(700, 3)
    path = str(tmp_path / "c.pcd")
    t_pcd.write_pcd(path, xyz, rgb)
    got = t_pcd.load_demo_cloud(path, device="cpu")
    want = j_pcd.load_demo_cloud(path)
    assert got.capacity == int(want.xyz.shape[0]) == 768
    a, b = t_valid(got), j_valid(want)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def _demo_pair(tmp_path):
    """A textured box corner (three planes, 640 points) and the same
    corner seen after a small motion."""
    rng = np.random.default_rng(4)
    n = 640
    u, v = rng.uniform(0, 2, (2, n))
    side = np.arange(n) % 3
    xyz = np.zeros((n, 3))
    for s in range(3):
        m = side == s
        xyz[m, s] = 0.0
        xyz[m, (s + 1) % 3] = u[m]
        xyz[m, (s + 2) % 3] = v[m]
    xyz = xyz.astype(np.float32)
    colour = 0.5 + 0.5 * np.sin(3.0 * xyz + np.arange(3))
    R = t_lie.so3_exp(torch.tensor([0.02, -0.03, 0.04], dtype=torch.float64)).numpy()
    t = np.array([0.05, -0.04, 0.06])
    moved = ((xyz - t) @ R).astype(np.float32)     # R moved + t = xyz
    src, tgt = str(tmp_path / "source.pcd"), str(tmp_path / "target.pcd")
    t_pcd.write_pcd(src, xyz, colour)
    t_pcd.write_pcd(tgt, moved, colour)
    yaml = tmp_path / "demo.yaml"
    yaml.write_text("ell_init: 0.5\nell_init_first_frame: 0.5\nell_min: 0.05\n"
                    "ell_max: 1.0\nis_using_intensity: 1\n")
    return src, tgt, str(yaml)


def test_align_two_pcd_matches_jax(tmp_path, monkeypatch):
    src, tgt, yaml = _demo_pair(tmp_path)
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    monkeypatch.chdir(jax_dir)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert j_demo.main([src, tgt, yaml, "-1", str(DEMO_ITER)]) == 0
    cos_j = [float(x) for x in re.search(r"before (\S+) after (\S+)", buf.getvalue()).groups()]
    # JAX's transform, read back from the target it moved
    tx, _ = j_pcd.read_pcd(tgt)
    moved, _ = j_pcd.read_pcd(str(jax_dir / "after_align.pcd"))
    A = np.concatenate([tx, np.ones((len(tx), 1), np.float32)], 1).astype(np.float64)
    X = np.linalg.lstsq(A, moved[len(moved) - len(tx):].astype(np.float64), rcond=None)[0]
    T_j = np.eye(4)
    T_j[:3, :3], T_j[:3, 3] = X[:3].T, X[3]

    port_dir = tmp_path / "port"
    port_dir.mkdir()
    out = t_demo.align_two(src, tgt, yaml, max_iter=DEMO_ITER, out_dir=str(port_dir),
                           log=lambda *a: None, device="cpu")
    E = np.linalg.inv(T_j) @ out["T"].astype(np.float64)
    gap = float(torch.linalg.vector_norm(t_lie.se3_log(torch.from_numpy(E[:3, :3]),
                                                       torch.from_numpy(E[:3, 3]))))
    assert gap < POSE_TOL, gap
    assert abs(out["cos_before"] - cos_j[0]) < ANGLE_TOL
    assert abs(out["cos_after"] - cos_j[1]) < ANGLE_TOL
    assert out["cos_after"] > out["cos_before"] and out["ret"] == 0
    for name in ("before_align.pcd", "after_align.pcd"):
        assert (port_dir / name).exists()
    assert t_pcd.read_pcd(str(port_dir / "before_align.pcd"))[0].shape == (1280, 3)
