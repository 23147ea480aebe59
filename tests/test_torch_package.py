"""Package rules of the PyTorch port (unified_cvo_tpu_torch): it imports
neither jax nor the JAX package, importing it loads no OpenCV (the card's
machine has none), it never falls back to the CPU unasked,
its kernel wrappers take the plain path only for CPU tensors, and its CUDA
build is configured for Hopper without fast math."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from unified_cvo_tpu_torch import convert
from unified_cvo_tpu_torch.config import CvoParams, KITTI_GEOMETRIC_BENCH, read_cvo_params_yaml
from unified_cvo_tpu_torch.ops import cuda_lib
from unified_cvo_tpu_torch.ops import select as t_sel

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "unified_cvo_tpu_torch"
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "unified_cvo_tpu")
# importing the port loads none of these; cv2 is imported only inside the
# functions that read or write PNGs
NOT_LOADED = FORBIDDEN + ("cv2",)


def _module_names():
    names = []
    for p in sorted(PKG.rglob("*.py")):
        parts = ("unified_cvo_tpu_torch",) + p.relative_to(PKG).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return names


def _needs_no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_module_names()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {NOT_LOADED!r}]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr[-2000:]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_align_without_cuda_raises_instead_of_falling_back():
    _needs_no_card()
    from unified_cvo_tpu_torch.models.align import align
    from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud

    pc = make_pointcloud(np.zeros((8, 3), np.float32), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        align(pc, pc, np.eye(4, dtype=np.float32), KITTI_GEOMETRIC_BENCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_pointcloud(np.zeros((8, 3), np.float32))


def test_analysis_and_irls_entry_points_raise_without_cuda():
    """function_angle, compute_association(_non_isotropic), inner_product
    and irls_solve default to the card too."""
    _needs_no_card()
    from unified_cvo_tpu_torch import models
    from unified_cvo_tpu_torch.models import irls
    from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud

    pc = make_pointcloud(np.zeros((8, 3), np.float32), device="cpu")
    eye = np.eye(4, dtype=np.float32)
    for call in (lambda: models.function_angle(pc, pc, eye, 0.5, KITTI_GEOMETRIC_BENCH),
                 lambda: models.inner_product(pc, pc, eye, 0.5, KITTI_GEOMETRIC_BENCH),
                 lambda: models.compute_association(pc, pc, eye, 0.5, KITTI_GEOMETRIC_BENCH),
                 lambda: models.compute_association_non_isotropic(
                     pc, pc, eye, np.eye(3, dtype=np.float32), KITTI_GEOMETRIC_BENCH),
                 lambda: irls.irls_solve(irls.stack_clouds([pc, pc]),
                                         np.tile(np.eye(3, 4, dtype=np.float32), (2, 1, 1)),
                                         [(0, 1)], [True, False], KITTI_GEOMETRIC_BENCH)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_frontends_and_drivers_raise_without_cuda(tmp_path):
    """The device frontends, NL-means and the odometry drivers default to
    the card too."""
    _needs_no_card()
    from unified_cvo_tpu_torch.apps import kitti_odometry, tum_odometry
    from unified_cvo_tpu_torch.frontend import device as t_dev
    from unified_cvo_tpu_torch.frontend.calibration import Calibration
    from unified_cvo_tpu_torch.ops import nlm

    img = np.zeros((64, 96, 3), np.uint8)
    calib = Calibration(np.array([[50.0, 0, 48], [0, 50.0, 32], [0, 0, 1]], np.float32),
                        baseline=0.5, depth_scale=1000.0, cols=96, rows=64)
    for call in (lambda: t_dev.device_pointcloud_from_stereo(img, img, calib, max_disp=16),
                 lambda: t_dev.device_pointcloud_from_rgbd(img, np.ones((64, 96), np.uint16),
                                                           calib),
                 lambda: nlm.nlm_denoise_uint8(img),
                 lambda: kitti_odometry.run_frames([(img, img)], calib, KITTI_GEOMETRIC_BENCH,
                                                   frontend="device"),
                 lambda: tum_odometry.run_frames([(img, img[..., 0], "0")], calib,
                                                 KITTI_GEOMETRIC_BENCH, device_frontend=True)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


SLAM_SLICE = ("frontend.image", "frontend.selector", "frontend.stereo", "frontend.pipeline",
              "models.posegraph", "models.bki", "models.keyframe", "apps.local_mapping",
              "utils.trajectory")


def test_import_guard_covers_the_host_frontend_and_slam_modules():
    names = _module_names()
    assert all(f"unified_cvo_tpu_torch.{m}" in names for m in SLAM_SLICE)


def test_host_frontend_and_slam_entry_points_raise_without_cuda():
    """The host frontend's port, the pose graph, the BKI map and the
    local-mapping driver default to the card too."""
    _needs_no_card()
    from unified_cvo_tpu_torch.apps import local_mapping, tum_odometry
    from unified_cvo_tpu_torch.frontend import image, pipeline
    from unified_cvo_tpu_torch.frontend.calibration import Calibration
    from unified_cvo_tpu_torch.models import bki, posegraph

    img = np.zeros((64, 96, 3), np.uint8)
    depth = np.ones((64, 96), np.uint16)
    calib = Calibration(np.array([[50.0, 0, 48], [0, 50.0, 32], [0, 0, 1]], np.float32),
                        depth_scale=1000.0, cols=96, rows=64)
    eye = np.eye(4, dtype=np.float32)[None]
    for call in (lambda: image.make_raw_image(img, denoise=False),
                 lambda: pipeline.pointcloud_from_rgbd(img, depth, calib, denoise=False),
                 lambda: tum_odometry.run_frames([(img, depth, "0")], calib,
                                                 KITTI_GEOMETRIC_BENCH, denoise=False),
                 lambda: posegraph.optimize_pose_graph(eye, [0], [0], eye, [1.0], [1.0]),
                 lambda: posegraph.PoseGraph(),
                 lambda: bki.SemanticBKIMap(),
                 lambda: local_mapping.run_frames([(img, depth, "0")], calib,
                                                  KITTI_GEOMETRIC_BENCH, denoise=False)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_chip_smoke_fails_without_cuda():
    _needs_no_card()
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_select_wrapper_takes_the_plain_path_on_cpu(monkeypatch):
    def no_build(name):
        raise AssertionError(f"a CPU call tried to load the {name} kernel")

    monkeypatch.setattr(cuda_lib, "load", no_build)
    rng = np.random.default_rng(0)
    P, dims = 4, (4, 4, 4)
    tab = torch.full((65, 4 * P), -1.0)
    tab[:64, :3 * P] = torch.from_numpy(rng.uniform(0, 4, (64, 3 * P)).astype(np.float32))
    tab[:64, 3 * P:] = torch.arange(64 * P, dtype=torch.float32).reshape(64, P)
    cbase = torch.from_numpy(rng.integers(0, 4, (16, 3)).astype(np.int32))
    xr2 = torch.from_numpy(np.concatenate(
        [rng.uniform(0, 4, (16, 3)), np.full((16, 1), 1.0)], 1).astype(np.float32))
    pose = torch.cat([torch.eye(3).reshape(9), torch.zeros(3)])
    before = t_sel.select.launches
    got = t_sel.select(tab, cbase, xr2, pose, 8, P, dims)
    ref = t_sel.select_plain(tab, cbase, xr2, pose, 8, P, dims)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert t_sel.select.launches == before
    idx, y, kept = got
    assert idx.shape == (8, 16) and y.shape == (3, 8, 16) and kept.shape == (16,)
    assert torch.equal((idx >= 0).sum(0), torch.clamp(kept, max=8))


def test_cuda_build_targets_hopper_without_fast_math():
    flags = " ".join(cuda_lib.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "-fmad=false" in flags
    for name in cuda_lib.SOURCES:
        assert (cuda_lib.CSRC / f"{name}.cu").exists()
        path = cuda_lib.lib_path(name)
        assert path.parent == cuda_lib.BUILD_DIR and path == cuda_lib.lib_path(name)


def test_params_carry_across_from_the_jax_package():
    from unified_cvo_tpu.config import CvoParams as JaxParams

    jp = JaxParams(ell_init=0.3, sigma=0.2, is_using_geometry=1)
    assert dataclasses.asdict(convert.params_from_fields(dataclasses.asdict(jp))) \
        == dataclasses.asdict(jp)
    assert dataclasses.asdict(KITTI_GEOMETRIC_BENCH) == dataclasses.asdict(JaxParams())
    with pytest.raises(ValueError):
        convert.params_from_fields({"no_such_field": 1})


def test_yaml_reader_matches_jax(tmp_path):
    from unified_cvo_tpu.config import read_cvo_params_yaml as jax_read

    path = tmp_path / "preset.yaml"
    path.write_text("%YAML:1.0\nell_init: 0.25\nis_using_intensity: true\n"
                    "MAX_ITER: 300\nunknown_key: 5\n")
    got = read_cvo_params_yaml(str(path))
    assert isinstance(got, CvoParams)
    assert dataclasses.asdict(got) == dataclasses.asdict(jax_read(str(path)))
