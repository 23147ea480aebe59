"""KITTI stereo frame-to-frame odometry, the cvo_align_gpu_img twin (port of
unified_cvo_tpu/apps/kitti_odometry.py).

Usage:
    python -m unified_cvo_tpu_torch.apps.kitti_odometry SEQ_DIR PARAMS.yaml OUT.txt \
        [START_FRAME] [MAX_FRAMES] [--semantic] [--device-frontend]

Mirrors src/experiments/main_cvo_gpu_align_raw_image.cpp:22-169: per frame,
build a stereo point cloud, align it against the previous frame with the
previous relative motion as the initial guess (constant velocity),
accumulate, and stream KITTI-format rows to OUT. The first pair uses the
*_first_frame parameter swap (main:40-46,156-161).

The default `frontend="host"` is the JAX package's: FAST selection on the
NL-means-denoised left image and the disparity of the raw pair
(frontend/pipeline.py::pointcloud_from_stereo), each cloud built on the
card. `stereo_backend` picks the disparity: "native" the census-SGM of
native/cvo_native.cpp, "opencv" cv2.StereoSGBM 3WAY, both bit for bit, and
"auto" JAX's rule: "opencv" where cv2 is importable, else "native". With --semantic, per-pixel 19-class distributions are read beside the
stereo pair and attached to the clouds, the cvo_align_gpu_semantic_img twin
(main_cvo_semantic_gpu_align_raw_image.cpp). `--device-frontend` builds each
cloud with the device frontend instead (census-SGM with the density
speckle, DSO selection, backprojection; frontend/device.py).

`run_frames` is the loop itself over an iterable of (left, right) images,
so a sequence can be registered without files; `run_sequence` reads the
KITTI layout and calls it.
"""

from __future__ import annotations

import itertools
import sys

import numpy as np

from unified_cvo_tpu_torch.apps._odometry_common import PairRecord, run_pipelined
from unified_cvo_tpu_torch.config import read_cvo_params_yaml
from unified_cvo_tpu_torch.datasets.kitti import KittiHandler, write_kitti_pose_row
from unified_cvo_tpu_torch.device import resolve_device
from unified_cvo_tpu_torch.frontend.device import device_pointcloud_from_stereo
from unified_cvo_tpu_torch.frontend.pipeline import pointcloud_from_stereo
from unified_cvo_tpu_torch.utils.logging import MetricsLogger

CAPACITY = 32768  # one cloud shape for all frames (28k max FAST budget + pad)


def max_disp_for(cols: int) -> int:
    """The disparity search range by image width: KITTI's full 1241 px (or
    an unknown width) needs the reference's 128; half-scale imagery halves
    it, and the SGM's cost is linear in it."""
    return 128 if cols >= 900 or cols == 0 else 64


def _stereo_frontend(frontend: str, calib, capacity: int, device_max_disp, semantic: bool,
                     dev, denoise: bool = True, stereo_backend: str = "auto"):
    """(left, right[, semantics]) -> PointCloud on `dev`, JAX's frontend
    rules (kitti_odometry.py:62-96)."""
    if frontend != "device":
        def build_host(left, right, sem=None):
            return pointcloud_from_stereo(left, right, calib, semantics=sem, denoise=denoise,
                                          capacity=capacity, stereo_backend=stereo_backend,
                                          device=dev)
        return build_host
    if semantic:
        raise ValueError("frontend='device' does not take --semantic")
    md = max_disp_for(calib.cols) if device_max_disp is None else device_max_disp

    def build_cloud(left, right, sem=None):
        return device_pointcloud_from_stereo(left, right, calib, capacity=capacity,
                                             max_disp=md, denoise=False, device=dev)
    return build_cloud


def run_frames(
    frames,
    calib,
    params,
    first_params=None,
    out=None,
    start_frame: int = 0,
    chunk: int = 4096,
    max_iter: int | None = None,
    log=print,
    metrics: MetricsLogger | None = None,
    capacity: int = CAPACITY,
    frontend: str = "host",
    device_max_disp: int | None = None,
    denoise: bool = True,
    stereo_backend: str = "auto",
    device=None,
):
    """Register an iterable of (left, right) stereo images, or of (left,
    right, semantics) on the host frontend, frame to frame.

    Writes one KITTI row per aligned frame to `out` (a text file, when
    given) and returns (poses [N, 4, 4] float64, a PairRecord for each
    pair). `stereo_backend` as in the module docstring (the host
    frontend only). `first_params` defaults to
    `params.first_frame()`; `device=None` means the card."""
    dev = resolve_device(device)
    build_cloud = _stereo_frontend(frontend, calib, capacity, device_max_disp, False, dev,
                                   denoise, stereo_backend)
    first_params = params.first_frame() if first_params is None else first_params
    it = iter(frames)
    first = next(it, None)
    if first is None:
        raise RuntimeError("empty sequence")
    source = build_cloud(*first)
    accum = np.eye(4, dtype=np.float64)
    poses, records = [accum.copy()], []

    def read_target(i):
        pair = next(it, None)
        return None if pair is None else (build_cloud(*pair), None)

    def on_result(i, result, ret, info, aux, t_frontend, t_block):
        nonlocal accum
        accum = accum @ result
        poses.append(accum.copy())
        records.append(PairRecord(info, ret, t_frontend, t_block))
        if out is not None:
            write_kitti_pose_row(out, accum)
        log(f"frame {i}->{i+1}: iters={int(info.iterations)} "
            f"ell={float(info.final_ell):.3f} ret={int(ret)} "
            f"host_reads={info.host_reads} frontend={t_frontend:.2f}s wait={t_block:.2f}s")
        if metrics is not None:
            metrics.log(
                frame=i + 1, iterations=int(info.iterations), ret=int(ret),
                final_ell=float(info.final_ell), nonzeros=int(info.nonzeros),
                host_reads=info.host_reads, frontend_seconds=t_frontend,
                align_wait_seconds=t_block)

    n_aligned, total_block = run_pipelined(
        source, itertools.count(start_frame), read_target, params, first_params,
        on_result, chunk=chunk, max_iter=max_iter, device=dev)
    log(f"Average registration time is {total_block / max(n_aligned, 1):.3f}")
    return np.asarray(poses), records


def run_sequence(
    seq_dir: str,
    param_file: str,
    out_path: str,
    start_frame: int = 0,
    max_frames: int = 100000,
    denoise: bool = True,
    chunk: int = 4096,
    max_iter: int | None = None,
    log=print,
    metrics_path: str | None = None,
    semantic: bool = False,
    num_classes: int = 19,
    capacity: int = CAPACITY,
    stereo_backend: str = "auto",
    frontend: str = "host",
    device_max_disp: int | None = None,
    device=None,
    records=None,
):
    """The JAX driver's signature, plus `device` (None means the card) and
    `records`, a list that receives each pair's PairRecord. With
    `semantic`, each frame's distributions come from
    KittiHandler.read_next_stereo_semantic(num_classes)."""
    kitti = KittiHandler(seq_dir, "stereo")
    calib = kitti.calibration()
    dev = resolve_device(device)
    _stereo_frontend(frontend, calib, capacity, device_max_disp, semantic, dev)
    params = read_cvo_params_yaml(param_file)
    kitti.set_start_index(start_frame)
    n_frames = min(len(kitti), start_frame + max_frames)

    def frames():
        while kitti.curr_index < n_frames:
            pair = (kitti.read_next_stereo_semantic(num_classes) if semantic
                    else kitti.read_next_stereo())
            if pair is None:
                return
            yield pair
            kitti.next()

    metrics = MetricsLogger(metrics_path)
    try:
        with open(out_path, "w") as out:
            out.write("1 0 0 0 0 1 0 0 0 0 1 0\n")
            out.flush()
            poses, recs = run_frames(
                frames(), calib, params, out=out, start_frame=start_frame, chunk=chunk,
                max_iter=max_iter, log=log, metrics=metrics, capacity=capacity,
                frontend=frontend, device_max_disp=device_max_disp, denoise=denoise,
                stereo_backend=stereo_backend, device=dev)
    finally:
        metrics.close()
    if records is not None:
        records.extend(recs)
    return poses


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        print(__doc__)
        return 1
    semantic = "--semantic" in argv
    device_fe = "--device-frontend" in argv
    argv = [a for a in argv if a not in ("--semantic", "--device-frontend")]
    seq_dir, param_file, out_path = argv[:3]
    start = int(argv[3]) if len(argv) > 3 else 0
    max_frames = int(argv[4]) if len(argv) > 4 else 100000
    run_sequence(seq_dir, param_file, out_path, start, max_frames,
                 semantic=semantic,
                 frontend="device" if device_fe else "host")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
