"""kitti_odometry.run_sequence at the stereo host frontend (FAST, the native
census-SGM) against the JAX package's on the CPU, on test_apps_drivers.py's
3-frame stereo fixture (220 x 256): at its defaults (the NL-means-denoised
image) and raw with --semantic (4 classes), 150 iterations a pair (where
both packages have converged: at 60 the fixture is chaotic, see
tests/test_torch_stereo_apps.py): poses within POSE_TOL of JAX's, the rows
file written. The fixtures and the runs are test_torch_stereo_apps.py's.
One pair on CANNY_EDGES selection (the exact ORB) in both packages: the
port's pose within POSE_TOL of JAX's.

Run as a script with `--chip-canny`, it prints what chip_smoke.py's
CANNY_CPU records: phase 16b's pair (canny_pair, at 1241 x 376) through the
port on the CPU, its se(3) log, pose error, iterations and builds, and the
largest gap of four more runs with the guess moved by +-1e-6 m along x and
z, at each cap (CANNY_CHECK_ITER and CANNY_ITER, or the ones after
`--caps`; ~25 minutes on 8 threads); with `--jax`, JAX's pose of the same
pair at each cap:

    JAX_PLATFORMS=cpu python tests/test_torch_stereo_odometry.py --chip-canny [--jax] \
        [--caps N ...]
"""

import sys
from pathlib import Path

if __name__ == "__main__":      # as a script: the repo root and tests/ on the path
    sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).parent)]

import numpy as np
import pytest
import torch

from test_torch_stereo_apps import (  # noqa: F401 (fixtures)
    CASES, ODO, POSE_TOL, _gap, fast_yaml, jax_native_disparity, kitti_dir, run_both)

torch.set_num_threads(1)


@pytest.mark.parametrize("case", list(CASES))
def test_kitti_host_odometry_matches_jax(case, kitti_dir, fast_yaml, tmp_path,
                                         jax_native_disparity):
    pj, pt, rows = run_both(kitti_dir, fast_yaml, tmp_path, case)
    assert pt.shape == pj.shape == (3, 4, 4) and np.isfinite(pt).all()
    assert np.loadtxt(rows).shape == (3, 12)
    gaps = [_gap(a, b) for a, b in zip(pj, pt)]
    assert max(gaps) < POSE_TOL, gaps


def test_canny_edges_pair_matches_jax(kitti_dir, fast_yaml, jax_native_disparity):
    """One stereo pair of the fixture on CANNY_EDGES selection (ORB's
    keypoints, the edge and the uniform draws) in both packages: the raw
    frames through pointcloud_from_stereo on the native disparity, aligned
    from the identity at the first-frame schedule, 150 iterations (where the
    fixture has converged): the port's pose within POSE_TOL of JAX's, the
    clouds' masks equal."""
    import cv2
    import jax.numpy as jnp

    from unified_cvo_tpu.config import read_cvo_params_yaml as j_params
    from unified_cvo_tpu.datasets.kitti import KittiHandler as JKitti
    from unified_cvo_tpu.frontend import pipeline as j_pipeline
    from unified_cvo_tpu.models.align import align as j_align
    from unified_cvo_tpu_torch import convert
    from unified_cvo_tpu_torch.config import read_cvo_params_yaml as t_params
    from unified_cvo_tpu_torch.frontend import pipeline as t_pipeline
    from unified_cvo_tpu_torch.models.align import align as t_align

    calib = JKitti(kitti_dir).calibration()
    tcalib = convert.calibration_from_fields(calib.intrinsic, calib.baseline,
                                             calib.depth_scale, calib.cols, calib.rows)
    pairs = [[cv2.imread(f"{kitti_dir}/image_{c}/{i:06d}.png") for c in (2, 3)]
             for i in range(2)]
    kw = dict(method="CANNY_EDGES", denoise=False, capacity=ODO["capacity"])
    cj = [j_pipeline.pointcloud_from_stereo(l, r, calib, stereo_backend="native", **kw)
          for l, r in pairs]
    ct = [t_pipeline.pointcloud_from_stereo(l, r, tcalib, device="cpu", **kw)
          for l, r in pairs]
    for a, b in zip(cj, ct):
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
        assert float(b.mask.sum()) > 300
    Tj = j_align(cj[0], cj[1], jnp.eye(4), j_params(fast_yaml).first_frame(), max_iter=150)[0]
    Tt = t_align(ct[0], ct[1], torch.eye(4), t_params(fast_yaml).first_frame(), max_iter=150,
                 device="cpu")[0]
    gap = _gap(np.asarray(Tj, np.float64), Tt.numpy().astype(np.float64))
    print(f"CANNY_EDGES pair: port {gap:.3e} from JAX")
    assert gap < POSE_TOL, gap


def chip_canny_record(with_jax: bool, caps=None):
    """chip_smoke.CANNY_CPU's entries, one a cap (by default CANNY_CHECK_ITER
    and CANNY_ITER), and with `with_jax` JAX's pose of the same pair at each cap
    (its host frontend on the native disparity, then JAX align)."""
    import tempfile
    import time

    import chip_smoke
    from unified_cvo_tpu_torch.apps import f2f_sequence as f2f
    from unified_cvo_tpu_torch.config import read_cvo_params_yaml
    from unified_cvo_tpu_torch.ops import lie as t_lie

    calib, frames, traj = chip_smoke.stereo_frames()
    with tempfile.TemporaryDirectory() as root:
        yaml = f"{root}/stereo.yaml"
        with open(yaml, "w") as f:
            f.write(chip_smoke.STEREO_HOST_YAML)
        params = read_cvo_params_yaml(yaml)
    true = np.linalg.inv(traj[2]) @ traj[1]
    caps = caps or (chip_smoke.CANNY_CHECK_ITER, chip_smoke.CANNY_ITER)
    clouds, poses = None, {}
    for cap in caps:
        t0 = time.perf_counter()
        clouds, T, _, info = chip_smoke.canny_pair(frames, calib, params, "cpu", max_iter=cap,
                                                   clouds=clouds)
        T = poses[cap] = T.numpy().astype(np.float64)
        gaps = []
        for axis, sign in ((0, 1), (0, -1), (2, 1), (2, -1)):
            guess = torch.eye(4, dtype=torch.float32)
            guess[axis, 3] += sign * 1e-6
            Tm = chip_smoke.canny_pair(frames, calib, params, "cpu", guess, cap, clouds)[1]
            gaps.append(_gap(T, Tm.numpy().astype(np.float64)))
        xi = t_lie.se3_log(torch.from_numpy(T[:3, :3]), torch.from_numpy(T[:3, 3])).tolist()
        print(f"{cap}: ({tuple(round(x, 9) for x in xi)}, "
              f"{f2f.pose_errors([T], [true])[0]:.6f}, {info.iterations}, {info.nl_rebuilds}, "
              f"{max(gaps):.3g}),  # gaps {[f'{g:.3g}' for g in gaps]}, "
              f"{time.perf_counter() - t0:.0f} s", flush=True)
    if with_jax:
        import jax.numpy as jnp

        from unified_cvo_tpu.config import read_cvo_params_yaml as j_params
        from unified_cvo_tpu.frontend import calibration as j_calib
        from unified_cvo_tpu.frontend import pipeline as j_pipeline
        from unified_cvo_tpu.models.align import align as j_align

        jc = j_calib.Calibration(np.asarray(calib.intrinsic), baseline=calib.baseline,
                                 depth_scale=calib.depth_scale, cols=calib.cols,
                                 rows=calib.rows)
        cj = [j_pipeline.pointcloud_from_stereo(l, r, jc, method="CANNY_EDGES",
                                                capacity=chip_smoke.CANNY_CAPACITY,
                                                stereo_backend="native")
              for l, r in frames[1:3]]
        with tempfile.TemporaryDirectory() as root:
            yaml = f"{root}/stereo.yaml"
            with open(yaml, "w") as f:
                f.write(chip_smoke.STEREO_HOST_YAML)
            jp = j_params(yaml)
        for cap in caps:
            Tj, _, ij = j_align(cj[0], cj[1], jnp.eye(4), jp, max_iter=cap)
            Tj = np.asarray(Tj, np.float64)
            print(f"JAX at {cap}: pose error {f2f.pose_errors([Tj], [true])[0]:.6f}, "
                  f"{int(ij.iterations)} iterations, {_gap(Tj, poses[cap]):.3e} from the "
                  f"port's CPU pose", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(8)
    if "--chip-canny" in sys.argv:
        caps = [int(a) for a in sys.argv[sys.argv.index("--caps") + 1:]] \
            if "--caps" in sys.argv else None
        chip_canny_record("--jax" in sys.argv, caps)
