"""kitti_odometry.run_sequence at the stereo host frontend (FAST, the native
census-SGM) against the JAX package's on the CPU, on test_apps_drivers.py's
3-frame stereo fixture (220 x 256): at its defaults (the NL-means-denoised
image) and raw with --semantic (4 classes), 150 iterations a pair (where
both packages have converged: at 60 the fixture is chaotic, see
tests/test_torch_stereo_apps.py): poses within POSE_TOL of JAX's, the rows
file written. The fixtures and the runs are test_torch_stereo_apps.py's.
"""

import numpy as np
import pytest
import torch

from test_torch_stereo_apps import (  # noqa: F401 (fixtures)
    CASES, POSE_TOL, _gap, fast_yaml, jax_native_disparity, kitti_dir, run_both)

torch.set_num_threads(1)


@pytest.mark.parametrize("case", list(CASES))
def test_kitti_host_odometry_matches_jax(case, kitti_dir, fast_yaml, tmp_path,
                                         jax_native_disparity):
    pj, pt, rows = run_both(kitti_dir, fast_yaml, tmp_path, case)
    assert pt.shape == pj.shape == (3, 4, 4) and np.isfinite(pt).all()
    assert np.loadtxt(rows).shape == (3, 12)
    gaps = [_gap(a, b) for a, b in zip(pj, pt)]
    assert max(gaps) < POSE_TOL, gaps
