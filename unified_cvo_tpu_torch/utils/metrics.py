"""Trajectory evaluation: KITTI segment errors + ATE (a copy of
unified_cvo_tpu/utils/metrics.py, numpy only, kept here so that the port
imports nothing of the JAX package).

KITTI metric re-derived from the bundled devkit
(reference devkit/cpp/evaluate_odometry.cpp:15-121): for every frame and
every segment length in {100,...,800} m, compose the relative pose error
between estimate and ground truth over that segment; report average
translational error (%) and rotational error (deg/m).

ATE follows the TUM evaluate_ate_scale.py convention the reference's BA
scripts call (scripts/cvo_irls_tum.bash): Umeyama alignment (optionally with
scale) then RMSE of translational residuals.
"""

from __future__ import annotations

import numpy as np

KITTI_LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)


def trajectory_distances(poses: np.ndarray) -> np.ndarray:
    d = np.zeros(len(poses))
    steps = np.linalg.norm(poses[1:, :3, 3] - poses[:-1, :3, 3], axis=1)
    d[1:] = np.cumsum(steps)
    return d


def _last_frame_from_segment(dist, first, length):
    idx = np.searchsorted(dist, dist[first] + length)
    return idx if idx < len(dist) else -1


def _rotation_error(E):
    a, b, c = E[0, 0], E[1, 1], E[2, 2]
    d = 0.5 * (a + b + c - 1.0)
    return np.arccos(np.clip(d, -1.0, 1.0))


def kitti_seq_error(poses_gt: np.ndarray, poses_est: np.ndarray, step: int = 10,
                    lengths=KITTI_LENGTHS):
    """Average (translation_error_fraction, rotation_error_rad_per_m) over
    all (first_frame % step == 0, segment length) pairs — the devkit metric.

    `lengths` defaults to the devkit's {100..800} m; pass shorter segment
    lengths to apply the same metric to short (e.g. synthetic) sequences."""
    n = min(len(poses_gt), len(poses_est))
    poses_gt, poses_est = poses_gt[:n], poses_est[:n]
    dist = trajectory_distances(poses_gt)
    t_errs, r_errs = [], []
    for first in range(0, n, step):
        for length in lengths:
            last = _last_frame_from_segment(dist, first, length)
            if last < 0:
                continue
            pose_delta_gt = np.linalg.inv(poses_gt[first]) @ poses_gt[last]
            pose_delta_est = np.linalg.inv(poses_est[first]) @ poses_est[last]
            E = np.linalg.inv(pose_delta_est) @ pose_delta_gt
            r_errs.append(_rotation_error(E[:3, :3]) / length)
            t_errs.append(np.linalg.norm(E[:3, 3]) / length)
    if not t_errs:
        return np.nan, np.nan
    return float(np.mean(t_errs)), float(np.mean(r_errs))


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = False):
    """Least-squares similarity transform aligning x onto y ([N,3] each).
    Returns (s, R, t) with y ~ s R x + t."""
    mx, my = x.mean(0), y.mean(0)
    xc, yc = x - mx, y - my
    cov = yc.T @ xc / len(x)
    U, S, Vt = np.linalg.svd(cov)
    sgn = np.sign(np.linalg.det(U) * np.linalg.det(Vt))
    D = np.diag([1.0, 1.0, sgn])
    R = U @ D @ Vt
    if with_scale:
        var_x = (xc**2).sum() / len(x)
        s = float(np.trace(np.diag(S) @ D) / var_x)
    else:
        s = 1.0
    t = my - s * R @ mx
    return s, R, t


def ate_rmse(poses_gt: np.ndarray, poses_est: np.ndarray, with_scale: bool = False):
    """Absolute trajectory error after Umeyama alignment (TUM convention)."""
    n = min(len(poses_gt), len(poses_est))
    gt = poses_gt[:n, :3, 3]
    est = poses_est[:n, :3, 3]
    s, R, t = umeyama_alignment(est, gt, with_scale)
    resid = gt - (s * est @ R.T + t)
    return float(np.sqrt((resid**2).sum(1).mean()))


def rpe_rmse(poses_gt: np.ndarray, poses_est: np.ndarray, delta: int = 1):
    """Relative pose error RMSE over frame gaps of `delta`."""
    n = min(len(poses_gt), len(poses_est))
    errs = []
    for i in range(n - delta):
        dg = np.linalg.inv(poses_gt[i]) @ poses_gt[i + delta]
        de = np.linalg.inv(poses_est[i]) @ poses_est[i + delta]
        E = np.linalg.inv(de) @ dg
        errs.append(np.linalg.norm(E[:3, 3]))
    return float(np.sqrt(np.mean(np.square(errs)))) if errs else np.nan
