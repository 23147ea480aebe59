"""Trajectory-file loading and timestamp association (numpy copy of
unified_cvo_tpu/utils/trajectory.py), read by the evaluation tools and by
apps/local_mapping.py's offline mode.

TUM ground truth is logged at mocap rate (~100 Hz) while estimates are
per-frame, so comparing by row index is meaningless: the reference's
evaluate_ate_scale.py associates poses by nearest timestamp within a
maximum difference, and `associate_by_time` reproduces that contract.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def load_trajectory(path: str) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """(timestamps [N] float64 or None, poses [N,4,4]) from a TUM (8-col,
    stamped) or KITTI (12-col, unstamped) trajectory file."""
    with open(path) as f:
        first = f.readline().split()
    if len(first) >= 12:
        rows = np.atleast_2d(np.loadtxt(path))
        out = np.tile(np.eye(4), (len(rows), 1, 1))
        out[:, :3, :] = rows[:, -12:].reshape(-1, 3, 4)
        return None, out
    from unified_cvo_tpu_torch.datasets.tum import read_tum_trajectory

    stamps, poses = read_tum_trajectory(path)
    return np.asarray([float(s) for s in stamps]), poses


def associate_by_time(t_a: np.ndarray, t_b: np.ndarray,
                      max_difference: float = 0.02):
    """Greedy nearest-timestamp matching (the evaluate_ate_scale.py
    associate() contract): returns (idx_a [M], idx_b [M]) of matched rows,
    each row used at most once, |t_a - t_b| <= max_difference."""
    pairs = []
    for i, ta in enumerate(t_a):
        for j, tb in enumerate(t_b):
            d = abs(ta - tb)
            if d <= max_difference:
                pairs.append((d, i, j))
    pairs.sort()
    used_a, used_b = set(), set()
    ia, ib = [], []
    for d, i, j in pairs:
        if i in used_a or j in used_b:
            continue
        used_a.add(i)
        used_b.add(j)
        ia.append(i)
        ib.append(j)
    order = np.argsort(ia)
    return (np.asarray(ia, np.int64)[order], np.asarray(ib, np.int64)[order])


def align_trajectories(path_gt: str, path_est: str,
                       max_difference: float = 0.02):
    """Load two trajectory files and return time-associated pose arrays
    (gt [M,4,4], est [M,4,4]). Unstamped (KITTI) inputs pair by index."""
    t_g, gt = load_trajectory(path_gt)
    t_e, est = load_trajectory(path_est)
    if t_g is None or t_e is None:
        n = min(len(gt), len(est))
        return gt[:n], est[:n]
    ig, ie = associate_by_time(t_g, t_e, max_difference)
    return gt[ig], est[ie]
