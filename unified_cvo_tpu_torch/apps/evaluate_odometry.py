"""KITTI odometry evaluation CLI, the devkit/cpp/evaluate_odometry twin
(port of unified_cvo_tpu/apps/evaluate_odometry.py; numpy only).

Usage:
    python -m unified_cvo_tpu_torch.apps.evaluate_odometry GT_DIR RESULT_DIR [SEQS...]

GT_DIR holds <seq>/<seq>.txt (or <seq>.txt) ground-truth files; RESULT_DIR
holds <seq>.txt estimates (both KITTI 12-float rows). Prints per-sequence
and average translational (%) / rotational (deg/m) errors over segment
lengths {100..800} m (devkit/cpp/evaluate_odometry.cpp:15-121), plus ATE.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from unified_cvo_tpu_torch.datasets.kitti import read_kitti_poses
from unified_cvo_tpu_torch.utils.metrics import ate_rmse, kitti_seq_error


def find_gt(gt_dir: str, seq: str):
    for cand in (
        os.path.join(gt_dir, seq, f"{seq}.txt"),
        os.path.join(gt_dir, f"{seq}.txt"),
    ):
        if os.path.exists(cand):
            return cand
    return None


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__)
        return 1
    gt_dir, result_dir = argv[:2]
    seqs = argv[2:] or sorted(
        os.path.splitext(f)[0]
        for f in os.listdir(result_dir)
        if f.endswith(".txt")
    )
    t_all, r_all = [], []
    print(f"{'seq':>5} {'trans %':>9} {'rot deg/m':>10} {'ATE m':>8} {'frames':>7}")
    for seq in seqs:
        gt_path = find_gt(gt_dir, seq)
        est_path = os.path.join(result_dir, f"{seq}.txt")
        if gt_path is None or not os.path.exists(est_path):
            print(f"{seq:>5}   (missing gt or result)")
            continue
        gt = read_kitti_poses(gt_path)
        est = read_kitti_poses(est_path)
        t_err, r_err = kitti_seq_error(gt, est)
        ate = ate_rmse(gt, est)
        n = min(len(gt), len(est))
        print(f"{seq:>5} {100*t_err:9.4f} {np.degrees(r_err):10.6f} {ate:8.3f} {n:7d}")
        if np.isfinite(t_err):
            t_all.append(t_err)
            r_all.append(r_err)
    if t_all:
        print(
            f"{'avg':>5} {100*np.mean(t_all):9.4f} {np.degrees(np.mean(r_all)):10.6f}"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
