"""TUM ATE evaluation CLI, the evaluate_ate_scale.py twin (port of
unified_cvo_tpu/apps/evaluate_ate.py; numpy only).

The reference's BA scripts score trajectories with an external
evaluate_ate_scale.py before and after bundle adjustment
(scripts/cvo_irls_tum.bash, last lines: "before BA ate:" /
"after BA ate:"). This is that tool, built on the devkit twins in
utils/metrics: Umeyama-aligned absolute trajectory error, optionally
with scale correction (the monocular convention).

Usage:
    python -m unified_cvo_tpu_torch.apps.evaluate_ate GT.txt EST.txt [--scale]
        [--rpe] [--delta N]

GT/EST: TUM-format (timestamp tx ty tz qx qy qz qw) or KITTI 12-column
rows. Prints one line per metric.
"""

from __future__ import annotations

import argparse

from unified_cvo_tpu_torch.utils.metrics import ate_rmse, rpe_rmse
from unified_cvo_tpu_torch.utils.trajectory import align_trajectories


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("gt")
    ap.add_argument("est")
    ap.add_argument("--scale", action="store_true",
                    help="scale-corrected alignment (evaluate_ate_scale)")
    ap.add_argument("--rpe", action="store_true",
                    help="also print relative pose error")
    ap.add_argument("--delta", type=int, default=1,
                    help="RPE frame gap")
    ap.add_argument("--max-difference", type=float, default=0.02,
                    help="timestamp association window [s] for stamped "
                         "(TUM) inputs, as in evaluate_ate_scale.py")
    args = ap.parse_args(argv)
    # stamped inputs are associated by nearest timestamp (TUM mocap GT is
    # ~100 Hz vs per-frame estimates; index pairing would be meaningless);
    # unstamped (KITTI) inputs pair by row index
    gt, est = align_trajectories(args.gt, args.est,
                                 max_difference=args.max_difference)
    n = len(gt)
    if n < 2:
        print("need at least 2 associated poses")
        return 1
    ate = ate_rmse(gt, est, with_scale=args.scale)
    print(f"ate rmse: {ate:.6f} m"
          + (" (scale-aligned)" if args.scale else ""))
    if args.rpe:
        rpe = rpe_rmse(gt, est, delta=args.delta)
        print(f"rpe rmse (delta={args.delta}): {rpe:.6f} m")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
