"""Bunny-random multiframe BA fixture — the cvo_irls_rand_pcd twin (port of
unified_cvo_tpu/apps/irls_bunny.py).

Usage:
    python -m unified_cvo_tpu_torch.apps.irls_bunny [PCD_FILE] [NUM_FRAMES] [SIGMA]

Mirrors src/experiments/main_multi_frame_irls_bunny_random.cpp: take one
cloud (a PCD file, or a synthetic bunny-ish shape if omitted), express it in
NUM_FRAMES frames with random SE(3) offsets (twist std SIGMA), initialize
all poses at identity, and let multiframe IRLS pull the frames back onto the
ground-truth configuration. Prints per-frame pose error before/after.

The offsets come from the port's `ops/lie.py::se3_exp` on the host; the
solve runs on `device` (None means the card). `bunny_ba` is the run itself
and returns the poses.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from unified_cvo_tpu_torch.config import CvoParams
from unified_cvo_tpu_torch.models import irls
from unified_cvo_tpu_torch.ops import lie
from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud


def synthetic_bunny(n=1024, seed=0):
    rng = np.random.default_rng(seed)
    sph = rng.normal(size=(n // 2, 3))
    sph /= np.linalg.norm(sph, axis=1, keepdims=True)
    box = rng.uniform(-1, 1, size=(n - n // 2, 3)) * np.array([1.5, 0.2, 1.0])
    return np.concatenate([sph, box]).astype(np.float32)


def pose_errors(poses, true_poses):
    """(rotation angle rad, translation m) of each frame's pose."""
    out = []
    for P, Tt in zip(poses, true_poses):
        dR = P[:, :3].T @ Tt[:, :3]
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        out.append((ang, np.linalg.norm(P[:, 3] - Tt[:, 3])))
    return out


def bunny_ba(base, F=5, sigma=0.1, log=print, device=None):
    """Returns (poses [F, 3, 4], true poses, initial poses)."""
    rng = np.random.default_rng(42)
    clouds = [make_pointcloud(base, bucket=256, device=device)]
    true_poses = [np.eye(3, 4, dtype=np.float32)]
    for _ in range(1, F):
        xi = sigma * rng.normal(size=6).astype(np.float32)
        R, t = (v.numpy() for v in lie.se3_exp(torch.from_numpy(xi), 1.0))
        clouds.append(make_pointcloud(((base - t) @ R).astype(np.float32), bucket=256,
                                      device=device))
        true_poses.append(np.hstack([R, t[:, None]]).astype(np.float32))

    stacked = irls.stack_clouds(clouds)
    init = np.tile(np.eye(3, 4, dtype=np.float32), (F, 1, 1))
    edges = [(i, j) for i in range(F) for j in range(i + 1, F)]
    params = CvoParams(
        sp_thres=0.002,
        multiframe_ell_init=max(0.5, 3 * sigma),
        multiframe_ell_min=0.05,
        multiframe_ell_decay_rate=0.7,
        multiframe_iterations_per_ell=3,
        multiframe_iterations_per_solve=6,
        multiframe_min_nonzeros=20,
        multiframe_max_iters=80,
    )
    poses, _ = irls.irls_solve(
        stacked, init, edges, [True] + [False] * (F - 1), params,
        chunk=stacked.xyz.shape[1], log=log, device=device,
    )
    return poses, np.asarray(true_poses), init


def main(argv=None, device=None):
    argv = sys.argv[1:] if argv is None else argv
    pcd_file = argv[0] if argv else None
    F = int(argv[1]) if len(argv) > 1 else 5
    sigma = float(argv[2]) if len(argv) > 2 else 0.1

    if pcd_file and pcd_file != "-":
        from unified_cvo_tpu_torch.datasets.pcd import read_pcd

        base, _ = read_pcd(pcd_file)
    else:
        base = synthetic_bunny()
    print(f"base cloud: {len(base)} points, {F} frames, twist sigma {sigma}")
    poses, true_poses, init = bunny_ba(base, F, sigma, log=print, device=device)
    print("before:", [f"({a:.4f} rad, {t:.4f} m)" for a, t in pose_errors(init, true_poses)])
    after = pose_errors(poses, true_poses)
    print("after: ", [f"({a:.4f} rad, {t:.4f} m)" for a, t in after])
    worst = max(max(a, t) for a, t in after)
    print(f"worst residual error: {worst:.5f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
