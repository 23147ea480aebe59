"""Frame-to-frame registration of a KITTI-scale synthetic sequence: the
workload `bench.py` times, ported (scene and sequence generator, the
device-resident constant-velocity chain, and the pose-error check).

Each frame is 16384 points of a structured outdoor scene (ground plane,
two walls, posts; ~55 m range envelope) seen from a camera moving ~1 m per
frame with a varying motion; each pair is registered with the previous
pair's result as its constant-velocity guess, without a host round trip
between pairs.

With per-point colour features and `KITTI_COLOR_BENCH`, `run_sequence`
drives the ELL path with the channel factor on the same sequence (the
default backend, as JAX routes it) and `run_sequence(..., backend="pallas")`
the dense tiled backend. `chip_smoke.py` drives them on the card; the CPU
tests drive them with `device="cpu"` (the plain PyTorch versions of the
kernels).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from unified_cvo_tpu_torch.config import KITTI_GEOMETRIC_BENCH
from unified_cvo_tpu_torch.device import resolve_device
from unified_cvo_tpu_torch.models.align import align
from unified_cvo_tpu_torch.ops import lie

POSE_ERROR_BOUND = 0.05    # sanity bound on max |xi| of a pair's error
XI_BASE = np.array([0.0, 0.006, 0.0, 0.04, 0.01, 1.0], np.float32)
XI_WOBBLE = np.array([0.0006, -0.0009, 0.0006, 0.006, -0.006, 0.024], np.float32)
XI_GUESS_OFFSET = np.array([0.002, -0.003, 0.002, 0.02, -0.02, 0.08], np.float32)


def synthetic_kitti_scene(n: int = 16384, seed: int = 0) -> np.ndarray:
    """Structured outdoor scene: ground plane, two walls, posts; ~55 m range."""
    rng = np.random.default_rng(seed)
    k = n // 4
    ground = np.stack(
        [rng.uniform(-12, 12, k), rng.uniform(-1.75, -1.6, k), rng.uniform(2, 55, k)],
        axis=1)
    wall_l = np.stack(
        [rng.uniform(-10, -8, k), rng.uniform(-1.5, 3.0, k), rng.uniform(2, 55, k)],
        axis=1)
    wall_r = np.stack(
        [rng.uniform(7, 9, k), rng.uniform(-1.5, 3.0, k), rng.uniform(2, 55, k)],
        axis=1)
    m = n - 3 * k
    posts = np.stack(
        [rng.uniform(-8, 8, m), rng.uniform(-1.5, 2.5, m), rng.uniform(2, 40, m)],
        axis=1)
    xyz = np.concatenate([ground, wall_l, wall_r, posts]).astype(np.float32)
    xyz += rng.normal(scale=0.01, size=xyz.shape).astype(np.float32)
    return xyz


def _exp44(xi: np.ndarray) -> np.ndarray:
    R, t = lie.se3_exp(torch.from_numpy(np.asarray(xi, np.float32)), 1.0)
    return lie.rt_to_mat44(R, t).numpy()


def point_features(xyz: np.ndarray) -> np.ndarray:
    """[n, 5] per-point colour features [|sin(1.7 xyz)|, 0, 0] (the
    reference's FEATURE_DIMENSIONS = 5; __graft_entry__.py:19-21)."""
    return np.concatenate([np.abs(np.sin(xyz * 1.7)), np.zeros((len(xyz), 2))],
                          axis=1).astype(np.float32)


def make_sequence(n_points: int = 16384, n_frames: int = 8, features: bool = False):
    """(frames, T_true): n_frames + 1 noisy [n, 3] float32 frames and the
    n_frames true relative transforms, frame_{k+1} = T_true[k] . frame_k.
    Points that recede past the ~55 m envelope wrap back to near range, so
    the workload stays stationary and frames overlap only partially.

    With `features`, returns (frames, T_true, feats): feats [n, 5] is fixed
    at creation from the scene's points and carried with each point through
    every frame and the wrap, so row i of every frame takes feats[i]."""
    xyz_k = synthetic_kitti_scene(n_points)
    feats = point_features(xyz_k)
    rng = np.random.default_rng(7)
    frames, T_true = [], []
    for k in range(n_frames + 1):
        frames.append(xyz_k + rng.normal(scale=0.005, size=xyz_k.shape).astype(np.float32))
        if k == n_frames:
            break
        xi_k = XI_BASE + XI_WOBBLE * np.float32(np.cos(0.9 * k + 0.4) * 2.0)
        T_k = _exp44(xi_k)
        xyz_k = xyz_k @ T_k[:3, :3].T + T_k[:3, 3]
        xyz_k[:, 2] = 2.0 + np.mod(xyz_k[:, 2] - 2.0, 53.0)
        T_true.append(T_k)
    return (frames, T_true, feats) if features else (frames, T_true)


def initial_guess() -> np.ndarray:
    """Constant-velocity seed of the first pair, slightly wrong on purpose."""
    return _exp44(XI_BASE + 0.3 * XI_GUESS_OFFSET)


def run_sequence(frames: Sequence, guess: torch.Tensor, params=KITTI_GEOMETRIC_BENCH,
                 device=None, **align_kw):
    """Register every consecutive pair; the pose chain stays on the device
    (pair k's result, re-inverted, is pair k+1's guess). Returns the list of
    relative transforms and the list of AlignInfo."""
    dev = resolve_device(device)
    results, infos = [], []
    for k in range(len(frames) - 1):
        T_rel, _, info = align(frames[k], frames[k + 1], guess, params,
                               device=dev, **align_kw)
        # align returns the target->source map and takes the inverse
        # convention as its guess: re-invert on the device
        guess = lie.rt_to_mat44(*lie.invert_rt(*lie.mat44_to_rt(T_rel)))
        results.append(T_rel)
        infos.append(info)
    return results, infos


def pose_errors(results: Sequence, T_true: Sequence[np.ndarray]) -> List[float]:
    """|log(T_rel . T_true)| per pair: zero when the registration is exact."""
    errs = []
    for T_rel, T_k in zip(results, T_true):
        T_rel = (T_rel.cpu() if isinstance(T_rel, torch.Tensor)
                 else torch.from_numpy(np.array(T_rel, np.float32)))
        E = T_rel.to(torch.float32) @ torch.from_numpy(np.array(T_k, np.float32))
        errs.append(float(torch.linalg.vector_norm(lie.se3_log(E[:3, :3], E[:3, 3]))))
    return errs
