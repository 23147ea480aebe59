"""A fleet of synthetic KITTI-scale drives: for each drive a structured
outdoor scene (ground plane, two walls, posts; ~55 m range envelope), seen
from a camera that moves ~1 m a frame with a wobble of its own, made on the
device from the seed.

The scene and the motion follow the frame-to-frame bench sequence of the
measured package (`apps/f2f_sequence.py`: `synthetic_kitti_scene`,
`make_sequence`), with each drive given its own scene draw and its own
wobble phase and amplitude. Frame k + 1 is the propagated frame k moved by
the drive's true motion T_k, points that recede past 55 m wrapped back to
near range (so frames overlap only partly), plus fresh sensor noise.

Parameters (the workload file's "traffic" object): drives, points,
pairs (how many frame pairs a drive has, the most a run can register),
noise_m (per-frame sensor noise), wobble_amp [lo, hi].
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

XI_BASE = np.array([0.0, 0.006, 0.0, 0.04, 0.01, 1.0])
XI_WOBBLE = np.array([0.0006, -0.0009, 0.0006, 0.006, -0.006, 0.024])
XI_GUESS_OFFSET = np.array([0.002, -0.003, 0.002, 0.02, -0.02, 0.08])

# the scene's four parts: (share of the points, lower corner, upper corner)
PARTS = ((0.25, (-12.0, -1.75, 2.0), (12.0, -1.6, 55.0)),    # ground
         (0.25, (-10.0, -1.5, 2.0), (-8.0, 3.0, 55.0)),      # left wall
         (0.25, (7.0, -1.5, 2.0), (9.0, 3.0, 55.0)),         # right wall
         (None, (-8.0, -1.5, 2.0), (8.0, 2.5, 40.0)))        # posts: the rest


class Fleet(NamedTuple):
    frames: torch.Tensor       # [pairs + 1, drives, points, 3] float32
    T_true: torch.Tensor       # [pairs, drives, 4, 4] float32: frame k+1 = T_true[k] frame k
    guess0: torch.Tensor       # [drives, 4, 4] float32: the first pair's guess


def exp_se3(xi: np.ndarray) -> np.ndarray:
    """4 x 4 exp of the twist [omega, v] in float64."""
    w, v = xi[:3], xi[3:]
    th = float(np.linalg.norm(w))
    A = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-9:
        R, J = np.eye(3) + A, np.eye(3) + 0.5 * A
    else:
        R = np.eye(3) + math.sin(th) / th * A + (1 - math.cos(th)) / th ** 2 * A @ A
        J = (np.eye(3) + (1 - math.cos(th)) / th ** 2 * A
             + (th - math.sin(th)) / th ** 3 * A @ A)
    out = np.eye(4)
    out[:3, :3], out[:3, 3] = R, J @ v
    return out


def _box(n: int, device):
    """[n, 3] lower corners and spans of each point's scene part."""
    lo, span, used = [], [], 0
    for share, a, b in PARTS:
        k = n - used if share is None else int(n * share)
        used += k
        lo.append(torch.tensor(a, dtype=torch.float32).expand(k, 3))
        span.append((torch.tensor(b) - torch.tensor(a)).to(torch.float32).expand(k, 3))
    return torch.cat(lo).to(device), torch.cat(span).to(device)


def make(spec: dict, seed: int, device) -> Fleet:
    """The fleet of `spec` from `seed`: the same seed gives the same frames
    on the same device."""
    B, n, pairs = int(spec["drives"]), int(spec["points"]), int(spec["pairs"])
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0.0, 2.0 * math.pi, B)
    amp = rng.uniform(*spec["wobble_amp"], B)
    T = np.stack([np.stack([exp_se3(XI_BASE + XI_WOBBLE * amp[b] * math.cos(0.9 * k + phase[b]))
                            for b in range(B)]) for k in range(pairs)])
    T_true = torch.as_tensor(T, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    lo, span = _box(n, device)
    xyz = lo + span * torch.rand((B, n, 3), generator=gen, device=device)
    xyz = xyz + 0.01 * torch.randn((B, n, 3), generator=gen, device=device)
    noise = float(spec["noise_m"]) * torch.randn((pairs + 1, B, n, 3), generator=gen,
                                                 device=device)
    frames = torch.empty((pairs + 1, B, n, 3), dtype=torch.float32, device=device)
    for k in range(pairs + 1):
        frames[k] = xyz + noise[k]
        if k == pairs:
            break
        R, t = T_true[k, :, :3, :3], T_true[k, :, :3, 3]
        xyz = torch.einsum("bij,bnj->bni", R, xyz) + t[:, None, :]
        xyz[..., 2] = 2.0 + torch.remainder(xyz[..., 2] - 2.0, 53.0)
    guess0 = torch.as_tensor(exp_se3(XI_BASE + 0.3 * XI_GUESS_OFFSET), dtype=torch.float32,
                             device=device).expand(B, 4, 4).contiguous()
    return Fleet(frames=frames, T_true=T_true, guess0=guess0)
