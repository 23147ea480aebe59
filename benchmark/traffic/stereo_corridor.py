"""Stereo pairs of a textured corridor, ray-cast on the device from the
seed: the rendered KITTI-layout scene of the measured package's
`utils/synth.py` (`corridor_scene`, `corridor_trajectory`,
`render_stereo`), rewritten in torch.

The corridor is a closed box along +z (floor, ceiling, two side walls, a
far end wall), each surface textured with multi-scale smooth noise (coarse
colour blocks for appearance, fine structure for FAST corners and stereo
matching), sampled bilinearly with wrap-around. The camera moves forward
with a slow yaw and a small bob; the right camera sits `baseline` along
the camera's x axis. The seed draws the textures; the trajectory and every
size are the same for every seed.

Parameters (the workload file's "traffic" object): pairs, step_m,
yaw_rate, bob_m, and the corridor's length_m, half_width_m, floor_y,
ceil_y, tex_scale_m.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

TEXTURE = 512
OCTAVES = ((64, 55.0), (16, 40.0), (4, 30.0))


def texture(gen, device) -> torch.Tensor:
    """[3, 512, 512] float32 in [0, 255]."""
    img = torch.zeros((1, 3, TEXTURE, TEXTURE), dtype=torch.float32, device=device)
    for cell, amp in OCTAVES:
        n = TEXTURE // cell
        noise = torch.rand((1, 3, n, n), generator=gen, device=device) * 2.0 - 1.0
        img += amp * F.interpolate(noise, size=(TEXTURE, TEXTURE), mode="bilinear",
                                   align_corners=False)
    return torch.clamp(img[0] + 128.0, 0.0, 255.0)


def corridor(spec: dict, gen, device):
    """[(axis, offset, (tangent a, tangent b), texture, bounds)] of the
    five planes."""
    L, hw = float(spec["length_m"]), float(spec["half_width_m"])
    fy, cy = float(spec["floor_y"]), float(spec["ceil_y"])
    z0 = -10.0
    return [(1, fy, (0, 2), texture(gen, device), ((-hw, hw), (z0, L))),
            (1, cy, (0, 2), texture(gen, device), ((-hw, hw), (z0, L))),
            (0, -hw, (1, 2), texture(gen, device), ((cy, fy), (z0, L))),
            (0, hw, (1, 2), texture(gen, device), ((cy, fy), (z0, L))),
            (2, L, (0, 1), texture(gen, device), ((-hw, hw), (cy, fy)))]


def trajectory(spec: dict, n: int) -> np.ndarray:
    """[n, 4, 4] camera-to-world poses: forward motion with a slow yaw and a
    small vertical bob."""
    step, yaw, bob = float(spec["step_m"]), float(spec["yaw_rate"]), float(spec["bob_m"])
    poses = np.tile(np.eye(4), (n, 1, 1))
    pos = np.zeros(3)
    for i in range(n):
        c, s = math.cos(yaw * i), math.sin(yaw * i)
        poses[i, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        poses[i, :3, 3] = pos + np.array([0.0, bob * math.sin(0.7 * i), 0.0])
        pos = pos + step * np.array([s, 0.0, c])
    return poses


def _sample(tex, a, b):
    """Wrap-around bilinear fetch of tex [3, h, w] at texel coordinates."""
    h, w = tex.shape[1:]
    a = torch.remainder(a, w)
    b = torch.remainder(b, h)
    a0, b0 = torch.floor(a), torch.floor(b)
    fa, fb = (a - a0)[:, None], (b - b0)[:, None]
    a0 = a0.long() % w
    b0 = b0.long() % h
    a1, b1 = (a0 + 1) % w, (b0 + 1) % h
    t = tex.permute(1, 2, 0)
    return (t[b0, a0] * (1 - fa) * (1 - fb) + t[b0, a1] * fa * (1 - fb)
            + t[b1, a0] * (1 - fa) * fb + t[b1, a1] * fa * fb)


def render(planes, K: np.ndarray, rows: int, cols: int, T_wc: np.ndarray, scale: float,
           device) -> torch.Tensor:
    """One BGR uint8 frame [rows, cols, 3]: the nearest surface each ray
    hits, ray parameter past 0.2 m; `scale` metres a texel."""
    f64 = torch.float64
    Kinv = torch.as_tensor(np.linalg.inv(K.astype(np.float64)), device=device)
    v, u = torch.meshgrid(torch.arange(rows, dtype=f64, device=device),
                          torch.arange(cols, dtype=f64, device=device), indexing="ij")
    d_cam = torch.stack([u, v, torch.ones_like(u)], -1) @ Kinv.T
    R = torch.as_tensor(T_wc[:3, :3], device=device)
    o = torch.as_tensor(T_wc[:3, 3], device=device)
    d = (d_cam @ R.T).reshape(-1, 3)
    best = torch.full((d.shape[0],), math.inf, dtype=f64, device=device)
    color = torch.zeros((d.shape[0], 3), dtype=torch.float32, device=device)
    for axis, offset, (ta, tb), tex, ((alo, ahi), (blo, bhi)) in planes:
        den = d[:, axis]
        t = (offset - o[axis]) / torch.where(den.abs() > 1e-12, den, torch.ones_like(den))
        t = torch.where((den.abs() > 1e-12) & (t > 0.2), t, torch.full_like(t, math.inf))
        ha = o[ta] + t * d[:, ta]
        hb = o[tb] + t * d[:, tb]
        ok = (t < best) & (ha >= alo) & (ha <= ahi) & (hb >= blo) & (hb <= bhi)
        texel = _sample(tex, (ha / scale).to(torch.float32), (hb / scale).to(torch.float32))
        color = torch.where(ok[:, None], texel, color)
        best = torch.where(ok, t, best)
    return torch.clamp(color, 0, 255).to(torch.uint8).reshape(rows, cols, 3)


def make(spec: dict, camera: dict, seed: int, device):
    """[(left, right)] BGR uint8 numpy images of `spec['pairs']` poses along
    the corridor, rendered from `seed`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    planes = corridor(spec, gen, device)
    K = np.array([[camera["fx"], 0.0, camera["cx"]], [0.0, camera["fy"], camera["cy"]],
                  [0.0, 0.0, 1.0]])
    rows, cols, base = int(camera["rows"]), int(camera["cols"]), abs(float(camera["baseline"]))
    scale = float(spec["tex_scale_m"])
    out = []
    for T in trajectory(spec, int(spec["pairs"])):
        T_r = T.copy()
        T_r[:3, 3] = T[:3, 3] + T[:3, 0] * base
        out.append(tuple(render(planes, K, rows, cols, P, scale, device).cpu().numpy()
                         for P in (T, T_r)))
    return out
