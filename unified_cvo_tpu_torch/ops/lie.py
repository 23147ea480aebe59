"""SO(3)/SE(3) Lie-group operations on tensors (port of unified_cvo_tpu/ops/lie.py).

Reference: src/cvo/LieGroup.cpp:203-283, include/UnifiedCvo/cvo/LieGroup.h:14-70.
Small-angle branches are Taylor expansions chosen with `torch.where` over
guarded operands, so everything stays on the device with no host branch.

`mm` arguments take the matrix product (default torch.matmul);
`lanewise_matmul` is the product that a loop over lanes uses (align_batch):
each lane's product is the unbatched one, bit for bit, where a batched
product may round differently.

Conventions: se(3) tangent vectors are [omega(3), v(3)]; `se3_exp(xi, dt)`
integrates the flow for time dt: R = exp(dt w^), t = Jl(dt, w) v with
Jl = dt I + ((1 - cos(dt th)) / th^2) w^ + ((dt th - sin(dt th)) / th^3) w^2
(reference Exp_SEK3, LieGroup.cpp:245-275).
"""

from __future__ import annotations

import torch

_EPS = 1e-6  # reference TOLERANCE (LieGroup.cpp:9)


def lanewise_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over a leading lane axis, one unbatched product a lane."""
    return torch.stack([a[i] @ b[i] for i in range(a.shape[0])])


def skew(w: torch.Tensor) -> torch.Tensor:
    """3-vector -> skew-symmetric matrix (reference LieGroup.h:14-23)."""
    zero = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], zero, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )


def unskew(M: torch.Tensor) -> torch.Tensor:
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)


def _safe_theta(w):
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < _EPS * _EPS
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    return torch.where(small, torch.zeros_like(theta), theta), theta2, small


def _bc(s):
    return s[..., None, None]


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula (reference LieGroup.cpp:203-213, Exp_SO3)."""
    theta, theta2, small = _safe_theta(w)
    st = torch.where(small, torch.ones_like(theta), theta)
    A = skew(w)
    k1 = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(st) / st)
    k2 = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(st)) / (st * st))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + _bc(k1) * A + _bc(k2) * (A @ A)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues (reference LieGroup.cpp:121-127, Log_SO3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    small = cos_theta > 1.0 - _EPS
    safe_cos = torch.where(small, torch.zeros_like(cos_theta), cos_theta)
    theta = torch.arccos(safe_cos)
    sin_theta = torch.sin(theta)
    coef = torch.where(
        small,
        0.5 + (1.0 - cos_theta) / 6.0,
        theta / torch.where(small, torch.ones_like(sin_theta), 2.0 * sin_theta),
    )
    return unskew(_bc(coef) * (R - R.transpose(-1, -2)))


def se3_exp(xi: torch.Tensor, dt=1.0, mm=torch.matmul):
    """Integrate the twist xi = [w, v] for time dt -> (R [3,3], t [3]).
    `dt` may be a Python float or a tensor on xi's device; with a leading
    batch shape, xi [..., 6] and dt [...] (one time each) give [..., 3, 3]
    and [..., 3]."""
    w, v = xi[..., :3], xi[..., 3:6]
    theta, theta2, small = _safe_theta(w)
    st = torch.where(small, torch.ones_like(theta), theta)
    dtt = dt * st
    A = skew(w)
    A2 = mm(A, A)
    k1 = torch.where(small, dt * (1.0 - dt * dt * theta2 / 6.0), torch.sin(dtt) / st)
    k2 = torch.where(small, 0.5 * dt * dt * torch.ones_like(st),
                     (1.0 - torch.cos(dtt)) / (st * st))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + _bc(k1) * A + _bc(k2) * A2
    b = torch.where(small, dt ** 3 / 6.0 * torch.ones_like(st),
                    (dtt - torch.sin(dtt)) / (st ** 3))
    Jl = (_bc(dt) if isinstance(dt, torch.Tensor) else dt) * eye + _bc(k2) * A + _bc(b) * A2
    t = mm(Jl, v[..., None])[..., 0]
    return R, t


def left_jacobian_inv(w: torch.Tensor, mm=torch.matmul) -> torch.Tensor:
    """Inverse left Jacobian of SO(3), used by se3_log."""
    theta, theta2, small = _safe_theta(w)
    st = torch.where(small, torch.ones_like(theta), theta)
    half = st / 2.0
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half)
         / torch.where(small, torch.ones_like(half), torch.sin(half))) / (st * st),
    )
    A = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye - 0.5 * A + _bc(cot_term) * mm(A, A)


def se3_log(R: torch.Tensor, t: torch.Tensor, mm=torch.matmul) -> torch.Tensor:
    """(R, t) -> xi = [w, v] with exp([w, v]) == (R, t)."""
    w = so3_log(R)
    v = mm(left_jacobian_inv(w, mm), t[..., None])[..., 0]
    return torch.cat([w, v], dim=-1)


def se3_distance(R: torch.Tensor, t: torch.Tensor, mm=torch.matmul) -> torch.Tensor:
    """||log(R, t)||: the per-iteration step distance tested against eps_2
    (reference CvoGPU.cu:1477-1484)."""
    return torch.linalg.vector_norm(se3_log(R, t, mm), dim=-1)


def invert_rt(R: torch.Tensor, t: torch.Tensor, mm=torch.matmul):
    """(R, t) -> (R^T, -R^T t) (reference update_tf, CvoGPU.cu:94-112)."""
    Rinv = R.transpose(-1, -2)
    return Rinv, -mm(Rinv, t[..., None])[..., 0]


def transform_points(R: torch.Tensor, t: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """x -> R x + t on an [N, 3] array (leading axes broadcast)."""
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def orthogonalize(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation onto SO(3): two Newton sweeps of
    R (3I - R^T R) / 2, cheap drift control for long float32 pose chains."""
    for _ in range(2):
        R = 1.5 * R - 0.5 * R @ R.transpose(-1, -2) @ R
    return R


def rt_to_mat44(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    # filled on the device: no host-to-device copy inside the align loop
    out = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    out[..., :3, :3] = R
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def mat44_to_rt(T: torch.Tensor):
    return T[..., :3, :3], T[..., :3, 3]
