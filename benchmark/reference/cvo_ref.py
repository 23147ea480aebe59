"""Plain reference of one iteration of CVO's ELL solve loop: the K-nearest
candidate list, the flow moments, the quartic step coefficients and the
pose update, plus the pose error against a known motion.

It follows the upstream CUDA `CvoGPU` iteration (fill_in_A_mat_gpu, the
flow and step reductions of CvoGPU.cu, compute_step_size, Exp_SEK3) in the
layout the measured package uses: a list of K = 32 target slots a source
point, built from a 64 x 32 x 64 voxel table of the moved targets with 8
targets a cell, the 27-cell pool of each source point, and the K nearest
within its support radius plus a skin, nearest first, ties to the earlier
pool position. The list is computed in float32 with the same operations
as the package, so that it comes out slot for slot; the sums that follow
are taken in float64, so the gap to the package is the package's own
rounding. It imports nothing of the measured package.

`prec="tf32"` is the control: every operand of a product of the rigid
transforms (the poses and the coordinates they move, the 3 x 3 products of
the pose update) rounded to TF32's 10-bit mantissa first, as a TF32 matrix
product rounds them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

DEAD_COORD = 1e9
K_SLOTS = 32
SKIN = 0.5
PER_CELL = 8
GRID_DIMS = (64, 32, 64)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 value (10 mantissa bits,
    ties to even), as the tensor cores round a TF32 product's operands."""
    i = x.contiguous().to(torch.float32).view(torch.int32).to(torch.int64)
    lsb = (i >> 13) & 1
    i = (i + 0xFFF + lsb) & ~0x1FFF
    return ((i + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32).view(torch.float32)


def rounder(prec: str):
    if prec == "fp32":
        return lambda t: t
    if prec == "tf32":
        return tf32
    raise ValueError(f"unknown precision {prec!r}")


def constants(p: dict):
    """(sigma^2, sp_thres, log(sp_thres / sigma^2)) rounded to float32."""
    sigma2 = torch.tensor(p["sigma"], dtype=torch.float32) ** 2
    sp = torch.tensor(p["sp_thres"], dtype=torch.float32)
    return float(sigma2), float(sp), float(torch.log(sp / sigma2))


def range_ell(ell, r):
    return (r / 500.0 + 1.0) * ell


def _norm(xyz):
    return torch.sqrt(torch.sum(xyz * xyz, dim=-1))


def moved(xyz, R, T, rnd):
    """R xyz + T, one component at a time (float32)."""
    xyz, R, T = rnd(xyz), rnd(R), rnd(T)
    return torch.stack([xyz[:, 0] * R[c, 0] + xyz[:, 1] * R[c, 1] + xyz[:, 2] * R[c, 2] + T[c]
                        for c in range(3)], dim=-1)


def _extent(xyz, mask):
    m = (mask > 0)[:, None]
    return (torch.amin(torch.where(m, xyz, torch.full_like(xyz, math.inf)), dim=0),
            torch.amax(torch.where(m, xyz, torch.full_like(xyz, -math.inf)), dim=0))


def candidate_list(p: dict, ell, x, xm, y, ym, R_inv, T_inv, prec="fp32",
                   k=K_SLOTS, skin=SKIN, P=PER_CELL, dims=GRID_DIMS):
    """(idx [K, N] int32, slots [3, K, N] raw target xyz, DEAD_COORD on dead
    slots) of source x [N, 3] (mask xm) against target y [M, 3] (mask ym)
    moved by (R_inv, T_inv), at lengthscale ell."""
    rnd = rounder(prec)
    f32 = torch.float32
    dev = x.device
    gx, gy, gz = dims
    n_cells = gx * gy * gz
    M = y.shape[0]
    log_term = constants(p)[2]
    l_i = range_ell(ell, _norm(x))
    r_i = torch.sqrt(torch.clamp(-2.0 * l_i * l_i * log_term, min=0.0)) + skin
    r_max = torch.amax(torch.where(xm > 0, r_i, torch.zeros_like(r_i)))
    y_t = moved(y, R_inv, T_inv, rnd)
    lo_t, hi_t = _extent(y_t, ym)
    lo_x, hi_x = _extent(x, xm)
    lo, hi = torch.minimum(lo_t, lo_x), torch.maximum(hi_t, hi_x)
    g = torch.stack([torch.full((), float(v), dtype=f32, device=dev) for v in dims])
    cell = torch.maximum((hi - lo) / g, r_max)

    def coords(pts):
        c = torch.floor((pts - lo) / cell).to(torch.int32)
        return torch.stack([torch.clamp(c[:, a], 0, d - 1) for a, d in enumerate(dims)], 1)

    ct = coords(y_t)
    key = torch.where(ym > 0, (ct[:, 0] * gy + ct[:, 1]) * gz + ct[:, 2], n_cells)
    order = torch.argsort(key, stable=True)
    ks = key[order]
    ar = torch.arange(M, device=dev)
    first = torch.ones_like(ks, dtype=torch.bool)
    first[1:] = ks[1:] != ks[:-1]
    start, _ = torch.cummax(torch.where(first, ar, torch.zeros_like(ar)), dim=0)
    rank = ar - start
    ok = rank < P
    tab = torch.full((n_cells + 1, 4, P), -1.0, dtype=f32, device=dev)
    ys = y[order]
    for c, v in enumerate((ys[:, 0], ys[:, 1], ys[:, 2], order.to(f32))):
        tab[torch.where(ok, ks.long(), n_cells), c, torch.where(ok, rank, P - 1)] = \
            torch.where(ok, v, torch.full_like(v, -1.0))
    tab[n_cells] = -1.0
    # the 27-cell pool of each source point, cells in dx, dy, dz order
    cb = coords(x)
    o = torch.arange(27, device=dev)
    off = torch.stack([o // 9, (o // 3) % 3, o % 3], 1) - 1            # [27, 3]
    cc = cb[:, None, :] + off[None]                                    # [N, 27, 3]
    inside = torch.all((cc >= 0) & (cc < torch.tensor(dims, device=dev)), dim=-1)
    cid = torch.where(inside, (cc[..., 0] * gy + cc[..., 1]) * gz + cc[..., 2], n_cells)
    pool = tab[cid.long()]                                             # [N, 27, 4, P]
    N = x.shape[0]
    comp = [pool[:, :, c, :].reshape(N, -1) for c in range(4)]
    cand = comp[3].to(torch.int32)
    Rr, Tr = rnd(R_inv), rnd(T_inv)
    cx, cy_, cz = (rnd(v) for v in comp[:3])
    yt = [cx * Rr[c, 0] + cy_ * Rr[c, 1] + cz * Rr[c, 2] + Tr[c] for c in range(3)]
    r2 = torch.where(xm > 0, r_i * r_i, torch.full_like(r_i, -1.0))
    d2 = ((x[:, 0:1] - yt[0]) ** 2 + (x[:, 1:2] - yt[1]) ** 2 + (x[:, 2:3] - yt[2]) ** 2)
    keep = (cand >= 0) & (d2 <= r2[:, None])
    key = torch.where(keep, d2, torch.full_like(d2, math.inf))
    key_s, pos = torch.sort(key, dim=1, stable=True)
    pos = pos[:, :k]
    valid = torch.isfinite(key_s[:, :k]).T
    take = [torch.gather(c, 1, pos).T for c in comp]
    idx = torch.where(valid, take[3].to(torch.int32), -1)
    slots = torch.where(valid[None], torch.stack(take[:3]), DEAD_COORD)
    return idx, slots


class Moments(NamedTuple):
    joint: torch.Tensor        # [6] float64 (sum omega / c, sum v / d)
    nonzeros: torch.Tensor     # [] int64
    a_sum: torch.Tensor        # [] float64
    coeffs: torch.Tensor       # [4] float64 step coefficients B, C, D, E
    joint_scale: torch.Tensor  # [6] the sums of the summands' magnitudes of joint
    coeff_scale: torch.Tensor  # [4] the same of coeffs: what a sum's rounding scales with


def _point_rows(p, ell, x, xm):
    """Per source point: -1 / (2 l_i^2), the gate on d2, 1 / (2 ell^2)."""
    log_term = constants(p)[2]
    l_i = range_ell(ell, _norm(x))
    two_l2 = 2.0 * l_i * l_i
    thres = torch.where(xm > 0, -two_l2 * log_term, torch.full_like(two_l2, -1.0))
    step_l = l_i if p["is_using_range_ell"] else ell * torch.ones_like(l_i)
    return -1.0 / two_l2, thres, 1.0 / (2.0 * step_l * step_l)


def moments(p: dict, ell, x, xm, slots, R_inv, T_inv, prec="fp32", unit=None) -> Moments:
    """Flow moments and step coefficients of one iteration on the list
    `slots` [3, K, N], the pose (R_inv, T_inv) and the lengthscale ell.
    The kernel values are gated as fill_in_A_mat_gpu gates them (d2 below
    the support, a above sp_thres); the sums run in float64. The step
    coefficients are taken along `unit` (a given unit twist [6], as the
    step pass takes the flow pass's) or along this flow's own."""
    rnd = rounder(prec)
    f64 = torch.float64
    sigma2, sp, _ = constants(p)
    negi, thres, coef = (v.to(f64) for v in _point_rows(p, ell, x, xm))
    R, T = rnd(R_inv).to(f64), rnd(T_inv).to(f64)
    y = [rnd(slots[c]).to(f64) for c in range(3)]
    yt = [y[0] * R[c, 0] + y[1] * R[c, 1] + y[2] * R[c, 2] + T[c] for c in range(3)]
    xs = [x[:, c].to(f64) for c in range(3)]
    d2 = sum((xs[c] - yt[c]) ** 2 for c in range(3))
    kgeo = sigma2 * torch.exp(d2 * negi)
    a = torch.where((d2 < thres) & (kgeo > sp), kgeo, torch.zeros_like(kgeo))
    s = a.sum(0)
    wy = [torch.sum(a * yt[c], 0) for c in range(3)]
    om = [xs[(i + 1) % 3] * wy[(i + 2) % 3] - xs[(i + 2) % 3] * wy[(i + 1) % 3]
          for i in range(3)]
    v = [wy[i] - s * xs[i] for i in range(3)]
    t = torch.stack([r.sum() for r in om + v])
    div = torch.tensor([p["c"]] * 3 + [p["d"]] * 3, dtype=f64, device=t.device)
    joint = t / div
    joint_scale = torch.stack([r.abs().sum() for r in om + v]) / div
    if unit is None:
        jn = torch.linalg.vector_norm(joint)
        unit = joint / (jn if jn >= 1e-30 else 1.0)
    unit = unit.to(f64)
    # the fourth-order Taylor coefficients of the inner product along the
    # unit twist: d/dt^n of sum a exp(-|x - exp(t xi) y|^2 / (2 ell^2))
    w, vv = unit[:3], unit[3:]
    yz = [torch.where(a > 0, yc, torch.zeros_like(yc)) for yc in yt]
    Wy = [w[(i + 1) % 3] * yz[(i + 2) % 3] - w[(i + 2) % 3] * yz[(i + 1) % 3] for i in range(3)]
    xi1 = [Wy[i] + vv[i] for i in range(3)]                           # xi y
    W2y = [w[(i + 1) % 3] * Wy[(i + 2) % 3] - w[(i + 2) % 3] * Wy[(i + 1) % 3] for i in range(3)]
    Wv = torch.linalg.cross(w, vv)
    xi2 = [W2y[i] + Wv[i] for i in range(3)]                          # xi^2 y
    W3y = [w[(i + 1) % 3] * W2y[(i + 2) % 3] - w[(i + 2) % 3] * W2y[(i + 1) % 3] for i in range(3)]
    W2v = torch.linalg.cross(w, Wv)
    xi3 = [W3y[i] + W2v[i] for i in range(3)]                         # xi^3 y
    om2 = torch.dot(w, w)
    xi4 = [-om2 * xi2[i] for i in range(3)]                           # xi^4 y = -|w|^2 xi^2 y
    diff = [xs[i] - yz[i] for i in range(3)]

    def dot(u, q):
        return u[0] * q[0] + u[1] * q[1] + u[2] * q[2]

    cf = coef
    beta = -2.0 * cf * dot(diff, xi1)
    gamma = -cf * (dot(xi1, xi1) + 2.0 * dot(diff, xi2))
    delta = 2.0 * cf * (-dot(xi1, xi2) - dot(diff, xi3))
    epsil = -cf * (dot(xi2, xi2) + 2.0 * dot(xi1, xi3) + 2.0 * dot(diff, xi4))
    b2 = beta * beta
    terms = [a * beta, a * (gamma + 0.5 * b2), a * (delta + beta * gamma + b2 * beta / 6.0),
             a * (epsil + beta * delta + 0.5 * b2 * gamma + 0.5 * gamma * gamma + b2 * b2 / 24.0)]
    return Moments(joint=joint, nonzeros=torch.sum(a > 0), a_sum=s.sum(),
                   coeffs=torch.stack([q.sum() for q in terms]), joint_scale=joint_scale,
                   coeff_scale=torch.stack([q.abs().sum() for q in terms]))


def _skew(w):
    z = torch.zeros((), dtype=w.dtype, device=w.device)
    return torch.stack([torch.stack([z, -w[2], w[1]]), torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def se3_exp(xi, dt):
    """(R, t) = exp(dt xi^) in float64, xi = [omega, v] (Exp_SEK3)."""
    w, v = xi[:3], xi[3:]
    th = float(torch.linalg.vector_norm(w))
    A = _skew(w)
    A2 = A @ A
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    if th < 1e-6:
        k1, k2, b = dt * (1 - dt * dt * th * th / 6), 0.5 * dt * dt, dt ** 3 / 6
    else:
        k1 = math.sin(dt * th) / th
        k2 = (1 - math.cos(dt * th)) / th ** 2
        b = (dt * th - math.sin(dt * th)) / th ** 3
    R = eye + k1 * A + k2 * A2
    J = dt * eye + k2 * A + b * A2
    return R, J @ v


def step_size(coeffs, min_step: float, max_step: float) -> float:
    """The smallest positive real root of 4E t^3 + 3D t^2 + 2C t + B,
    clamped to [min_step, max_step] (compute_step_size, CvoGPU.cu)."""
    B, C, D, E = (float(c) for c in coeffs)
    roots = [r.real for r in _cubic(4 * E, 3 * D, 2 * C, B) if abs(r.imag) < 1e-9 * (1 + abs(r))]
    pos = [r for r in roots if r > 0]
    return min(max(min(pos) if pos else math.inf, min_step), max_step)


def _cubic(a, b, c, d):
    """Complex roots of a x^3 + b x^2 + c x + d, falling back to the
    quadratic and linear cases as the leading coefficients vanish."""
    import numpy as np

    if abs(a) < 1e-30:
        if abs(b) < 1e-30:
            return [complex(-d / c)] if abs(c) >= 1e-30 else []
        return [complex(r) for r in np.roots([b, c, d])]
    return [complex(r) for r in np.roots([a, b, c, d])]


def pose_update(p: dict, R, T, joint, coeffs, prec="fp32"):
    """(R', T') after one iteration from the loop's pose (R, T) and this
    iteration's moments: no update after a degenerate flow, else the unit
    twist integrated over the step size, R' = R dR, T' = R dT + T."""
    rnd = rounder(prec)
    jn = float(torch.linalg.vector_norm(joint))
    R64, T64 = R.to(torch.float64), T.to(torch.float64)
    if jn < 1e-8 or math.isnan(jn):
        return R64, T64
    step = step_size(coeffs, p["min_step"], p["max_step"])
    dR, dT = se3_exp(joint / jn, step)
    Rr = rnd(R.to(torch.float32)).to(torch.float64)
    dRr = rnd(dR.to(torch.float32)).to(torch.float64) if prec != "fp32" else dR
    dTr = rnd(dT.to(torch.float32)).to(torch.float64) if prec != "fp32" else dT
    return Rr @ dRr, Rr @ dTr + T64


def so3_log(R):
    cos = min(max((float(torch.trace(R)) - 1.0) / 2.0, -1.0), 1.0)
    th = math.acos(cos)
    W = R - R.T
    k = 0.5 + th * th / 12.0 if th < 1e-6 else th / (2.0 * math.sin(th))
    return k * torch.stack([W[2, 1], W[0, 2], W[1, 0]])


def se3_log(T44):
    """The twist [omega, v] of a 4 x 4 rigid transform (float64)."""
    T44 = T44.to(torch.float64)
    R, t = T44[:3, :3], T44[:3, 3]
    w = so3_log(R)
    th = float(torch.linalg.vector_norm(w))
    A = _skew(w)
    eye = torch.eye(3, dtype=torch.float64, device=T44.device)
    if th < 1e-6:
        Vinv = eye - 0.5 * A + A @ A / 12.0
    else:
        h = th / 2.0
        Vinv = eye - 0.5 * A + (1.0 - h * math.cos(h) / math.sin(h)) / th ** 2 * (A @ A)
    return torch.cat([w, Vinv @ t])


def pose_error(T_rel, T_true) -> float:
    """|log(T_rel T_true)|: zero when the registration returned exactly the
    inverse of the true motion (the package's convention)."""
    return float(torch.linalg.vector_norm(se3_log(T_rel.to(torch.float64)
                                                  @ T_true.to(torch.float64))))
