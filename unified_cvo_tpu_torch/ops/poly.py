"""Closed-form cubic root solve for the 4th-order Taylor step size
(port of unified_cvo_tpu/ops/poly.py).

The reference forms p(x) = 4E x^3 + 3D x^2 + 2C x + B and picks the smallest
positive real root (src/cvo/CvoGPU.cu:1128-1163, LieGroup.cpp:290-340). The
cubic is solved with real arithmetic only: the trigonometric method when the
discriminant says three real roots, Cardano's single real root otherwise,
with quadratic and linear fallbacks, every branch chosen by `torch.where`.
"""

from __future__ import annotations

import math

import torch

_TINY = 1e-30


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    # torch has no cbrt: sign(x) |x|^(1/3)
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _f32(v, device) -> torch.Tensor:
    # a Python number becomes a device fill, never a host-to-device copy
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)


def cubic_real_roots(a, b, c, d):
    """Real roots of a x^3 + b x^2 + c x + d.

    Returns (roots [3], valid [3]); invalid lanes hold +inf. Degenerate
    leading coefficients fall back to the quadratic / linear solve.
    Coefficients with a leading batch shape give roots and valid of that
    shape + [3]."""
    ref = next((v for v in (a, b, c, d) if isinstance(v, torch.Tensor)), None)
    dev = None if ref is None else ref.device
    a, b, c, d = (_f32(v, dev) for v in (a, b, c, d))
    inf = torch.full((), math.inf, dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)

    def vec(*xs):
        return torch.stack(torch.broadcast_tensors(*(_f32(x, dev) for x in xs)), dim=-1)

    def col(v):
        return v[..., None]          # a batch value against the roots' last axis

    lane = torch.arange(3, device=dev)
    all3 = lane >= 0
    first = lane == 0

    # ---- cubic path (|a| meaningful) ----
    safe_a = torch.where(torch.abs(a) < _TINY, one, a)
    bn, cn, dn = b / safe_a, c / safe_a, d / safe_a
    # depressed cubic t^3 + p t + q, x = t - bn/3
    shift = bn / 3.0
    p = cn - bn * bn / 3.0
    q = 2.0 * bn ** 3 / 27.0 - bn * cn / 3.0 + dn
    disc = -4.0 * p ** 3 - 27.0 * q * q   # > 0 -> three distinct real roots

    # trig method (requires p < 0)
    safe_p = torch.minimum(p, -_TINY * one)
    m = 2.0 * torch.sqrt(-safe_p / 3.0)
    arg = torch.clamp(3.0 * q / (safe_p * m), -1.0, 1.0)
    theta = torch.arccos(arg) / 3.0
    two_pi_3 = 2.0 * math.pi / 3.0
    trig_roots = vec(m * torch.cos(theta), m * torch.cos(theta - two_pi_3),
                     m * torch.cos(theta - 2.0 * two_pi_3)) - col(shift)

    # Cardano single real root (disc <= 0)
    rad = torch.sqrt(torch.clamp(q * q / 4.0 + p ** 3 / 27.0, min=0.0))
    cardano_root = _cbrt(-q / 2.0 + rad) + _cbrt(-q / 2.0 - rad) - shift

    three_real = col(disc > 0)
    cubic_roots = torch.where(three_real, trig_roots, vec(cardano_root, inf, inf))
    cubic_valid = torch.where(three_real, all3, first)

    # ---- quadratic fallback b x^2 + c x + d (a ~ 0) ----
    safe_b = torch.where(torch.abs(b) < _TINY, one, b)
    qdisc = c * c - 4.0 * b * d
    sq = torch.sqrt(torch.clamp(qdisc, min=0.0))
    quad_roots = vec((-c + sq) / (2.0 * safe_b), (-c - sq) / (2.0 * safe_b), inf)
    quad_ok = qdisc >= 0
    quad_valid = torch.stack([quad_ok, quad_ok, torch.zeros_like(quad_ok)], dim=-1)

    # ---- linear fallback c x + d (a ~ 0, b ~ 0) ----
    safe_c = torch.where(torch.abs(c) < _TINY, one, c)
    lin_roots = vec(-d / safe_c, inf, inf)
    lin_valid = first & col(torch.abs(c) >= _TINY)

    use_quad = col(torch.abs(a) < _TINY)
    use_lin = use_quad & col(torch.abs(b) < _TINY)
    roots = torch.where(use_lin, lin_roots,
                        torch.where(use_quad, quad_roots, cubic_roots))
    valid = torch.where(use_lin, lin_valid,
                        torch.where(use_quad, quad_valid, cubic_valid))
    roots = torch.where(torch.isfinite(roots) & valid, roots, inf)
    return roots, valid


def step_from_poly(B, C, D, E, min_step: float, max_step: float) -> torch.Tensor:
    """Smallest positive real root of 4E t^3 + 3D t^2 + 2C t + B, clamped to
    [min_step, max_step]; no positive root leaves +inf, which the clamp maps
    to max_step (reference compute_step_size, CvoGPU.cu:1128-1163). Batched
    coefficients give one step each."""
    roots, _ = cubic_real_roots(4.0 * E, 3.0 * D, 2.0 * C, B)
    pos = torch.where(roots > 0, roots, torch.full_like(roots, math.inf))
    return torch.clamp(torch.amin(pos, dim=-1), min_step, max_step)
