"""Kernel helpers shared by the ELL and dense passes, and the blocked plain
PyTorch passes of the dense 'jnp' backend (port of the parts of
unified_cvo_tpu/ops/kernels.py that the ported slices run).

`kernel_block`, `flow_stats` and `step_coeffs` stream the N x M kernel
matrix over target chunks without materialising it; they run on any device,
as the JAX package runs its blocked-XLA passes outside Pallas. They are the
'jnp' backend of models/align.py and the oracle of the dense tiled kernels
(ops/dense.py). `weighted_d2_sum` feeds the adaptive-ell gradient of the
dense backends; `kernel_block_dense`, `association_topk(_dense)` and
`least_square_flow` serve the analysis entry points of models/align.py and
the tests. JAX computes every one of them in jnp, outside Pallas.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from unified_cvo_tpu_torch.ops import lie
from unified_cvo_tpu_torch.utils.pointcloud import PointCloud

DEFAULT_CHUNK = 2048


def geometric_constants(params):
    """(sigma^2, sp_thres, log(sp_thres / sigma^2)) rounded to float32 as
    the JAX package computes them, returned as Python floats (exact f32
    values) so that no host-to-device copy is needed to use them."""
    sigma2 = torch.tensor(params.sigma, dtype=torch.float32) ** 2
    sp = torch.tensor(params.sp_thres, dtype=torch.float32)
    return float(sigma2), float(sp), float(torch.log(sp / sigma2))


def range_ell(ell, dist_to_sensor):
    """compute_range_ell (reference CvoGPU.cu:87-90)."""
    return (dist_to_sensor / 500.0 + 1.0) * ell


def pad_cloud_to_multiple(pc: PointCloud, multiple: int) -> PointCloud:
    """Zero-pad (mask = 0) a cloud so capacity % multiple == 0."""
    n = pc.capacity
    extra = ((n + multiple - 1) // multiple) * multiple - n
    if extra == 0:
        return pc

    def pad(a):
        return None if a is None else F.pad(a, (0, 0) * (a.dim() - 1) + (0, extra))

    return dataclasses.replace(
        pc, xyz=pad(pc.xyz), mask=pad(pc.mask), features=pad(pc.features),
        labels=pad(pc.labels), geometric_types=pad(pc.geometric_types))


class FlowStats(NamedTuple):
    row_sum: torch.Tensor    # [N]   s_i = sum_j A_ij
    row_wy: torch.Tensor     # [N,3] w_i = sum_j A_ij y_j
    nonzeros: torch.Tensor   # scalar count of A_ij > sp_thres
    a_sum: torch.Tensor      # scalar sum of A (the RKHS inner product value)


def flow_from_stats(params, x: PointCloud, stats: FlowStats, reduce=None):
    """se(3) gradient flow (reference compute_flow, CvoGPU.cu:729-848).

    Returns (unit_twist [6], joint_norm): [omega, v] jointly normalized, and
    the pre-normalization magnitude used for the degeneracy test. When x is
    a source-point shard (ring-sharded align), `reduce` sums the joint
    6-vector over the shards before the normalization (JAX's psum_axis)."""
    omega = torch.sum(torch.linalg.cross(x.xyz, stats.row_wy, dim=-1), dim=0) / params.c
    v = torch.sum(stats.row_wy - stats.row_sum[:, None] * x.xyz, dim=0) / params.d
    joint = torch.cat([omega, v])
    if reduce is not None:
        joint = reduce(joint)
    jn = torch.linalg.vector_norm(joint)
    unit = joint / torch.where(jn < 1e-30, torch.ones_like(jn), jn)
    return unit, jn


def channel_constants(ell: float, sigma: float, sp_thres: float):
    """(sigma^2, distance gate -2 ell^2 log(sp_thres / sigma^2), 2 ell^2) of
    a channel kernel, rounded to float32 as the JAX package computes them and
    returned as Python floats (exact f32 values)."""
    f32 = torch.float32
    e, s = torch.tensor(ell, dtype=f32), torch.tensor(sigma, dtype=f32)
    ell2, sigma2 = e * e, s * s
    thres = -2.0 * ell2 * torch.log(torch.tensor(sp_thres, dtype=f32) / sigma2)
    return float(sigma2), float(thres), float(2.0 * ell2)


def _mm(a, b):
    """f32 matmul; TF32 is off for the whole package (its __init__), as the
    JAX package pins HIGHEST precision for these reductions."""
    return torch.matmul(a, b)


def _slice_cloud(pc: PointCloud, start: int, size: int) -> PointCloud:
    def sl(a):
        return None if a is None else a[start:start + size]

    return PointCloud(xyz=sl(pc.xyz), mask=sl(pc.mask), features=sl(pc.features),
                      labels=sl(pc.labels), geometric_types=sl(pc.geometric_types))


def kernel_block(params, ell, x: PointCloud, yb: PointCloud) -> torch.Tensor:
    """One [I, J] tile of the sparsified kernel matrix A (fill_in_A_mat_gpu,
    CvoGPU.cu:477-593): geometric SE kernel with range-scaled lengthscale,
    colour kernel, semantic kernel and geometric-type cosine^2 gate, each
    with its own distance gate, then the sp_thres sparsification. Gated and
    masked entries are exactly 0."""
    # in-place where a fresh tile would only be copied: the same operations
    # in the same order, with fewer [I, J] allocations on the CPU
    xp, yp = x.xyz, yb.xyz
    a = None
    ok = (x.mask[:, None] > 0) & (yb.mask[None, :] > 0)
    sigma2, sp, log_term = geometric_constants(params)

    if params.is_using_geometric_type:
        xg, yg = x.geometric_types, yb.geometric_types
        dot = _mm(xg, yg.T)
        n2x = torch.sum(xg * xg, -1)[:, None]
        n2y = torch.sum(yg * yg, -1)[None, :]
        a = dot.mul_(dot).div_(torch.clamp(n2x * n2y, min=1e-12))
        ok &= a >= 0.01                  # gate (CvoGPU.cu:541-542)

    if params.is_using_geometry:
        # explicit coordinate differences: no |x|^2 cancellation at small d2
        d2 = (xp[:, 0:1] - yp[None, :, 0]).square_()
        for c in (1, 2):
            d2 += (xp[:, c:c + 1] - yp[None, :, c]).square_()
        l_i = range_ell(ell, torch.sqrt(torch.sum(xp * xp, -1)))[:, None]
        two_l2 = 2.0 * l_i * l_i
        ok &= d2 < -two_l2 * log_term
        # exponents below the gate's log term minus one are gated out: the
        # clamp keeps every kept entry and spares the CPU's slow path of exp
        # far below zero
        e = d2.neg_().div_(two_l2).clamp_(min=log_term - 1.0).exp_()
        a = e.mul_(sigma2) if a is None else a.mul_(sigma2).mul_(e)

    for on, f_x, f_y, ell_c, sigma_c in (
            (params.is_using_intensity, x.features, yb.features, params.c_ell, params.c_sigma),
            (params.is_using_semantics, x.labels, yb.labels, params.s_ell, params.s_sigma)):
        if not on:
            continue
        sig2, thres, two_ell2 = channel_constants(ell_c, sigma_c, params.sp_thres)
        d2c = (torch.sum(f_x * f_x, -1)[:, None] + torch.sum(f_y * f_y, -1)[None, :])
        d2c = d2c.sub_(_mm(f_x, f_y.T).mul_(2.0)).clamp_(min=0.0)
        ok &= d2c < thres
        e = d2c.neg_().div_(two_ell2).clamp_(min=-thres / two_ell2 - 1.0).exp_()
        a = e.mul_(sig2) if a is None else a.mul_(sig2).mul_(e)

    if a is None:
        a = torch.ones(ok.shape, dtype=torch.float32, device=xp.device)
    ok &= a > sp
    return a.masked_fill_(~ok, 0.0)


def flow_stats(params, ell, x: PointCloud, y_t: PointCloud,
               chunk: int = DEFAULT_CHUNK) -> FlowStats:
    """Streaming pass 1: kernel row statistics over target chunks."""
    chunk = min(chunk, y_t.capacity)
    y_t = pad_cloud_to_multiple(y_t, chunk)
    N, dev = x.capacity, x.xyz.device
    s = torch.zeros((N,), dtype=torch.float32, device=dev)
    w = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    cnt = torch.zeros((), dtype=torch.int64, device=dev)
    asum = torch.zeros((), dtype=torch.float32, device=dev)
    for c in range(y_t.capacity // chunk):
        yb = _slice_cloud(y_t, c * chunk, chunk)
        a = kernel_block(params, ell, x, yb)
        s = s + torch.sum(a, dim=1)
        w = w + _mm(a, yb.xyz)
        cnt = cnt + torch.sum(a > 0)
        asum = asum + torch.sum(a)
    return FlowStats(s, w, cnt.to(torch.int32), asum)


def step_coeffs(params, ell, x: PointCloud, y_t: PointCloud, twist,
                chunk: int = DEFAULT_CHUNK):
    """Streaming pass 2: quartic Taylor coefficients (B, C, D, E)
    (compute_step_size_xi + compute_step_size_poly_coeff, CvoGPU.cu:953-1082).
    The per-pair dots xi{1..4}z_j . (x_i - y_j) decompose as
    X @ xi{k}z^T minus a per-target dot."""
    chunk = min(chunk, y_t.capacity)
    y_t = pad_cloud_to_multiple(y_t, chunk)
    omega, v = twist[:3], twist[3:]
    W = lie.skew(omega)
    W2 = W @ W
    W3 = W2 @ W
    W4 = W2 @ W2
    y = y_t.xyz
    # per-target flow derivatives (compute_step_size_xi)
    xiz = y @ W.T + v
    xi2z = y @ W2.T + W @ v
    xi3z = y @ W3.T + W2 @ v
    xi4z = y @ W4.T + W3 @ v
    normxiz2 = torch.sum(xiz * xiz, -1)
    xdx2 = -torch.sum(xiz * xi2z, -1)
    epsc = torch.sum(xi2z * xi2z, -1) + 2.0 * torch.sum(xiz * xi3z, -1)
    xis = (xiz, xi2z, xi3z, xi4z)
    ydots = [torch.sum(y * xi, -1) for xi in xis]   # the "- y_j" half of each dot

    xp = x.xyz
    if params.is_using_range_ell:
        l_i = range_ell(ell, torch.sqrt(torch.sum(xp * xp, -1)))
    else:
        l_i = ell * torch.ones((x.capacity,), dtype=torch.float32, device=xp.device)
    coef = (1.0 / (2.0 * l_i * l_i))[:, None]

    B = C = D = E = torch.zeros((), dtype=torch.float32, device=xp.device)
    for c in range(y_t.capacity // chunk):
        lo, hi = c * chunk, (c + 1) * chunk
        a = kernel_block(params, ell, x, _slice_cloud(y_t, lo, chunk))
        d1, d2_, d3, d4 = (_mm(xp, xi[lo:hi].T) - yd[lo:hi][None, :]
                           for xi, yd in zip(xis, ydots))
        beta = -2.0 * coef * d1
        gamma = -coef * (normxiz2[lo:hi][None, :] + 2.0 * d2_)
        delta = 2.0 * coef * (xdx2[lo:hi][None, :] - d3)
        epsil = -coef * (epsc[lo:hi][None, :] + 2.0 * d4)
        b2 = beta * beta
        B = B + torch.sum(a * beta)
        C = C + torch.sum(a * (gamma + 0.5 * b2))
        D = D + torch.sum(a * (delta + beta * gamma + b2 * beta / 6.0))
        E = E + torch.sum(a * (epsil + beta * delta + 0.5 * b2 * gamma
                               + 0.5 * gamma * gamma + b2 * b2 / 24.0))
    return B, C, D, E


def kernel_block_dense(params, kernel_inv, x: PointCloud, yb: PointCloud) -> torch.Tensor:
    """Non-isotropic (Mahalanobis) kernel tile
    (fill_in_A_mat_gpu_dense_mat_kernel, CvoGPU.cu:217-327):
    k = sigma^2 exp(-(x-y)^T K^-1 (x-y) / 2) with no geometric distance
    gate; the colour, semantic and geometric-type channels as in
    kernel_block."""
    xp, yp = x.xyz, yb.xyz
    a = torch.ones((xp.shape[0], yp.shape[0]), dtype=torch.float32, device=xp.device)
    ok = (x.mask[:, None] > 0) & (yb.mask[None, :] > 0)
    sigma2, sp, _ = geometric_constants(params)

    if params.is_using_geometric_type:
        xg, yg = x.geometric_types, yb.geometric_types
        dot = _mm(xg, yg.T)
        n2 = torch.sum(xg * xg, -1)[:, None] * torch.sum(yg * yg, -1)[None, :]
        geo = dot * dot / torch.clamp(n2, min=1e-12)
        ok = ok & (geo >= 0.01)
        a = a * geo

    if params.is_using_geometry:
        K = torch.as_tensor(kernel_inv, dtype=torch.float32).to(xp.device)
        # d2 = sum_pq K[p, q] (x_p - y_p)(x_q - y_q), in JAX's term order
        d2 = torch.zeros_like(a)
        for p in range(3):
            for q in range(3):
                d2 = d2 + K[p, q] * ((xp[:, p:p + 1] - yp[None, :, p])
                                     * (xp[:, q:q + 1] - yp[None, :, q]))
        a = a * sigma2 * torch.exp(-d2 / 2.0)

    for on, f_x, f_y, ell_c, sigma_c in (
            (params.is_using_intensity, x.features, yb.features, params.c_ell, params.c_sigma),
            (params.is_using_semantics, x.labels, yb.labels, params.s_ell, params.s_sigma)):
        if not on:
            continue
        sig2, thres, two_ell2 = channel_constants(ell_c, sigma_c, params.sp_thres)
        d2c = torch.clamp(torch.sum(f_x * f_x, -1)[:, None] + torch.sum(f_y * f_y, -1)[None, :]
                          - 2.0 * _mm(f_x, f_y.T), min=0.0)
        ok = ok & (d2c < thres)
        a = a * sig2 * torch.exp(-d2c / two_ell2)

    return torch.where(ok & (a > sp), a, torch.zeros_like(a))


def _topk_rows(block_fn, x: PointCloud, y_t: PointCloud, k: int, chunk: int):
    """Per-source-row top-k of a kernel streamed over target chunks: each
    chunk's tile is merged with the running top-k, as JAX merges
    [vals | tile] with lax.top_k. Returns (values [N, k], target index
    [N, k]), index -1 where the value is 0."""
    chunk = min(chunk, y_t.capacity)
    y_t = pad_cloud_to_multiple(y_t, chunk)
    N, dev = x.capacity, x.xyz.device
    vals = torch.zeros((N, k), dtype=torch.float32, device=dev)
    idx = torch.full((N, k), -1, dtype=torch.int32, device=dev)
    for lo in range(0, y_t.capacity, chunk):
        a = block_fn(x, _slice_cloud(y_t, lo, chunk))
        cols = torch.arange(lo, lo + chunk, dtype=torch.int32, device=dev).expand(N, chunk)
        vals, sel = torch.topk(torch.cat([vals, a], dim=1), k, dim=1, sorted=True)
        idx = torch.gather(torch.cat([idx, cols], dim=1), 1, sel)
    return vals, torch.where(vals > 0, idx, -1)


def association_topk(params, ell, x: PointCloud, y_t: PointCloud, k: int,
                     chunk: int = DEFAULT_CHUNK):
    """Per-source-row top-k kernel entries: (values [N, k], target index
    [N, k]), 0 / -1 padded: the fixed-width form of the reference's sparse
    association export (compute_association_gpu, CvoGPU.cu:1876-1995)."""
    return _topk_rows(lambda xb, yb: kernel_block(params, ell, xb, yb), x, y_t, k, chunk)


def association_topk_dense(params, kernel_inv, x: PointCloud, y_t: PointCloud, k: int,
                           chunk: int = DEFAULT_CHUNK):
    """Top-k association under the non-isotropic kernel
    (compute_association_gpu's 3x3-kernel overload, CvoGPU.cu:1908-1995)."""
    return _topk_rows(lambda xb, yb: kernel_block_dense(params, kernel_inv, xb, yb),
                      x, y_t, k, chunk)


def _d2_block(x: PointCloud, yb: PointCloud) -> torch.Tensor:
    d2 = torch.zeros((x.capacity, yb.capacity), dtype=torch.float32, device=x.xyz.device)
    for c in range(3):
        diff = x.xyz[:, c:c + 1] - yb.xyz[None, :, c]
        d2 = d2 + diff * diff
    return d2


def least_square_flow(params, ell, x: PointCloud, y_t: PointCloud,
                      chunk: int = DEFAULT_CHUNK, dist_gate: float = 0.2):
    """Gauss-Newton 6x6 flow (the is_using_least_square path,
    fill_in_residual_and_jacobian + compute_flow_least_square,
    CvoGPU.cu:851-951): residuals r = (x - y) / ell with J = [-y^x I] / ell,
    pairs gated at |x - y| < dist_gate, reduced through kernel-weighted
    moments. Returns (omega, v) = -H^-1 b. Pairs are gated one by one, as
    in JAX (the reference aborts a whole row at its first far pair)."""
    chunk = min(chunk, y_t.capacity)
    y_t = pad_cloud_to_multiple(y_t, chunk)
    dev = x.xyz.device
    f32 = torch.float32
    S = torch.zeros((), dtype=f32, device=dev)
    m_y = torch.zeros((3,), dtype=f32, device=dev)
    M_yy = torch.zeros((3, 3), dtype=f32, device=dev)
    M_xy = torch.zeros((3, 3), dtype=f32, device=dev)
    m_x = torch.zeros((3,), dtype=f32, device=dev)
    for lo in range(0, y_t.capacity, chunk):
        yb = _slice_cloud(y_t, lo, chunk)
        a = kernel_block(params, ell, x, yb)
        a = torch.where(_d2_block(x, yb) < dist_gate * dist_gate, a, torch.zeros_like(a))
        S = S + torch.sum(a)
        col_w = torch.sum(a, dim=0)
        row_w = torch.sum(a, dim=1)
        m_y = m_y + _mm(col_w[None, :], yb.xyz)[0]
        M_yy = M_yy + _mm((yb.xyz * col_w[:, None]).T, yb.xyz)
        M_xy = M_xy + _mm(x.xyz.T, _mm(a, yb.xyz))           # sum a x y^T
        m_x = m_x + torch.stack([torch.sum(row_w * x.xyz[:, c]) for c in range(3)])
    ell = torch.as_tensor(ell, dtype=f32).to(dev)
    inv_l2 = 1.0 / (ell * ell)
    I3 = torch.eye(3, dtype=f32, device=dev)
    # H = 1/l^2 [[sum a (|y|^2 I - y y^T), sum a y^x], [-sum a y^x, S I]]
    H_tl = (torch.trace(M_yy) * I3 - M_yy) * inv_l2
    my_hat = lie.skew(m_y) * inv_l2
    H = torch.cat([torch.cat([H_tl, my_hat], dim=1),
                   torch.cat([-my_hat, S * I3 * inv_l2], dim=1)], dim=0)
    # b = 1/l^2 [sum a (y cross x); sum a (x - y)]
    cross = torch.stack([M_xy[2, 1] - M_xy[1, 2], M_xy[0, 2] - M_xy[2, 0],
                         M_xy[1, 0] - M_xy[0, 1]])
    b = torch.cat([cross, m_x - m_y]) * inv_l2
    eps = torch.linalg.solve(H + 1e-8 * torch.eye(6, dtype=f32, device=dev), -b)
    return eps[:3], eps[3:]


def weighted_d2_sum(params, ell, x: PointCloud, y: PointCloud, chunk: int = DEFAULT_CHUNK):
    """(sum_ij A_ij d2_ij, nonzeros) over the kernel support: the
    ingredients of the adaptive-ell gradient (reference AdaptiveCvoGPU.cu,
    the dl accumulation of compute_flow_gpu_no_eigen, :548-720); d2 is the
    geometric squared distance."""
    chunk = min(chunk, y.capacity)
    y = pad_cloud_to_multiple(y, chunk)
    dev = x.xyz.device
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    cnt = torch.zeros((), dtype=torch.int64, device=dev)
    for lo in range(0, y.capacity, chunk):
        yb = _slice_cloud(y, lo, chunk)
        a = kernel_block(params, ell, x, yb)
        acc = acc + torch.sum(a * _d2_block(x, yb))
        cnt = cnt + torch.sum(a > 0)
    return acc, cnt.to(torch.int32)
