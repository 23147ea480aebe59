"""Verlet-style ELL neighbor lists (port of unified_cvo_tpu/ops/neighbors.py,
grid builder and plain consume passes).

build (rare):  bucket the pose-moved targets into a dense voxel table
               (cell >= support + skin per axis), and for each source point
               keep the K nearest targets of its 27-cell pool within
               r_i + skin (ops/select.py: a CUDA kernel on the card);
consume (hot): per-slot kernel, flow and step math over the K-major
               [K, N] slots (ops/ell.py: CUDA kernels on the card; the
               plain passes below are the JAX package's jnp twins);
validity:      the list stays a superset of the kernel support while every
               target has drifted less than `skin` since the build and ell
               has only decayed; align checks an O(1) drift bound each
               iteration and rebuilds when it fires.

Per-candidate fields are K-major ([K, N], components leading: [3, K, N]):
with N contiguous, a thread per source point reads coalesced.

The JAX builder pulls the pool through a z-dilated table to save TPU
gathers (neighbors.py:271-291). This port gathers the 27 cells directly;
after the exact filter the candidate set is the same.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from unified_cvo_tpu_torch.ops import select as select_ops
from unified_cvo_tpu_torch.ops.kernels import FlowStats, geometric_constants, range_ell
from unified_cvo_tpu_torch.ops import lie
from unified_cvo_tpu_torch.utils.pointcloud import PointCloud

DEFAULT_K = 32            # the reference kd-tree mode's K (cukdtree.h:12)
DEFAULT_SKIN = 0.5
DEAD_COORD = select_ops.DEAD_COORD   # dead-slot coordinate sentinel
GRID_DIMS = (64, 32, 64)  # static voxel grid (131072 cells)
PER_CELL_CAP = 8          # targets stored per cell before the exact filter

CHANNELS_TODO = ("intensity, semantic and geometric-type channels are not "
                 "ported yet (ROADMAP queue 1, item 4: the channel kernel)")


class NeighborList(NamedTuple):
    """Static-shape candidate list with the raw target coordinates."""

    idx: torch.Tensor                 # [K, N] int32 target index, -1 pad
    valid: torch.Tensor               # [K, N] bool
    y_xyz: torch.Tensor               # [3, K, N] RAW target xyz, DEAD_COORD pad
    chan: Optional[torch.Tensor]      # pose-independent channel factor; None
    #   while only the geometric channel is ported
    y_t_build: torch.Tensor           # [M, 3] transformed target at build
    overflow: torch.Tensor            # [] int32: candidates dropped by the caps
    pose_build: Optional[torch.Tensor] = None  # [12] (R_inv | T_inv) at build
    r_max_t: Optional[torch.Tensor] = None     # [] max |y| over valid targets
    ell_build: Optional[torch.Tensor] = None   # [] ell the list was built at
    k_lin: Optional[torch.Tensor] = None       # [] max_i support_radius(ell=1)


def has_channels(params) -> bool:
    return bool(params.is_using_intensity or params.is_using_semantics
                or params.is_using_geometric_type)


def _norm(xyz: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(xyz * xyz, dim=-1))


def support_radius(params, ell, x: PointCloud) -> torch.Tensor:
    """Per-source kernel support radius sqrt(d2_thres) (the geometric gate
    of fill_in_A_mat_gpu: d2 < -2 l_i^2 log(sp_thres / sigma^2),
    CvoGPU.cu:507-520)."""
    log_term = geometric_constants(params)[2]
    l_i = range_ell(ell, _norm(x.xyz))
    d2_thres = -2.0 * l_i * l_i * log_term
    return torch.sqrt(torch.clamp(d2_thres, min=0.0))


def transform_cols(xyz, R_inv, T_inv) -> torch.Tensor:
    """Rigid transform as per-component broadcasts: the one formulation the
    build, the drift bound and the consume passes share."""
    return torch.stack(
        [xyz[:, 0] * R_inv[c, 0] + xyz[:, 1] * R_inv[c, 1]
         + xyz[:, 2] * R_inv[c, 2] + T_inv[c] for c in range(3)], dim=-1)


def _masked_extent(xyz, mask):
    m = (mask > 0)[:, None]
    lo = torch.amin(torch.where(m, xyz, torch.full_like(xyz, math.inf)), dim=0)
    hi = torch.amax(torch.where(m, xyz, torch.full_like(xyz, -math.inf)), dim=0)
    return lo, hi


class GridInputs(NamedTuple):
    """Everything the select kernel reads, for one build."""

    tab: torch.Tensor               # [n_cells + 1, 4P] x | y | z | index slots
    cbase: torch.Tensor             # [N, 3] int32 base cell of each source point
    xr2: torch.Tensor               # [N, 4] source xyz | (r_i + skin)^2, -1 masked
    pose: torch.Tensor              # [12] R_inv row-major | T_inv
    per_cell_dropped: torch.Tensor  # [] targets beyond a cell's P slots
    y_t: torch.Tensor               # [M, 3] targets moved by the pose


def grid_inputs(
    params,
    ell,
    x: PointCloud,
    target: PointCloud,
    R_inv,
    T_inv,
    skin: float = DEFAULT_SKIN,
    per_cell_cap: int = PER_CELL_CAP,
    grid_dims: Tuple[int, int, int] = GRID_DIMS,
) -> GridInputs:
    """Voxel table and per-point inputs of the K-nearest selection.

    Targets are moved by the current pose (y_t = R_inv y + T_inv, the map
    the align loop applies) and bucketed into a dense voxel table whose
    per-axis cell size is >= max_i(r_i) + skin, so a source point's 27-cell
    neighbourhood covers its whole candidate ball."""
    if has_channels(params):
        raise NotImplementedError(CHANNELS_TODO)
    f32 = torch.float32
    dev = x.xyz.device
    M = target.capacity
    P = per_cell_cap
    gx, gy, gz = grid_dims
    n_cells = gx * gy * gz

    y_t = transform_cols(target.xyz, R_inv, T_inv)           # [M, 3]
    r_i = support_radius(params, ell, x) + skin              # [N]
    r_max = torch.amax(torch.where(x.mask > 0, r_i, torch.zeros_like(r_i)))

    # grid geometry over the union bbox (targets clip into boundary cells;
    # the exact filter removes false candidates)
    w = target.mask > 0
    lo_t, hi_t = _masked_extent(y_t, target.mask)
    lo_x, hi_x = _masked_extent(x.xyz, x.mask)
    lo = torch.minimum(lo_t, lo_x)
    hi = torch.maximum(hi_t, hi_x)
    dims = torch.stack([torch.full((), float(g), dtype=f32, device=dev)
                        for g in grid_dims])
    cell = torch.maximum((hi - lo) / dims, r_max)            # [3]

    def cell_coords(p):
        c = torch.floor((p - lo) / cell).to(torch.int32)
        return torch.stack([torch.clamp(c[:, a], 0, g - 1)
                            for a, g in enumerate(grid_dims)], dim=1)

    ct = cell_coords(y_t)
    key = torch.where(w, (ct[:, 0] * gy + ct[:, 1]) * gz + ct[:, 2], n_cells)

    # dense per-cell table [n_cells + 1, 4P], component-blocked columns
    # (x slots | y slots | z slots | index slots, index as f32: exact for
    # M < 2^24). Which P targets a full cell keeps follows the STABLE sort
    # order, as in the JAX builder.
    order = torch.argsort(key, stable=True)
    key_sorted = key[order]
    ar = torch.arange(M, dtype=torch.int64, device=dev)
    first = torch.ones_like(key_sorted, dtype=torch.bool)
    first[1:] = key_sorted[1:] != key_sorted[:-1]
    segment_start, _ = torch.cummax(torch.where(first, ar, torch.zeros_like(ar)), dim=0)
    rank = ar - segment_start                                # rank within cell
    slot_ok = rank < P
    scat_cell = torch.where(slot_ok, key_sorted.long(), n_cells)
    scat_rank = torch.where(slot_ok, rank, P - 1)
    xyz_sorted = target.xyz[order]
    tab = torch.full((n_cells + 1, 4 * P), -1.0, dtype=f32, device=dev)
    for c, v in enumerate((xyz_sorted[:, 0], xyz_sorted[:, 1], xyz_sorted[:, 2],
                           order.to(f32))):
        tab[scat_cell, c * P + scat_rank] = torch.where(
            slot_ok, v, torch.full_like(v, -1.0))
    tab[n_cells] = -1.0                                      # sentinel stays empty
    per_cell_dropped = torch.sum((~slot_ok) & (key_sorted < n_cells))

    xr2 = torch.stack([x.xyz[:, 0], x.xyz[:, 1], x.xyz[:, 2],
                       torch.where(x.mask > 0, r_i * r_i, torch.full_like(r_i, -1.0))],
                      dim=1)
    return GridInputs(
        tab=tab, cbase=cell_coords(x.xyz).contiguous(), xr2=xr2.contiguous(),
        pose=torch.cat([R_inv.reshape(9), T_inv]).to(f32).contiguous(),
        per_cell_dropped=per_cell_dropped, y_t=y_t)


def build_neighbor_list(
    params,
    ell,
    x: PointCloud,
    target: PointCloud,
    R_inv,
    T_inv,
    k: int = DEFAULT_K,
    skin: float = DEFAULT_SKIN,
    per_cell_cap: int = PER_CELL_CAP,
    grid_dims: Tuple[int, int, int] = GRID_DIMS,
) -> NeighborList:
    """Grid-bucketed candidate list: `grid_inputs`, then the K nearest
    within r_i + skin of each source point (`select_ops.select`)."""
    g = grid_inputs(params, ell, x, target, R_inv, T_inv, skin, per_cell_cap,
                    grid_dims)
    idx, y_xyz, kept = select_ops.select(g.tab, g.cbase, g.xr2, g.pose, k,
                                         per_cell_cap, grid_dims)
    valid = idx >= 0
    overflow = (torch.sum(kept) - torch.sum(valid) + g.per_cell_dropped).to(torch.int32)
    return NeighborList(
        idx=idx,
        valid=valid,
        y_xyz=y_xyz,
        chan=None,
        y_t_build=g.y_t,
        overflow=overflow,
        pose_build=g.pose,
        r_max_t=_r_max(target),
        ell_build=torch.as_tensor(ell, dtype=torch.float32).to(x.xyz.device),
        k_lin=_k_lin(params, x),
    )


def _k_lin(params, x: PointCloud):
    one = torch.ones((), dtype=torch.float32, device=x.xyz.device)
    r = support_radius(params, one, x)
    return torch.amax(torch.where(x.mask > 0, r, torch.zeros_like(r)))


def _r_max(target: PointCloud):
    n2 = torch.sum(target.xyz * target.xyz, dim=-1)
    return torch.sqrt(torch.amax(torch.where(target.mask > 0, n2, torch.zeros_like(n2))))


def drift_bound_exceeded(nl: NeighborList, R_inv, T_inv, skin: float):
    """O(1) Verlet rebuild trigger: a sound upper bound on the largest
    target displacement since the build, from the pose delta alone:
      |dR y + dT| <= ||dR||_F r_max + |dT|."""
    dR = R_inv.reshape(9).to(torch.float32) - nl.pose_build[:9]
    dT = T_inv.to(torch.float32) - nl.pose_build[9:]
    bound = (torch.sqrt(torch.sum(dR * dR)) * nl.r_max_t
             + torch.sqrt(torch.sum(dT * dT)))
    return bound > skin


def _slots_t(nl: NeighborList, R_inv, T_inv):
    yr = nl.y_xyz
    return torch.stack([yr[0] * R_inv[c, 0] + yr[1] * R_inv[c, 1]
                        + yr[2] * R_inv[c, 2] + T_inv[c] for c in range(3)], dim=0)


def kernel_slots(params, ell, x: PointCloud, y_t_slots, nl: NeighborList):
    """[K, N] kernel values: slot-wise transcription of kernel_block
    (fill_in_A_mat_gpu, CvoGPU.cu:477-593) with identical gates; dead and
    masked slots are exactly 0. Geometric channel only."""
    if nl.chan is not None or has_channels(params):
        raise NotImplementedError(CHANNELS_TODO)
    sigma2, sp, log_term = geometric_constants(params)
    ok = nl.valid & (x.mask[None, :] > 0)
    if not params.is_using_geometry:
        return torch.where(ok, torch.ones_like(y_t_slots[0]), torch.zeros_like(y_t_slots[0]))
    d2 = sum((x.xyz[:, c][None, :] - y_t_slots[c]) ** 2 for c in range(3))
    l_i = range_ell(ell, _norm(x.xyz))[None, :]
    two_l2 = 2.0 * l_i * l_i
    ok = ok & (d2 < -two_l2 * log_term)
    a = sigma2 * torch.exp(-d2 / two_l2)
    return torch.where(ok & (a > sp), a, torch.zeros_like(a))


def flow_stats_ell(params, ell, x: PointCloud, nl: NeighborList, R_inv, T_inv):
    """Plain ELL flow pass: (FlowStats, A [K, N], y_t_slots [3, K, N])."""
    y_t_slots = _slots_t(nl, R_inv, T_inv)
    a = kernel_slots(params, ell, x, y_t_slots, nl)
    s = torch.sum(a, dim=0)
    wy = torch.stack([torch.sum(a * y_t_slots[c], dim=0) for c in range(3)], dim=-1)
    stats = FlowStats(row_sum=s, row_wy=wy,
                      nonzeros=torch.sum(a > 0).to(torch.int32), a_sum=torch.sum(s))
    return stats, a, y_t_slots


def step_coeffs_ell(params, ell, x: PointCloud, a, y_t_slots, twist):
    """Plain ELL step pass (compute_step_size_xi + compute_step_size_poly_coeff,
    CvoGPU.cu:953-1082) from the cached kernel matrix `a`: (B, C, D, E)."""
    omega, v = twist[:3], twist[3:]
    W = lie.skew(omega)
    W2 = W @ W
    W3 = W2 @ W
    W4 = W2 @ W2
    # dead slots carry DEAD_COORD coordinates: zero them so that no power
    # of a 1e9-scale value meets an exact-zero kernel value (0 * inf = NaN)
    y = [torch.where(a > 0, y_t_slots[c], torch.zeros_like(a)) for c in range(3)]

    def lin(Mm, b):
        return [y[0] * Mm[c, 0] + y[1] * Mm[c, 1] + y[2] * Mm[c, 2] + b[c]
                for c in range(3)]

    xiz = lin(W, v)
    xi2z = lin(W2, W @ v)
    xi3z = lin(W3, W2 @ v)
    xi4z = lin(W4, W3 @ v)
    diff = [x.xyz[:, c][None, :] - y[c] for c in range(3)]

    def dot3(p, q):
        return p[0] * q[0] + p[1] * q[1] + p[2] * q[2]

    d1, d2_, d3, d4 = (dot3(diff, z) for z in (xiz, xi2z, xi3z, xi4z))
    normxiz2 = dot3(xiz, xiz)
    xdx2 = -dot3(xiz, xi2z)
    epsc = dot3(xi2z, xi2z) + 2.0 * dot3(xiz, xi3z)
    if params.is_using_range_ell:
        l_i = range_ell(ell, _norm(x.xyz))
    else:
        l_i = ell * torch.ones(x.capacity, dtype=torch.float32, device=a.device)
    coef = (1.0 / (2.0 * l_i * l_i))[None, :]
    beta = -2.0 * coef * d1
    gamma = -coef * (normxiz2 + 2.0 * d2_)
    delta = 2.0 * coef * (xdx2 - d3)
    epsil = -coef * (epsc + 2.0 * d4)
    b2 = beta * beta
    B = torch.sum(a * beta)
    C = torch.sum(a * (gamma + 0.5 * b2))
    D = torch.sum(a * (delta + beta * gamma + b2 * beta / 6.0))
    E = torch.sum(a * (epsil + beta * delta + 0.5 * b2 * gamma
                       + 0.5 * gamma * gamma + b2 * b2 / 24.0))
    return B, C, D, E
