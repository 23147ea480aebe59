"""Verlet-style ELL neighbor lists (port of unified_cvo_tpu/ops/neighbors.py:
the grid and scan builders, the channel factor and the plain consume
passes).

build (rare):  grid builder: bucket the pose-moved targets into a dense
               voxel table (cell >= support + skin per axis), and for each
               source point keep the K nearest targets of its 27-cell pool
               within r_i + skin (ops/select.py: a CUDA kernel on the card);
               scan builder: a chunked N x M scan with a running top-K
               merge, for any support radius and cloud size, ranked by the
               channel kernel value when geometry is off. Both then gather
               the pose-independent channel factor `chan` once per build;
consume (hot): per-slot kernel, flow and step math over the K-major
               [K, N] slots (ops/ell.py: CUDA kernels on the card; the
               plain passes below are the JAX package's jnp twins);
validity:      the list stays a superset of the kernel support while every
               target has drifted less than `skin` since the build and ell
               has only decayed; align checks an O(1) drift bound each
               iteration and rebuilds when it fires. Without geometry the
               kernel is pose-independent and the list is never rebuilt.

Per-candidate fields are K-major ([K, N], components leading: [3, K, N]):
with N contiguous, a thread per source point reads coalesced.

The JAX builder pulls the pool through a z-dilated table to save TPU
gathers (neighbors.py:271-291). This port gathers the 27 cells directly;
after the exact filter the candidate set is the same.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from unified_cvo_tpu_torch.ops import select as select_ops
from unified_cvo_tpu_torch.ops.kernels import (
    DEFAULT_CHUNK, FlowStats, channel_constants, geometric_constants, kernel_block,
    pad_cloud_to_multiple, range_ell, _slice_cloud)
from unified_cvo_tpu_torch.ops import lie
from unified_cvo_tpu_torch.utils.pointcloud import PointCloud

DEFAULT_K = 32            # the reference kd-tree mode's K (cukdtree.h:12)
DEFAULT_SKIN = 0.5
DEAD_COORD = select_ops.DEAD_COORD   # dead-slot coordinate sentinel
GRID_DIMS = (64, 32, 64)  # static voxel grid (131072 cells)
PER_CELL_CAP = 8          # targets stored per cell before the exact filter


class NeighborList(NamedTuple):
    """Static-shape candidate list with the raw target coordinates."""

    idx: torch.Tensor                 # [K, N] int32 target index, -1 pad
    valid: torch.Tensor               # [K, N] bool
    y_xyz: torch.Tensor               # [3, K, N] RAW target xyz, DEAD_COORD pad
    chan: Optional[torch.Tensor]      # [K, N] pose-independent factor of the
    #   colour, semantic and geometric-type kernels with their gates folded
    #   in as exact zeros; None when only the geometric channel is on
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


def static_support_radius(params) -> float:
    """Upper estimate of the support radius at ell_init for a ~55 m range
    envelope: the input of align's builder choice (neighbors.py:117-125)."""
    sigma2 = float(params.sigma) ** 2
    arg = max(sigma2 / float(params.sp_thres), 1.0 + 1e-6)
    return (55.0 / 500.0 + 1.0) * float(params.ell_init) * math.sqrt(2.0 * math.log(arg))


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
    within r_i + skin of each source point (`select_ops.select`), then the
    channel factor of the kept slots."""
    g = grid_inputs(params, ell, x, target, R_inv, T_inv, skin, per_cell_cap,
                    grid_dims)
    idx, y_xyz, kept = select_ops.select(g.tab, g.cbase, g.xr2, g.pose, k,
                                         per_cell_cap, grid_dims)
    return _grid_list(params, ell, x, target, g, idx, y_xyz, kept)


def build_neighbor_list_lanes(
    params,
    ells: Sequence,
    xs: Sequence[PointCloud],
    targets: Sequence[PointCloud],
    R_invs: Sequence,
    T_invs: Sequence,
    k: int = DEFAULT_K,
    skin: float = DEFAULT_SKIN,
    per_cell_cap: int = PER_CELL_CAP,
    grid_dims: Tuple[int, int, int] = GRID_DIMS,
) -> List[NeighborList]:
    """`build_neighbor_list` for L lanes (equal capacities): `grid_inputs`
    lane by lane (torch), then one `select_ops.select_lanes` launch for all
    of them, then each lane's channel factor. Lane l's list is
    build_neighbor_list's on lane l's inputs, bit for bit."""
    gs = [grid_inputs(params, ell, x, y, Ri, Ti, skin, per_cell_cap, grid_dims)
          for ell, x, y, Ri, Ti in zip(ells, xs, targets, R_invs, T_invs)]
    idx, y_xyz, kept = select_ops.select_lanes(
        *(torch.stack([getattr(g, f) for g in gs]) for f in ("tab", "cbase", "xr2", "pose")),
        k, per_cell_cap, grid_dims)
    return [_grid_list(params, ells[l], xs[l], targets[l], g, idx[l], y_xyz[l], kept[l])
            for l, g in enumerate(gs)]


def _grid_list(params, ell, x: PointCloud, target: PointCloud, g: GridInputs, idx, y_xyz,
               kept) -> NeighborList:
    """The grid builder's list from select's outputs on `g`."""
    valid = idx >= 0
    overflow = (torch.sum(kept) - torch.sum(valid) + g.per_cell_dropped).to(torch.int32)
    return NeighborList(
        idx=idx,
        valid=valid,
        y_xyz=y_xyz,
        chan=_build_chan(params, x, target, idx, valid),
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


def _gather_slots(a, idx):
    """Per-slot rows of a target field: [F, K, N] from a [M, F] array and
    K-major idx (dead slots read row 0; the caller masks them)."""
    if a is None:
        return None
    g = a[torch.clamp(idx, min=0).reshape(-1).long()]       # [K*N, F]
    return g.T.reshape(a.shape[1], idx.shape[0], idx.shape[1])


def _build_chan(params, x: PointCloud, target: PointCloud, idx, valid):
    return _channel_kernel(
        params, x, valid,
        _gather_slots(target.features if params.is_using_intensity else None, idx),
        _gather_slots(target.labels if params.is_using_semantics else None, idx),
        _gather_slots(target.geometric_types if params.is_using_geometric_type
                      else None, idx))


def _channel_kernel(params, x: PointCloud, valid, y_feat, y_label, y_geo):
    """Pose-independent kernel factor per slot (neighbors.py:530-574): the
    colour and semantic kernels and the geometric-type cosine^2 gate of
    fill_in_A_mat_gpu (CvoGPU.cu:477-593) with their distance gates folded
    in as exact zeros. K-major [K, N], or None when no such channel is on.
    Every sum runs in the JAX package's order, so the values agree to f32
    rounding and the gates decide alike."""
    a = None
    ok = valid

    def col(arr, c):
        return arr[:, c][None, :]

    if params.is_using_geometric_type:
        xg = x.geometric_types
        dot = col(xg, 0) * y_geo[0] + col(xg, 1) * y_geo[1]
        n2 = torch.sum(xg * xg, -1)[None, :] * (y_geo[0] * y_geo[0] + y_geo[1] * y_geo[1])
        geo = dot * dot / torch.clamp(n2, min=1e-12)
        ok = ok & (geo >= 0.01)
        a = geo

    for on, xf, yf, ell_c, sigma_c in (
            (params.is_using_intensity, x.features, y_feat, params.c_ell, params.c_sigma),
            (params.is_using_semantics, x.labels, y_label, params.s_ell, params.s_sigma)):
        if not on:
            continue
        sig2, thres, two_ell2 = channel_constants(ell_c, sigma_c, params.sp_thres)
        d2 = (col(xf, 0) - yf[0]) ** 2
        for f in range(1, xf.shape[1]):
            d2 = d2 + (col(xf, f) - yf[f]) ** 2
        ok = ok & (d2 < thres)
        k = sig2 * torch.exp(-d2 / two_ell2)
        a = k if a is None else a * k

    if a is None:
        return None
    return torch.where(ok, a, torch.zeros_like(a))


def build_neighbor_list_scan(
    params,
    ell,
    x: PointCloud,
    target: PointCloud,
    R_inv,
    T_inv,
    k: int = DEFAULT_K,
    skin: float = DEFAULT_SKIN,
    chunk: int = DEFAULT_CHUNK,
) -> NeighborList:
    """Brute-force chunked top-K candidate list (neighbors.py:442-527): one
    dense N x M scan per build, streamed over target chunks with a running
    top-K merge. Sound for any support radius and cloud size.

    Geometry on: candidates within r_i + skin, nearest first. Geometry off:
    the kernel is pose-independent, candidates are ranked by the channel
    kernel value (strongest first) and the list is exact for the whole
    solve. Each merge sorts [kept | chunk] stably, as JAX's sort keeps the
    earlier entries first on ties."""
    f32 = torch.float32
    dev = x.xyz.device
    N, M = x.capacity, target.capacity
    chunk = min(chunk, M)
    tgt = pad_cloud_to_multiple(target, chunk)
    y_t_full = transform_cols(tgt.xyz, R_inv, T_inv)         # [Mp, 3]
    use_geom = bool(params.is_using_geometry)
    if use_geom:
        r2 = ((support_radius(params, ell, x) + skin) ** 2)[:, None]
    key = torch.full((N, k), math.inf, dtype=f32, device=dev)
    idx = torch.full((N, k), -1, dtype=torch.int32, device=dev)
    nkeep = torch.zeros((), dtype=torch.int64, device=dev)
    for lo in range(0, tgt.capacity, chunk):
        if use_geom:
            d2 = torch.zeros((N, chunk), dtype=f32, device=dev)
            for c in range(3):
                diff = x.xyz[:, c, None] - y_t_full[lo:lo + chunk, c][None, :]
                d2 = d2 + diff * diff
            keep = ((d2 <= r2) & (tgt.mask[lo:lo + chunk][None, :] > 0)
                    & (x.mask[:, None] > 0))
            kb = torch.where(keep, d2, torch.full_like(d2, math.inf))
        else:
            a = kernel_block(params, ell, x, _slice_cloud(tgt, lo, chunk))
            kb = torch.where(a > 0, -a, torch.full_like(a, math.inf))
        cols = torch.arange(lo, lo + chunk, dtype=torch.int32, device=dev).expand(N, chunk)
        ck, order = torch.sort(torch.cat([key, kb], dim=1), dim=1, stable=True)
        ci = torch.gather(torch.cat([idx, cols], dim=1), 1, order)
        key, idx = ck[:, :k], ci[:, :k]
        nkeep = nkeep + torch.sum(torch.isfinite(kb))
    valid = torch.isfinite(key).T.contiguous()               # [K, N]
    idx = torch.where(valid, idx.T, -1).to(torch.int32).contiguous()
    overflow = (nkeep - torch.sum(valid)).to(torch.int32)
    y_xyz = torch.where(valid[None], _gather_slots(tgt.xyz, idx),
                        torch.full((), DEAD_COORD, dtype=f32, device=dev)).contiguous()
    return NeighborList(
        idx=idx,
        valid=valid,
        y_xyz=y_xyz,
        chan=_build_chan(params, x, tgt, idx, valid),
        y_t_build=y_t_full[:M],
        overflow=overflow,
        pose_build=torch.cat([R_inv.reshape(9), T_inv]).to(f32),
        r_max_t=_r_max(tgt),
        ell_build=torch.as_tensor(ell, dtype=f32).to(dev),
        k_lin=_k_lin(params, x),
    )


def _drift_bound(nl: NeighborList, R_inv, T_inv):
    dR = R_inv.reshape(9).to(torch.float32) - nl.pose_build[:9]
    dT = T_inv.to(torch.float32) - nl.pose_build[9:]
    return (torch.sqrt(torch.sum(dR * dR)) * nl.r_max_t
            + torch.sqrt(torch.sum(dT * dT)))


def drift_bound_exceeded(nl: NeighborList, R_inv, T_inv, skin: float):
    """O(1) Verlet rebuild trigger: a sound upper bound on the largest
    target displacement since the build, from the pose delta alone:
      |dR y + dT| <= ||dR||_F r_max + |dT|."""
    return _drift_bound(nl, R_inv, T_inv) > skin


def drift_exceeded(nl: NeighborList, target: PointCloud, R_inv, T_inv, skin: float):
    """Exact Verlet rebuild trigger (neighbors.py:626-638): true when some
    valid target moved more than `skin` since the build, from each target's
    own displacement against y_t_build (not a bound)."""
    d2 = torch.zeros((), dtype=torch.float32, device=target.xyz.device)
    for c in range(3):
        y_c = (target.xyz[:, 0] * R_inv[c, 0] + target.xyz[:, 1] * R_inv[c, 1]
               + target.xyz[:, 2] * R_inv[c, 2] + T_inv[c])
        d2 = d2 + (y_c - nl.y_t_build[:, c]) ** 2
    d2 = torch.where(target.mask > 0, d2, torch.zeros_like(d2))
    return torch.amax(d2) > torch.tensor(skin, dtype=torch.float32) ** 2


def stale_bound_exceeded(nl: NeighborList, R_inv, T_inv, ell_now, skin: float):
    """O(1) staleness trigger of the adaptive-ell (ACVO) loop
    (neighbors.py:593-608): a list built with radius r_i(ell_build) + skin
    stays a superset of the support while
      drift_bound + k_lin * max(ell_now - ell_build, 0) <= skin
    (the support radius is linear in ell, so a shrinking ell only adds
    margin). Without growth it is drift_bound_exceeded."""
    growth = nl.k_lin * torch.clamp(
        torch.as_tensor(ell_now, dtype=torch.float32) - nl.ell_build, min=0.0)
    return _drift_bound(nl, R_inv, T_inv) + growth > skin


def weighted_d2_sum_ell(params, ell, x: PointCloud, nl: NeighborList, R_inv, T_inv):
    """(sum A d2, nonzeros) over the candidate list: the adaptive-ell
    gradient's ingredients (AdaptiveCvoGPU.cu, the dl accumulation,
    :548-720) without a dense N x M scan (neighbors.py:611-623). Dead slots
    have A == 0 exactly, so their sentinel d2 adds nothing."""
    y_t = _slots_t(nl, R_inv, T_inv)
    a = kernel_slots(params, ell, x, y_t, nl)
    d2 = sum((x.xyz[:, c][None, :] - y_t[c]) ** 2 for c in range(3))
    return torch.sum(a * d2), torch.sum(a > 0).to(torch.int32)


def _slots_t(nl: NeighborList, R_inv, T_inv):
    yr = nl.y_xyz
    return torch.stack([yr[0] * R_inv[c, 0] + yr[1] * R_inv[c, 1]
                        + yr[2] * R_inv[c, 2] + T_inv[c] for c in range(3)], dim=0)


def kernel_slots(params, ell, x: PointCloud, y_t_slots, nl: NeighborList):
    """[K, N] kernel values: slot-wise transcription of kernel_block
    (fill_in_A_mat_gpu, CvoGPU.cu:477-593) with identical gates; dead and
    masked slots are exactly 0. Only the geometric factor is evaluated
    here; the other channels arrive precomputed in nl.chan
    (neighbors.py:640-668)."""
    sigma2, sp, log_term = geometric_constants(params)
    a = None
    ok = nl.valid & (x.mask[None, :] > 0)
    if nl.chan is not None:
        ok = ok & (nl.chan > 0)
        a = nl.chan
    if params.is_using_geometry:
        d2 = sum((x.xyz[:, c][None, :] - y_t_slots[c]) ** 2 for c in range(3))
        l_i = range_ell(ell, _norm(x.xyz))[None, :]
        two_l2 = 2.0 * l_i * l_i
        ok = ok & (d2 < -two_l2 * log_term)
        kgeo = sigma2 * torch.exp(-d2 / two_l2)
        a = kgeo if a is None else a * kgeo
    if a is None:
        return torch.where(ok, torch.ones_like(y_t_slots[0]), torch.zeros_like(y_t_slots[0]))
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
