"""Dense tiled passes of the align loop: the flow pass (per-row s, wy, cnt)
and the step pass (B..E) over the active (source tile x target tile) pairs
left by spatial culling (port of unified_cvo_tpu/ops/pallas_kernels.py).

`dense_flow` replaces pallas_kernels.py::_flow_kernel and `dense_step`
replaces _step_kernel / _step_tile, both with _a_block. On a CUDA tensor
each launches its kernels in csrc/dense.cu (a persistent grid over the
active pairs writes per-item partials into scratch allocated here, a second
kernel sums them in list order); on a CPU tensor each runs its plain
PyTorch version below, which is also the oracle the card's kernels are
held against. `flow_stats_tiled` and `step_coeffs_tiled` are the
counterparts of flow_stats_pallas and step_coeffs_pallas: they pad to tile
multiples, centre both clouds on the source centroid, pack, run the pass,
and restore the raw-frame wy.

The packed layout is the JAX package's: source rows x [N, Dx], target rows
transposed yT [Dy, M], with validity folded into the operands (a -1 gate
threshold for masked source rows, a +PAD_BIG row added to d2 and to the
squared channel norms for masked targets), so no pass reads a mask per pair.

`dense_flow_lanes` and `dense_step_lanes` are both passes with a lane axis:
B pairs in one call (xp [B, N, Dx], yp [B, Dy, M], a `TileCompactionLanes`
from `compact_tile_mask_lanes`), the counterparts of the two Pallas kernels
under the JAX package's jax.vmap of align (parallel/batch_align.py:51-55).
A call launches the device kernels one unbatched call does, and each
lane's outputs are the unbatched call's on its inputs, bit for bit; their
plain versions run the unbatched plain versions lane by lane.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional

import torch

from unified_cvo_tpu_torch.ops import cuda_lib
from unified_cvo_tpu_torch.ops import lie
from unified_cvo_tpu_torch.ops.kernels import (FlowStats, channel_constants,
                                               geometric_constants,
                                               pad_cloud_to_multiple, range_ell)
from unified_cvo_tpu_torch.utils.pointcloud import PointCloud

DEFAULT_TILE_I = 128  # narrow source tiles cull tighter (smaller boxes)
DEFAULT_TILE_J = 512  # wide target tiles: fewer pairs to schedule
PAD_BIG = 1e30        # additive invalid-pair sentinel (f32-safe)
KERNEL_ROWS = 32      # tile_i must be a multiple (a warp's rows stay in one tile)
KERNEL_COLS = 4       # tile_j must be a multiple (16-byte copies and loads)
KERNEL_ROW_BLOCK = 128  # source rows of one work item of the CUDA passes
# channel sets csrc/dense.cu instantiates, by index; any other set runs the
# generic instantiation of the same kernels
KERNEL_INSTANCES = ("colour", "all_channels", "geometry", "generic")
# active pairs per vectorised step of the plain versions: on the CPU a few
# pairs keep the [B, TI, TJ] temporaries in cache (2 ran ~1.8x faster than 64
# at 128 x 512 tiles); on the card 64 amortise the launches
PLAIN_BATCH = {"cpu": 2, "cuda": 64}


@dataclasses.dataclass(frozen=True)
class PackLayout:
    """Row and column offsets inside the packed x [N, Dx] and yT [Dy, M]."""

    feature_dim: int
    num_classes: int
    use_geometry: bool
    use_intensity: bool
    use_semantics: bool
    use_geo_type: bool
    use_range_ell_step: bool

    # x columns: xyz 0-2, mask 3, -1/(2 l_i^2) 4, d2 gate 5, step coef 6
    x_xyz, x_mask, x_twol2, x_d2thres, x_coef, x_feat = 0, 3, 4, 5, 6, 7

    @property
    def x_featsq(self):  # |f|^2 (+pad)
        return 7 + self.feature_dim

    @property
    def x_label(self):
        return 8 + self.feature_dim

    @property
    def x_labelsq(self):
        return 8 + self.feature_dim + self.num_classes

    @property
    def x_geo(self):
        return 9 + self.feature_dim + self.num_classes

    @property
    def x_geon2(self):  # |g|^2
        return 11 + self.feature_dim + self.num_classes

    @property
    def x_dim(self):
        return 12 + self.feature_dim + self.num_classes

    # yT rows: xyz 0-2, pad 3 (0 valid / +PAD_BIG invalid, added to d2)
    y_xyz, y_pad, y_feat = 0, 3, 4

    @property
    def y_featsq(self):
        return 4 + self.feature_dim

    @property
    def y_label(self):
        return 5 + self.feature_dim

    @property
    def y_labelsq(self):
        return 5 + self.feature_dim + self.num_classes

    @property
    def y_geo(self):
        return 6 + self.feature_dim + self.num_classes

    @property
    def y_geon2(self):
        return 8 + self.feature_dim + self.num_classes

    @property
    def y_xiz(self):  # step pass only: xiz, xi2z, xi3z, xi4z (3 rows each)
        return 9 + self.feature_dim + self.num_classes

    @property
    def y_scalars(self):  # step pass only: normxiz2, xdx2, epsil const
        return 21 + self.feature_dim + self.num_classes

    @property
    def y_dim_flow(self):
        return 9 + self.feature_dim + self.num_classes

    @property
    def y_dim_step(self):
        return 24 + self.feature_dim + self.num_classes


def layout_for(params, x: PointCloud) -> PackLayout:
    return PackLayout(
        feature_dim=x.feature_dim if params.is_using_intensity else 0,
        num_classes=x.num_classes if params.is_using_semantics else 0,
        use_geometry=bool(params.is_using_geometry),
        use_intensity=bool(params.is_using_intensity),
        use_semantics=bool(params.is_using_semantics),
        use_geo_type=bool(params.is_using_geometric_type),
        use_range_ell_step=bool(params.is_using_range_ell),
    )


def cloud_center(x: PointCloud) -> torch.Tensor:
    """Masked centroid. d2 and every (x - y) dot are translation invariant,
    and centred coordinates keep the f32 sums well-conditioned at KITTI
    ranges."""
    w = x.mask
    return torch.sum(x.xyz * w[:, None], dim=0) / torch.clamp(torch.sum(w), min=1.0)


def _norm_rows(a: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * a, dim=-1)


def pack_x(params, lo: PackLayout, x: PointCloud, ell, center=None) -> torch.Tensor:
    """[N, Dx] packed source rows. Invalid rows get d2 gate -1 (the
    geometric gate never passes) and +PAD_BIG squared channel norms."""
    N, dev = x.capacity, x.xyz.device
    f32 = torch.float32
    xyz = x.xyz if center is None else x.xyz - center
    pad = torch.where(x.mask > 0, 0.0, PAD_BIG)[:, None]
    rng = range_ell(ell, torch.sqrt(_norm_rows(x.xyz)))
    two_l2 = 2.0 * rng * rng
    d2_thres = -two_l2 * geometric_constants(params)[2]
    d2_thres = torch.where(x.mask > 0, d2_thres, torch.full_like(d2_thres, -1.0))
    step_l = rng if lo.use_range_ell_step else ell * torch.ones((N,), dtype=f32, device=dev)
    coef = 1.0 / (2.0 * step_l * step_l)
    cols = [xyz, x.mask[:, None], (-1.0 / two_l2)[:, None], d2_thres[:, None], coef[:, None]]
    zero1 = torch.zeros((N, 1), dtype=f32, device=dev)
    for on, f in ((lo.use_intensity, x.features), (lo.use_semantics, x.labels)):
        cols += [f, _norm_rows(f)[:, None] + pad] if on else [zero1]
    g = x.geometric_types if x.geometric_types is not None else torch.zeros((N, 2), dtype=f32, device=dev)
    cols += [g, _norm_rows(g)[:, None]]
    return torch.cat(cols, dim=1)


def pack_y(lo: PackLayout, y: PointCloud, twist: Optional[torch.Tensor] = None,
           center=None) -> torch.Tensor:
    """[Dy, M] packed target rows, transposed. With `twist`, the step pass's
    rows are appended: the flow derivatives xiz..xi4z and the per-target
    scalars normxiz2, xdx2, epsil const, all from UNcentred coordinates
    (xiz = W y + v depends on position); only the xyz rows are centred."""
    M, dev = y.capacity, y.xyz.device
    f32 = torch.float32
    xyz_c = y.xyz if center is None else y.xyz - center
    pad = torch.where(y.mask > 0, 0.0, PAD_BIG)[None, :]
    rows = [xyz_c.T, pad]
    zero1 = torch.zeros((1, M), dtype=f32, device=dev)
    for on, f in ((lo.use_intensity, y.features), (lo.use_semantics, y.labels)):
        rows += [f.T, _norm_rows(f)[None, :] + pad] if on else [zero1]
    g = y.geometric_types if y.geometric_types is not None else torch.zeros((M, 2), dtype=f32, device=dev)
    rows += [g.T, _norm_rows(g)[None, :]]
    if twist is not None:
        omega, v = twist[:3], twist[3:]
        W = lie.skew(omega)
        W2 = W @ W
        W3 = W2 @ W
        W4 = W2 @ W2
        yy = y.xyz
        xiz = yy @ W.T + v
        xi2z = yy @ W2.T + W @ v
        xi3z = yy @ W3.T + W2 @ v
        xi4z = yy @ W4.T + W3 @ v
        normxiz2 = _norm_rows(xiz)
        xdx2 = -torch.sum(xiz * xi2z, -1)
        epsc = _norm_rows(xi2z) + 2.0 * torch.sum(xiz * xi3z, -1)
        rows += [xiz.T, xi2z.T, xi3z.T, xi4z.T,
                 normxiz2[None, :], xdx2[None, :], epsc[None, :]]
    return torch.cat(rows, dim=0)


class TileCompaction(NamedTuple):
    """Active (source tile, target tile) pairs packed front-first, i-major."""

    pair_i: torch.Tensor   # [P] int32 source-tile index, actives first
    pair_j: torch.Tensor   # [P] int32 target-tile index
    first: torch.Tensor    # [P] int32, 1 = first active pair of its source tile
    row_has: torch.Tensor  # [nI] bool, source tile has >= 1 active pair
    n: torch.Tensor        # [] int32 active count (>= 1)


def _compact(tile_mask: torch.Tensor):
    """(pair_i, pair_j, first, row_has, n) of compact_tile_mask for each
    [nI, nJ] mask of a [B, nI, nJ] stack: a stable partition keeps each
    mask's actives first, in row-major order."""
    B, nI, nJ = tile_mask.shape
    dev = tile_mask.device
    i32 = torch.int32
    flat = tile_mask.reshape(B, -1) > 0
    P = nI * nJ
    act = flat.to(i32)
    n_act = torch.sum(act, dim=1)
    pos = torch.where(flat, torch.cumsum(act, 1) - 1,
                      n_act[:, None] + torch.cumsum(1 - act, 1) - 1)
    order = torch.zeros((B, P), dtype=i32, device=dev).scatter_(
        1, pos.to(torch.int64), torch.arange(P, dtype=i32, device=dev).expand(B, P))
    pi = torch.div(order, nJ, rounding_mode="floor")
    pj = order - pi * nJ
    first = torch.cat([torch.ones((B, 1), dtype=i32, device=dev),
                       (pi[:, 1:] != pi[:, :-1]).to(i32)], dim=1)
    n = torch.clamp(n_act, min=1).to(i32)
    # tail entries past n are inactive and must not mark a tile's start
    first = first * (torch.arange(P, device=dev)[None, :] < n[:, None]).to(i32)
    return pi, pj, first, torch.any(tile_mask > 0, dim=2), n


def compact_tile_mask(tile_mask: torch.Tensor) -> TileCompaction:
    """[nI, nJ] 0/1 mask -> TileCompaction, all on the mask's device. A
    stable partition keeps the actives in row-major order, so each source
    tile's pairs are consecutive and pair_i is sorted over the first n."""
    return TileCompaction(*(t[0] for t in _compact(tile_mask[None])))


class TileCompactionLanes(NamedTuple):
    """Every lane's TileCompaction ([B, ...] fields, each lane's list as
    compact_tile_mask gives it for that lane alone) and the joined walk over
    them: lane b's entries are the first n[b] of its list, at offset[b] of
    the lanes' lists laid end to end. All on the device."""

    pair_i: torch.Tensor   # [B, P] int32
    pair_j: torch.Tensor   # [B, P] int32
    first: torch.Tensor    # [B, P] int32
    row_has: torch.Tensor  # [B, nI] bool
    n: torch.Tensor        # [B] int32: compact_tile_mask's count, 0 on a frozen lane
    offset: torch.Tensor   # [B] int32: exclusive prefix sum of n
    total: torch.Tensor    # [] int32: sum of n

    def lane(self, b: int) -> TileCompaction:
        """Lane b's TileCompaction (its count n[b])."""
        return TileCompaction(pair_i=self.pair_i[b], pair_j=self.pair_j[b],
                              first=self.first[b], row_has=self.row_has[b], n=self.n[b])


def compact_tile_mask_lanes(tile_mask: torch.Tensor, live=None) -> TileCompactionLanes:
    """[B, nI, nJ] 0/1 masks -> TileCompactionLanes: lane b's list, first
    and row_has are compact_tile_mask(tile_mask[b])'s, its count too unless
    `live` [B] bool is false there (a frozen lane: count 0). Counts and
    offsets stay on the device."""
    pi, pj, first, row_has, n = _compact(tile_mask)
    if live is not None:
        n = torch.where(live, n, torch.zeros_like(n))
    ends = torch.cumsum(n, 0).to(torch.int32)
    return TileCompactionLanes(pair_i=pi, pair_j=pj, first=first, row_has=row_has, n=n,
                               offset=ends - n, total=ends[-1])


class _Consts(NamedTuple):
    """Kernel constants as exact f32 values (Python floats). The channel
    exponents are d2 * (-1 / (2 ell^2)), a product in the kernel and its
    plain version alike (a tensor-by-scalar division may be computed as a
    product with the reciprocal, which would round differently)."""
    sigma2: float
    sp: float
    c_sigma2: float
    c_thres: float
    c_neg_inv_two_ell2: float
    s_sigma2: float
    s_thres: float
    s_neg_inv_two_ell2: float


def _channel(ell: float, sigma: float, sp_thres: float):
    sigma2, thres, two_ell2 = channel_constants(ell, sigma, sp_thres)
    f32 = torch.float32
    return sigma2, thres, float(torch.tensor(-1.0, dtype=f32) / torch.tensor(two_ell2, dtype=f32))


def _consts(params) -> _Consts:
    sigma2, sp, _ = geometric_constants(params)
    return _Consts(sigma2, sp, *_channel(params.c_ell, params.c_sigma, params.sp_thres),
                   *_channel(params.s_ell, params.s_sigma, params.sp_thres))


def _a_tiles(lo: PackLayout, k: _Consts, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    """Kernel-matrix tiles [B, TI, TJ] from packed source tiles xb [B, TI, Dx]
    and target tiles yb [B, Dy, TJ] (_a_block semantics), with every
    elementwise operation in the order csrc/dense.cu performs it and the
    channel dots as explicit sums, so gates decide the same way."""
    def xc(col):
        return xb[:, :, col:col + 1]

    def yr(row):
        return yb[:, row:row + 1, :]

    a = ok = None
    if lo.use_geo_type:
        dot = xc(lo.x_geo) * yr(lo.y_geo) + xc(lo.x_geo + 1) * yr(lo.y_geo + 1)
        n2 = xc(lo.x_geon2) * yr(lo.y_geon2)
        a = dot * dot * (1.0 / torch.clamp(n2, min=1e-12))
        ok = a >= 0.01
    if lo.use_geometry:
        d2 = yr(lo.y_pad)
        for c in range(3):
            diff = xc(lo.x_xyz + c) - yr(lo.y_xyz + c)
            d2 = d2 + diff * diff
        gate = d2 < xc(lo.x_d2thres)
        ok = gate if ok is None else ok & gate
        kg = k.sigma2 * torch.exp(d2 * xc(lo.x_twol2))
        a = kg if a is None else a * kg
    for on, dim, xf, yf, xsq, ysq, sig2, thres, neg_inv in (
            (lo.use_intensity, lo.feature_dim, lo.x_feat, lo.y_feat, lo.x_featsq,
             lo.y_featsq, k.c_sigma2, k.c_thres, k.c_neg_inv_two_ell2),
            (lo.use_semantics, lo.num_classes, lo.x_label, lo.y_label, lo.x_labelsq,
             lo.y_labelsq, k.s_sigma2, k.s_thres, k.s_neg_inv_two_ell2)):
        if not on:
            continue
        cross = torch.zeros((), dtype=xb.dtype, device=xb.device)
        for f in range(dim):
            cross = cross + xc(xf + f) * yr(yf + f)
        d2c = torch.clamp(xc(xsq) + yr(ysq) - 2.0 * cross, min=0.0)
        gate = d2c < thres
        ok = gate if ok is None else ok & gate
        ck = sig2 * torch.exp(d2c * neg_inv)
        a = ck if a is None else a * ck
    if a is None:
        # no active channel: only validity gates (a == 1, no sp_thres test)
        ok = (xc(lo.x_mask) > 0) & (yr(lo.y_pad) == 0.0)
        return ok.to(xb.dtype)
    return torch.where(ok & (a > k.sp), a, torch.zeros_like(a))


def _active_batches(comp: TileCompaction, xp, yp, tile_i, tile_j):
    """Yield (pi, xb [B, TI, Dx], yb [B, Dy, TJ]) over the first n pairs of
    the compaction, PLAIN_BATCH[device] pairs at a time. Reads n to the host: the
    plain versions are the CPU path and the oracle, not the card's loop."""
    N, Dx = xp.shape
    Dy, M = yp.shape
    xt = xp.reshape(N // tile_i, tile_i, Dx)
    yt = yp.reshape(Dy, M // tile_j, tile_j).permute(1, 0, 2)
    n = int(comp.n)
    batch = PLAIN_BATCH[xp.device.type]
    for b0 in range(0, n, batch):
        b1 = min(n, b0 + batch)
        pi = comp.pair_i[b0:b1].to(torch.int64)
        pj = comp.pair_j[b0:b1].to(torch.int64)
        yield pi, xt[pi], yt[pj]


def geometric_gate_count(lo: PackLayout, xp, yp, comp: TileCompaction,
                         tile_i: int, tile_j: int) -> int:
    """Point pairs of the active tile pairs that pass the geometric gate
    d2 < d2_thres (every pair without geometry): the pairs whose channels a
    pass has to evaluate; all others contribute exactly zero."""
    total = 0
    for _, xb, yb in _active_batches(comp, xp, yp, tile_i, tile_j):
        if not lo.use_geometry:
            total += xb.shape[0] * tile_i * tile_j
            continue
        d2 = yb[:, lo.y_pad:lo.y_pad + 1, :]
        for c in range(3):
            diff = xb[:, :, c:c + 1] - yb[:, c:c + 1, :]
            d2 = d2 + diff * diff
        total += int(torch.sum(d2 < xb[:, :, lo.x_d2thres:lo.x_d2thres + 1]))
    return total


def dense_flow_plain(params, lo: PackLayout, xp, yp, comp: TileCompaction,
                     tile_i: int, tile_j: int):
    """Plain version of the flow kernel: (s [N], wy [N, 3] centred,
    nonzeros int32, a_sum) over the compaction's active pairs; rows of
    source tiles with no active pair are zero."""
    k = _consts(params)
    N = xp.shape[0]
    nI = N // tile_i
    dev = xp.device
    s = torch.zeros((nI, tile_i), dtype=torch.float32, device=dev)
    wy = torch.zeros((nI, tile_i, 3), dtype=torch.float32, device=dev)
    cnt = torch.zeros((nI, tile_i), dtype=torch.int64, device=dev)
    for pi, xb, yb in _active_batches(comp, xp, yp, tile_i, tile_j):
        a = _a_tiles(lo, k, xb, yb)
        s.index_add_(0, pi, torch.sum(a, dim=-1))
        wy.index_add_(0, pi, torch.stack(
            [torch.sum(a * yb[:, lo.y_xyz + c:lo.y_xyz + c + 1, :], dim=-1)
             for c in range(3)], dim=-1))
        cnt.index_add_(0, pi, torch.sum(a > 0, dim=-1))
    keep = comp.row_has[:, None]
    s = torch.where(keep, s, torch.zeros_like(s)).reshape(N)
    wy = torch.where(keep[..., None], wy, torch.zeros_like(wy)).reshape(N, 3)
    nz = torch.sum(torch.where(keep, cnt, torch.zeros_like(cnt))).to(torch.int32)
    return s, wy, nz, torch.sum(s)


def dense_step_plain(params, lo: PackLayout, xp, yp, comp: TileCompaction,
                     tile_i: int, tile_j: int) -> torch.Tensor:
    """Plain version of the step kernel: [4] = (B, C, D, E) over the
    compaction's active pairs (_step_tile, term by term)."""
    k = _consts(params)
    N = xp.shape[0]
    nI = N // tile_i
    rows = torch.zeros((nI, tile_i, 4), dtype=torch.float32, device=xp.device)
    for pi, xb, yb in _active_batches(comp, xp, yp, tile_i, tile_j):
        a = _a_tiles(lo, k, xb, yb)

        def xc(col):
            return xb[:, :, col:col + 1]

        def yr(row):
            return yb[:, row:row + 1, :]

        diffs = [xc(lo.x_xyz + c) - yr(lo.y_xyz + c) for c in range(3)]

        def dots(q):
            """(x_i - y_j) . xi{q+1}z_j from the packed twist rows."""
            acc = diffs[0] * yr(lo.y_xiz + 3 * q)
            acc = acc + diffs[1] * yr(lo.y_xiz + 3 * q + 1)
            return acc + diffs[2] * yr(lo.y_xiz + 3 * q + 2)

        coef = xc(lo.x_coef)
        d1, d2_, d3, d4 = dots(0), dots(1), dots(2), dots(3)
        normxiz2, xdx2, epsc = (yr(lo.y_scalars + r) for r in range(3))
        beta = -2.0 * coef * d1
        gamma = -coef * (normxiz2 + 2.0 * d2_)
        delta = 2.0 * coef * (xdx2 - d3)
        epsil = -coef * (epsc + 2.0 * d4)
        b2 = beta * beta
        rows.index_add_(0, pi, torch.stack([
            torch.sum(a * beta, dim=-1),
            torch.sum(a * (gamma + 0.5 * b2), dim=-1),
            torch.sum(a * (delta + beta * gamma + b2 * beta / 6.0), dim=-1),
            torch.sum(a * (epsil + beta * delta + 0.5 * b2 * gamma
                           + 0.5 * gamma * gamma + b2 * b2 / 24.0), dim=-1),
        ], dim=-1))
    keep = comp.row_has[:, None, None]
    return torch.sum(torch.where(keep, rows, torch.zeros_like(rows)), dim=(0, 1))


def dense_flow_lanes_plain(params, lo: PackLayout, xp, yp, comp: TileCompactionLanes,
                           tile_i: int, tile_j: int):
    """Plain version of the lane-axis flow pass: dense_flow_plain lane by
    lane -> (s [B, N], wy [B, N, 3], nonzeros [B], a_sum [B])."""
    outs = [dense_flow_plain(params, lo, xp[b], yp[b], comp.lane(b), tile_i, tile_j)
            for b in range(xp.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def dense_step_lanes_plain(params, lo: PackLayout, xp, yp, comp: TileCompactionLanes,
                           tile_i: int, tile_j: int) -> torch.Tensor:
    """Plain version of the lane-axis step pass: dense_step_plain lane by
    lane -> [B, 4]."""
    return torch.stack([dense_step_plain(params, lo, xp[b], yp[b], comp.lane(b), tile_i, tile_j)
                        for b in range(xp.shape[0])])


def kernel_instance(lo: PackLayout) -> str:
    """Which instantiation of the CUDA passes a channel set runs (the C
    entry points choose the same way from the same flags)."""
    key = (lo.use_geometry, lo.use_intensity, lo.use_semantics, lo.use_geo_type,
           lo.feature_dim, lo.num_classes)
    return {(True, True, False, False, 5, 0): "colour",
            (True, True, True, True, 5, 19): "all_channels",
            (True, False, False, False, 0, 0): "geometry"}.get(key, "generic")


def row_blocks(tile_i: int) -> int:
    """Work items per active tile pair: one per KERNEL_ROW_BLOCK source rows."""
    return -(-tile_i // KERNEL_ROW_BLOCK)


def scratch_shapes(N: int, M: int, tile_i: int, tile_j: int, lanes: int = 1):
    """Shapes of the per-item partials the CUDA passes write before their
    fixed-order sums: flow [pairs, 5, tile_i] (s, wy, cnt as int bits per
    row of every tile pair), step [pairs * row blocks, 4] (B..E per item),
    `lanes` times as many with a lane axis. Sized for every pair active:
    the active count stays on the device."""
    pairs = lanes * (N // tile_i) * (M // tile_j)
    return {"flow": (pairs, 5, tile_i), "step": (pairs * row_blocks(tile_i), 4)}


def _checks(lo: PackLayout, xp, yp, comp, tile_i, tile_j, y_dim, who):
    """Raise unless the inputs are what the CUDA passes take; with a lane
    axis (comp a TileCompactionLanes) every array leads with B."""
    if xp.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {xp.device}")
    dev = xp.device
    lanes = isinstance(comp, TileCompactionLanes)
    lead = (xp.shape[0],) if lanes else ()
    N, M = xp.shape[-2], yp.shape[-1]
    if N % tile_i or M % tile_j or tile_i % KERNEL_ROWS or tile_j % KERNEL_COLS:
        raise ValueError(f"{who}: N={N} must be a multiple of tile_i={tile_i}, itself a "
                         f"multiple of {KERNEL_ROWS}, and M={M} a multiple of tile_j={tile_j}, "
                         f"itself a multiple of {KERNEL_COLS}")
    if yp.data_ptr() % 16:
        raise ValueError(f"{who}: yp must be 16-byte aligned")
    P = (N // tile_i) * (M // tile_j)
    cuda_lib.check_tensor(xp, "xp", torch.float32, lead + (N, lo.x_dim), dev, who)
    cuda_lib.check_tensor(yp, "yp", torch.float32, lead + (y_dim, M), dev, who)
    fields = [("pair_i", comp.pair_i, torch.int32, lead + (P,)),
              ("pair_j", comp.pair_j, torch.int32, lead + (P,)),
              ("row_has", comp.row_has, torch.bool, lead + (N // tile_i,)),
              ("n", comp.n, torch.int32, lead)]
    if lanes:
        fields += [("offset", comp.offset, torch.int32, lead),
                   ("total", comp.total, torch.int32, ())]
    for name, t, dt, shape in fields:
        cuda_lib.check_tensor(t, name, dt, shape, dev, who)
    return dev, N, M


def _flags(lo: PackLayout):
    vals = (lo.feature_dim, lo.num_classes, int(lo.use_geometry), int(lo.use_intensity),
            int(lo.use_semantics), int(lo.use_geo_type))
    return (ctypes.c_int * len(vals))(*vals)


def _cconsts(params):
    vals = _consts(params)
    return (ctypes.c_float * len(vals))(*vals)


def dense_flow(params, lo: PackLayout, xp, yp, comp: TileCompaction,
               tile_i: int, tile_j: int):
    """Flow pass: (s [N], wy [N, 3] centred, nonzeros int32, a_sum). The CUDA
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if xp.device.type == "cpu":
        return dense_flow_plain(params, lo, xp, yp, comp, tile_i, tile_j)
    dev, N, M = _checks(lo, xp, yp, comp, tile_i, tile_j, lo.y_dim_flow, "dense_flow")
    lib = _lib()
    part = torch.empty(scratch_shapes(N, M, tile_i, tile_j)["flow"], dtype=torch.float32,
                       device=dev)
    s = torch.empty((N,), dtype=torch.float32, device=dev)
    wy = torch.empty((N, 3), dtype=torch.float32, device=dev)
    cnt = torch.empty((N,), dtype=torch.int32, device=dev)
    a_sum = torch.empty((1,), dtype=torch.float32, device=dev)
    nz = torch.empty((1,), dtype=torch.int32, device=dev)
    err = lib.cvo_dense_flow(
        _flags(lo), _cconsts(params), xp.data_ptr(), yp.data_ptr(),
        comp.pair_i.data_ptr(), comp.pair_j.data_ptr(), comp.row_has.data_ptr(),
        comp.n.data_ptr(), part.data_ptr(), s.data_ptr(), wy.data_ptr(), cnt.data_ptr(),
        a_sum.data_ptr(), nz.data_ptr(), N, M, tile_i, tile_j,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, "dense_flow kernel launch")
    dense_flow.launches += 1
    return s, wy, nz[0], a_sum[0]


dense_flow.launches = 0


def dense_step(params, lo: PackLayout, xp, yp, comp: TileCompaction,
               tile_i: int, tile_j: int) -> torch.Tensor:
    """Step pass: [4] = (B, C, D, E). The CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if xp.device.type == "cpu":
        return dense_step_plain(params, lo, xp, yp, comp, tile_i, tile_j)
    dev, N, M = _checks(lo, xp, yp, comp, tile_i, tile_j, lo.y_dim_step, "dense_step")
    lib = _lib()
    part = torch.empty(scratch_shapes(N, M, tile_i, tile_j)["step"], dtype=torch.float32,
                       device=dev)
    out = torch.empty((4,), dtype=torch.float32, device=dev)
    err = lib.cvo_dense_step(
        _flags(lo), _cconsts(params), xp.data_ptr(), yp.data_ptr(),
        comp.pair_i.data_ptr(), comp.pair_j.data_ptr(), comp.row_has.data_ptr(),
        comp.n.data_ptr(), part.data_ptr(), out.data_ptr(), N, M, tile_i, tile_j,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, "dense_step kernel launch")
    dense_step.launches += 1
    return out


dense_step.launches = 0


def dense_flow_lanes(params, lo: PackLayout, xp, yp, comp: TileCompactionLanes,
                     tile_i: int, tile_j: int):
    """Flow pass of B lanes in one call: xp [B, N, Dx], yp [B, Dy, M] ->
    (s [B, N], wy [B, N, 3] centred, nonzeros [B] int32, a_sum [B]), lane b
    as dense_flow on its inputs and comp.lane(b) (zeros where its count is
    0). The CUDA kernels (as many as one dense_flow call) on a CUDA tensor,
    the plain version on a CPU tensor."""
    if xp.device.type == "cpu":
        return dense_flow_lanes_plain(params, lo, xp, yp, comp, tile_i, tile_j)
    dev, N, M = _checks(lo, xp, yp, comp, tile_i, tile_j, lo.y_dim_flow, "dense_flow_lanes")
    B = xp.shape[0]
    lib = _lib()
    part = torch.empty(scratch_shapes(N, M, tile_i, tile_j, B)["flow"], dtype=torch.float32,
                       device=dev)
    s = torch.empty((B, N), dtype=torch.float32, device=dev)
    wy = torch.empty((B, N, 3), dtype=torch.float32, device=dev)
    cnt = torch.empty((B, N), dtype=torch.int32, device=dev)
    a_sum = torch.empty((B,), dtype=torch.float32, device=dev)
    nz = torch.empty((B,), dtype=torch.int32, device=dev)
    err = lib.cvo_dense_flow_lanes(
        _flags(lo), _cconsts(params), xp.data_ptr(), yp.data_ptr(),
        comp.pair_i.data_ptr(), comp.pair_j.data_ptr(), comp.row_has.data_ptr(),
        comp.n.data_ptr(), comp.offset.data_ptr(), comp.total.data_ptr(), part.data_ptr(),
        s.data_ptr(), wy.data_ptr(), cnt.data_ptr(), a_sum.data_ptr(), nz.data_ptr(), B, N, M,
        tile_i, tile_j, torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, "dense_flow_lanes kernel launch")
    dense_flow_lanes.launches += 1
    return s, wy, nz, a_sum


dense_flow_lanes.launches = 0


def dense_step_lanes(params, lo: PackLayout, xp, yp, comp: TileCompactionLanes,
                     tile_i: int, tile_j: int) -> torch.Tensor:
    """Step pass of B lanes in one call: [B, 4], lane b as dense_step on its
    inputs and comp.lane(b) (zeros where its count is 0). The CUDA kernels
    (as many as one dense_step call) on a CUDA tensor, the plain version on
    a CPU tensor."""
    if xp.device.type == "cpu":
        return dense_step_lanes_plain(params, lo, xp, yp, comp, tile_i, tile_j)
    dev, N, M = _checks(lo, xp, yp, comp, tile_i, tile_j, lo.y_dim_step, "dense_step_lanes")
    B = xp.shape[0]
    lib = _lib()
    part = torch.empty(scratch_shapes(N, M, tile_i, tile_j, B)["step"], dtype=torch.float32,
                       device=dev)
    out = torch.empty((B, 4), dtype=torch.float32, device=dev)
    err = lib.cvo_dense_step_lanes(
        _flags(lo), _cconsts(params), xp.data_ptr(), yp.data_ptr(),
        comp.pair_i.data_ptr(), comp.pair_j.data_ptr(), comp.row_has.data_ptr(),
        comp.n.data_ptr(), comp.offset.data_ptr(), comp.total.data_ptr(), part.data_ptr(),
        out.data_ptr(), B, N, M, tile_i, tile_j, torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, "dense_step_lanes kernel launch")
    dense_step_lanes.launches += 1
    return out


dense_step_lanes.launches = 0


def _prepare(params, ell, x: PointCloud, y_t: PointCloud, tile_i, tile_j,
             tile_mask, compaction):
    lo = layout_for(params, x)
    x = pad_cloud_to_multiple(x, tile_i)
    y_t = pad_cloud_to_multiple(y_t, tile_j)
    if compaction is None:
        nI, nJ = x.capacity // tile_i, y_t.capacity // tile_j
        if tile_mask is None:
            tile_mask = torch.ones((nI, nJ), dtype=torch.int32, device=x.xyz.device)
        if tuple(tile_mask.shape) != (nI, nJ):
            raise ValueError(f"tile_mask shape {tuple(tile_mask.shape)} != {(nI, nJ)}")
        compaction = compact_tile_mask(tile_mask)
    center = cloud_center(x)
    ell = torch.as_tensor(ell, dtype=torch.float32, device=x.xyz.device)
    return lo, x, y_t, center, pack_x(params, lo, x, ell, center=center), compaction


def flow_stats_tiled(params, ell, x: PointCloud, y_t: PointCloud,
                     tile_i: int = DEFAULT_TILE_I, tile_j: int = DEFAULT_TILE_J,
                     tile_mask=None, compaction: Optional[TileCompaction] = None
                     ) -> FlowStats:
    """Dense tiled flow statistics over the active tile pairs (all pairs
    without a mask or compaction); counterpart of flow_stats_pallas."""
    n_orig = x.capacity
    lo, x, y_t, center, xp, comp = _prepare(params, ell, x, y_t, tile_i, tile_j,
                                            tile_mask, compaction)
    yp = pack_y(lo, y_t, center=center)
    s, wy, nz, a_sum = dense_flow(params, lo, xp, yp, comp, tile_i, tile_j)
    # the pass accumulated sum_j a_ij (y_j - c): restore the raw-frame wy
    wy = wy + s[:, None] * center[None, :]
    return FlowStats(row_sum=s[:n_orig], row_wy=wy[:n_orig], nonzeros=nz, a_sum=a_sum)


def step_coeffs_tiled(params, ell, x: PointCloud, y_t: PointCloud, twist,
                      tile_i: int = DEFAULT_TILE_I, tile_j: int = DEFAULT_TILE_J,
                      tile_mask=None, compaction: Optional[TileCompaction] = None):
    """Dense tiled step coefficients (B, C, D, E); counterpart of
    step_coeffs_pallas."""
    lo, x, y_t, center, xp, comp = _prepare(params, ell, x, y_t, tile_i, tile_j,
                                            tile_mask, compaction)
    twist = torch.as_tensor(twist, dtype=torch.float32, device=x.xyz.device)
    yp = pack_y(lo, y_t, twist=twist, center=center)
    B, C, D, E = dense_step(params, lo, xp, yp, comp, tile_i, tile_j)
    return B, C, D, E


_measurement_build = None


def use_build(lib=None) -> None:
    """Route the CUDA passes through `lib`, a measurement build from
    cuda_lib.load_variant("dense", ...), or back to the package's build."""
    global _measurement_build
    _measurement_build = lib


def _lib():
    return bind(_measurement_build or cuda_lib.load("dense"))


def library_instance(lo: PackLayout) -> str:
    """The instantiation the loaded CUDA library picks for this channel set."""
    return KERNEL_INSTANCES[_lib().cvo_dense_instance(_flags(lo))]


def library_has_first_look() -> bool:
    """False only in a measurement build that evaluates every pair in full."""
    return bool(_lib().cvo_dense_prefilter())


def bind(lib):
    """Declare the C interface of a build of csrc/dense.cu."""
    if not getattr(lib, "_argtypes_set", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        PI, PF = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
        lib.cvo_dense_instance.argtypes = [PI]
        lib.cvo_dense_instance.restype = I
        lib.cvo_dense_prefilter.argtypes = []
        lib.cvo_dense_prefilter.restype = I
        lib.cvo_dense_flow.argtypes = [PI, PF, P, P, P, P, P, P, P, P, P, P, P, P,
                                       I, I, I, I, P]
        lib.cvo_dense_flow.restype = I
        lib.cvo_dense_step.argtypes = [PI, PF, P, P, P, P, P, P, P, P, I, I, I, I, P]
        lib.cvo_dense_step.restype = I
        lib.cvo_dense_flow_lanes.argtypes = [PI, PF, P, P, P, P, P, P, P, P, P, P, P, P, P, P,
                                             I, I, I, I, I, P]
        lib.cvo_dense_flow_lanes.restype = I
        lib.cvo_dense_step_lanes.argtypes = [PI, PF, P, P, P, P, P, P, P, P, P, P,
                                             I, I, I, I, I, P]
        lib.cvo_dense_step_lanes.restype = I
        lib._argtypes_set = True
    return lib
