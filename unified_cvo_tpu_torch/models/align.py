"""Pairwise RKHS registration by se(3) gradient flow (port of
unified_cvo_tpu/models/align.py): the ELL backend and the dense backends.

Every backend runs the same iteration (align.py:396-537):
    1. flow pass -> row statistics or moments -> unit twist
    2. step pass -> B, C, D, E -> cubic step size       (ops/poly.py)
    3. degenerate-flow / eps breaks (CvoGPU.cu:1452-1458)
    4. pose update R <- R dR, T <- R dT + T with (dR, dT) = exp(step twist)
    5. step-distance break ||log(dR, dT)|| < eps_2 (CvoGPU.cu:1505-1508)
    6. indicator update; past ell_decay_start, ell decays when the two
       indicator windows agree (CvoGPU.cu:1509-1517); under adaptive ell
       (ACVO, AdaptiveCvoGPU.cu) ell follows its own gradient instead,
       from three weighted sums over the xy, xx and yy kernels
       (align.py:464-496)
and differs in the two passes:
  'ell'     a Verlet candidate list (grid or scan builder), rebuilt when
            the O(1) drift bound says a target may have moved more than the
            skin since the build, never without geometry (align.py:557-633;
            select, flow and step kernels on the card); colour, semantic and
            geometric-type channels enter as the list's build-time factor
            `chan`; under ACVO the xx and yy lists are built beside xy and
            all three are checked for drift and ell growth;
  'pallas'  dense tiles over Morton-sorted clouds, with (source tile x
            target tile) pairs beyond the kernel support culled every
            iteration (align.py:324-364; dense flow and step kernels on the
            card, their plain versions on the CPU);
  'jnp'     the blocked plain passes of ops/kernels.py, on any device.

All state stays on the device. The loop is a Python loop that reads one
small flag tensor back to the host per iteration (done, and on the ELL path
with geometry drift), and counts those reads in AlignInfo.host_reads.

The analysis entry points `inner_product`, `function_angle`,
`compute_association` and `compute_association_non_isotropic`
(align.py:764-863) evaluate the kernel at a given transform, without a loop.

Transform conventions follow the reference exactly: the loop state (R, T)
starts at init_guess and the RETURNED transform is its inverse
[R^T, -R^T T] (update_tf, CvoGPU.cu:94-112).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from unified_cvo_tpu_torch.config import CvoParams
from unified_cvo_tpu_torch.device import resolve_device
from unified_cvo_tpu_torch.ops import dense
from unified_cvo_tpu_torch.ops import ell as ell_ops
from unified_cvo_tpu_torch.ops import indicator as indicator_ops
from unified_cvo_tpu_torch.ops import kernels
from unified_cvo_tpu_torch.ops import lie
from unified_cvo_tpu_torch.ops import morton
from unified_cvo_tpu_torch.ops import neighbors as nbr
from unified_cvo_tpu_torch.ops.poly import step_from_poly
from unified_cvo_tpu_torch.utils.pointcloud import PointCloud

BACKENDS = ("auto", "ell", "pallas", "jnp")
NL_BUILDERS = ("auto", "grid", "scan")


class AlignInfo(NamedTuple):
    iterations: int
    final_ell: torch.Tensor
    final_step: torch.Tensor
    final_dist: torch.Tensor
    nonzeros: torch.Tensor
    inner_product: torch.Tensor
    history: Optional[dict] = None              # record_history: six [max_iter]
    #   f32 arrays (ell, step, dist, ip, nonzeros, a_sum), zero past the end
    nl_overflow: Optional[torch.Tensor] = None  # candidates dropped by the
    #   K / per-cell caps, max over builds (0 = the list was exact)
    nl_rebuilds: Optional[int] = None           # neighbor-list builds (>= 1)
    host_reads: int = 0                         # device-to-host flag reads
    backend: Optional[str] = None               # the backend that ran
    nl_builder: Optional[str] = None            # 'grid' or 'scan' on 'ell'


def has_rank_channel(params) -> bool:
    """Some channel ranks the ELL candidates: distance or a channel kernel."""
    return bool(params.is_using_geometry or nbr.has_channels(params))


def _adaptive(params, adaptive_ell) -> bool:
    return bool(params.is_ell_adaptive) if adaptive_ell is None else bool(adaptive_ell)


def resolve_backend(params, source_cap: int, target_cap: int,
                    backend: str = "auto", device=None,
                    adaptive_ell: Optional[bool] = None) -> str:
    """The JAX package's backend policy (align.py:94-122): 'ell' for large
    clouds with a ranking channel and, under adaptive ell, geometry (the
    support can grow, and the growth bound is geometric); otherwise a dense
    backend, 'jnp' for clouds under 4096 points and on the CPU, 'pallas'
    else. 'ell' under adaptive ell without geometry, or without a ranking
    channel, raises ValueError, as in JAX (align.py:248-256).
    `adaptive_ell=None` reads params.is_ell_adaptive."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; the port runs {BACKENDS}")
    adaptive = _adaptive(params, adaptive_ell)
    if backend == "auto":
        if (has_rank_channel(params) and (not adaptive or params.is_using_geometry)
                and source_cap >= 4096 and target_cap >= 4096):
            return "ell"
        if (device is not None and torch.device(device).type == "cpu") \
                or max(source_cap, target_cap) < 4096:
            return "jnp"
        return "pallas"
    if backend == "ell" and adaptive and not params.is_using_geometry:
        raise ValueError("backend='ell' with adaptive_ell needs the geometric channel "
                         "(the ACVO dl gradient is geometric); use 'pallas' or 'jnp'")
    if backend == "ell" and not has_rank_channel(params):
        raise ValueError("backend='ell' needs at least one kernel channel to rank "
                         "candidates; use 'pallas' or 'jnp'")
    return backend


def resolve_nl_builder(params, source_cap: int, target_cap: int,
                       nl_builder: str = "auto",
                       adaptive_ell: Optional[bool] = None) -> str:
    """The JAX package's builder choice (align.py:257-277): the voxel grid
    for geometric configurations whose support is at most 2 m with both
    clouds of at least 4096 points, the brute-force scan for everything
    else. The support is the one at ell_init, scaled by ell_max / ell_init
    under adaptive ell (the largest ell the solve may reach). The grid
    needs geometry to bound its cells."""
    if nl_builder not in NL_BUILDERS:
        raise ValueError(f"unknown nl_builder {nl_builder!r}; one of {NL_BUILDERS}")
    if nl_builder == "auto":
        radius = nbr.static_support_radius(params)
        if _adaptive(params, adaptive_ell):
            radius *= float(params.ell_max) / max(float(params.ell_init), 1e-6)
        grid = (bool(params.is_using_geometry) and radius <= 2.0
                and source_cap >= 4096 and target_cap >= 4096)
        return "grid" if grid else "scan"
    if nl_builder == "grid" and not params.is_using_geometry:
        raise ValueError("nl_builder='grid' needs the geometric channel to bound the "
                         "voxel cell size; use nl_builder='scan'")
    return nl_builder


HISTORY_KEYS = ("ell", "step", "dist", "ip", "nonzeros", "a_sum")


class _Schedule:
    """Loop state shared by every backend, and the part of an iteration that
    follows the two passes (align.py:440-537): step size, breaks, pose
    update, indicator and the ell schedule (decay, or under adaptive ell
    the dl gradient step), all on the device."""

    def __init__(self, params, R, T, sqrt_nxny, dev, adaptive=False, history_len=None):
        f32 = torch.float32
        self.params, self.R, self.T, self.sqrt_nxny = params, R, T, sqrt_nxny
        self.adaptive = adaptive
        self.history = None if history_len is None else {
            name: torch.zeros((history_len,), dtype=f32, device=dev) for name in HISTORY_KEYS}
        self.ell = torch.full((), params.ell_init, dtype=f32, device=dev)
        self.step = torch.zeros((), dtype=f32, device=dev)
        self.dist = torch.zeros((), dtype=f32, device=dev)
        self.nonzeros = torch.zeros((), dtype=torch.int32, device=dev)
        self.a_sum = torch.zeros((), dtype=f32, device=dev)
        self.ret = torch.zeros((), dtype=torch.int32, device=dev)
        self.ind = indicator_ops.init_state(params.indicator_window_size, dev)

    def advance(self, k: int, twist, joint_norm, nz, asum, coeffs, d2_sums=None
                ) -> torch.Tensor:
        """Apply iteration k's result; returns the on-device `finished` flag.
        Under adaptive ell, `d2_sums` holds the xy, xx and yy weighted sums
        (sum A d2, nonzeros) of this iteration."""
        p = self.params
        step_new = step_from_poly(*coeffs, p.min_step, p.max_step)
        degenerate = (joint_norm < 1e-8) | torch.isnan(joint_norm)
        eps_break = ((torch.linalg.vector_norm(twist[:3]) < p.eps)
                     & (torch.linalg.vector_norm(twist[3:]) < p.eps))
        break_now = degenerate | eps_break
        dR, dT = lie.se3_exp(twist, step_new)
        dist_new = lie.se3_distance(dR, dT)
        nan_break = torch.isnan(dist_new)
        self.ind, decrease = indicator_ops.update(
            self.ind, nz.to(torch.float32) / self.sqrt_nxny, p.indicator_stable_threshold)
        dist_break = dist_new < p.eps_2
        finished = break_now | nan_break | dist_break
        if self.history is not None:
            for name, v in zip(HISTORY_KEYS, (self.ell, step_new, dist_new,
                                              nz.to(torch.float32) / self.sqrt_nxny, nz, asum)):
                self.history[name][k] = v
        if self.adaptive:
            (s_xy, _), (s_xx, n_xx), (s_yy, n_yy) = d2_sums
            # dl = (sum Axx d2 + sum Ayy d2 - 2 sum Axy d2) / ell^3
            #      / (nz_xx + nz_yy - 2 nz_xy)   (AdaptiveCvoGPU.cu:612-712, 869-885)
            denom = (n_xx + n_yy - 2 * nz).to(torch.float32)
            dl = ((s_xx + s_yy - 2.0 * s_xy) / (self.ell ** 3)
                  / torch.where(denom == 0, torch.ones_like(denom), denom))
            self.ell = torch.where(
                finished, self.ell,
                torch.clamp(self.ell - p.dl_step * dl, p.ell_min, p.ell_max))
        elif k > p.ell_decay_start:
            decay = decrease & ~finished
            self.ell = torch.where(
                decay, torch.clamp(self.ell * p.ell_decay_rate, min=p.ell_min), self.ell)
        # the reference breaks before applying the update
        R_new = torch.where(break_now, self.R, self.R @ dR)
        self.T = torch.where(break_now, self.T, self.R @ dT + self.T)
        self.R = R_new
        self.ret = torch.where(degenerate, -1, 0).to(torch.int32)
        self.step, self.dist, self.nonzeros, self.a_sum = step_new, dist_new, nz, asum
        return finished

    def pose_inv(self):
        return lie.invert_rt(self.R, self.T)


def align(
    source: PointCloud,
    target: PointCloud,
    init_guess,
    params: CvoParams,
    device=None,
    backend: str = "auto",
    max_iter: Optional[int] = None,
    nl_k: Optional[int] = None,
    nl_skin: Optional[float] = None,
    nl_per_cell: Optional[int] = None,
    nl_builder: str = "auto",
    spatial_culling: bool = True,
    tile_i: Optional[int] = None,
    tile_j: Optional[int] = None,
    chunk: int = kernels.DEFAULT_CHUNK,
    adaptive_ell: Optional[bool] = None,
    record_history: bool = False,
):
    """Register target onto source. Returns (transform [4,4], ret, AlignInfo).

    `init_guess` has the convention of CvoGPU::align's init_guess_transform
    (the inverse of the source->target prior). `device=None` means the card;
    clouds and guess are moved there. ret is -1 after a degenerate flow.
    nl_* tune the ELL candidate list (nl_builder 'auto' picks 'grid' or
    'scan' as JAX does); spatial_culling, tile_i and tile_j the 'pallas'
    backend (defaults 128 x 512); chunk the 'jnp' backend, the scan builder
    and the dense weighted sums of adaptive ell.

    adaptive_ell: the ACVO schedule (reference AdaptiveCvoGPU.cu): ell
    follows its gradient each iteration,
      dl = (sum Axx d2 + sum Ayy d2 - 2 sum Axy d2) / ell^3
           / (nz_xx + nz_yy - 2 nz_xy),
      ell <- clip(ell - dl_step dl, ell_min, ell_max),
    in place of the indicator-window decay; None reads
    params.is_ell_adaptive. record_history fills AlignInfo.history."""
    dev = resolve_device(device)
    adaptive = _adaptive(params, adaptive_ell)
    backend = resolve_backend(params, source.capacity, target.capacity, backend, dev,
                              adaptive)
    max_iter = params.MAX_ITER if max_iter is None else max_iter
    source = source.to(dev)
    target = target.to(dev)
    guess = torch.as_tensor(init_guess, dtype=torch.float32).to(dev)
    sqrt_nxny = torch.sqrt(torch.clamp(source.num_valid * target.num_valid, min=1.0))
    st = _Schedule(params, guess[:3, :3], guess[:3, 3], sqrt_nxny, dev, adaptive,
                   max_iter if record_history else None)
    if backend == "ell":
        nl_builder = resolve_nl_builder(params, source.capacity, target.capacity,
                                        nl_builder, adaptive)
        k, host_reads, nl_overflow, rebuilds = _ell_loop(
            st, source, target, max_iter, nl_k, nl_skin, nl_per_cell, nl_builder,
            chunk)
    else:
        k, host_reads = _dense_loop(st, source, target, max_iter, backend,
                                    spatial_culling, tile_i, tile_j, chunk)
        nl_overflow = rebuilds = nl_builder = None
    Rf, Tf = st.pose_inv()
    info = AlignInfo(
        iterations=k,
        final_ell=st.ell,
        final_step=st.step,
        final_dist=st.dist,
        nonzeros=st.nonzeros,
        inner_product=st.a_sum,
        history=st.history,
        nl_overflow=nl_overflow,
        nl_rebuilds=rebuilds,
        host_reads=host_reads,
        backend=backend,
        nl_builder=nl_builder,
    )
    return lie.rt_to_mat44(Rf, Tf), st.ret, info


def _ell_loop(st: _Schedule, source, target, max_iter, nl_k, nl_skin,
              nl_per_cell, nl_builder, chunk):
    """Nested Verlet loops (align.py:557-633): the outer loop builds the
    candidate list at the current pose and ell, the inner loop iterates
    until done, the cap, or drift. Without geometry the kernel is
    pose-independent: the list is built once and the drift bound is never
    read. Under adaptive ell each build also makes the xx list (source
    against itself) and the yy list (the moved target against the target),
    whose weighted sums give the dl gradient, and the rebuild trigger adds
    each list's support growth to its drift (stale_bound_exceeded), read in
    the same flag tensor. Returns (iterations, host reads, overflow,
    builds)."""
    params = st.params
    use_geo = bool(params.is_using_geometry)
    nl_k = nbr.DEFAULT_K if nl_k is None else nl_k
    nl_skin = nbr.DEFAULT_SKIN if nl_skin is None else nl_skin
    nl_per_cell = nbr.PER_CELL_CAP if nl_per_cell is None else nl_per_cell
    dev = source.xyz.device
    nl_overflow = torch.zeros((), dtype=torch.int32, device=dev)
    I3 = torch.eye(3, dtype=torch.float32, device=dev)
    z3 = torch.zeros((3,), dtype=torch.float32, device=dev)

    def build(x, y, Rinv, Tinv):
        if nl_builder == "scan":
            return nbr.build_neighbor_list_scan(params, st.ell, x, y, Rinv, Tinv,
                                                k=nl_k, skin=nl_skin, chunk=chunk)
        return nbr.build_neighbor_list(params, st.ell, x, y, Rinv, Tinv,
                                       k=nl_k, skin=nl_skin, per_cell_cap=nl_per_cell)

    k = rebuilds = host_reads = 0
    done = False
    while not done and k < max_iter:
        Rinv, Tinv = st.pose_inv()
        nl = build(source, target, Rinv, Tinv)
        overflow = nl.overflow
        if st.adaptive:
            nl_xx = build(source, source, I3, z3)
            nl_yy = build(target.transformed(Rinv, Tinv), target, Rinv, Tinv)
            overflow = overflow + nl_xx.overflow + nl_yy.overflow
        nl_overflow = torch.maximum(nl_overflow, overflow)
        rebuilds += 1
        drift = False
        # inner loop: at least one iteration after every build (the JAX
        # loop's `fresh` flag), then until done, the cap, or drift
        while not done and k < max_iter and not drift:
            Rinv, Tinv = st.pose_inv()
            xp = ell_ops.pack_x(params, st.ell, source)
            # one scalar block per iteration: the step builds its twist
            # part from the flow's twist on the device
            scal = ell_ops.pack_scalars(params, Rinv, Tinv)
            twist, joint_norm, nz, asum, A = ell_ops.flow_reduce(
                xp, nl.y_xyz, scal, params.c, params.d, chan=nl.chan, use_geometry=use_geo)
            coeffs = ell_ops.step_cached(xp, nl.y_xyz, A, scal, twist=twist)
            d2_sums = None
            if st.adaptive:
                # the yy list is consumed with the moved target as its
                # source side, so its range-scaled l_i is the dense one
                d2_sums = (
                    nbr.weighted_d2_sum_ell(params, st.ell, source, nl, Rinv, Tinv),
                    nbr.weighted_d2_sum_ell(params, st.ell, source, nl_xx, I3, z3),
                    nbr.weighted_d2_sum_ell(params, st.ell, target.transformed(Rinv, Tinv),
                                            nl_yy, Rinv, Tinv))
            finished = st.advance(k, twist, joint_norm, nz, asum, coeffs, d2_sums)
            k += 1
            if use_geo:
                Rinv, Tinv = st.pose_inv()
                if st.adaptive:
                    stale = (nbr.stale_bound_exceeded(nl, Rinv, Tinv, st.ell, nl_skin)
                             | nbr.stale_bound_exceeded(nl_xx, I3, z3, st.ell, nl_skin)
                             | nbr.stale_bound_exceeded(nl_yy, Rinv, Tinv, st.ell, nl_skin))
                else:
                    stale = nbr.drift_bound_exceeded(nl, Rinv, Tinv, nl_skin)
                flags = torch.stack([finished, stale])
                done, drift = flags.tolist()
            else:
                done = bool(finished)
            host_reads += 1
    return k, host_reads, nl_overflow, rebuilds


def _dense_loop(st: _Schedule, source, target, max_iter, backend,
                spatial_culling, tile_i, tile_j, chunk):
    """One flat loop over the dense passes (align.py:433-439). On 'pallas'
    with the geometric channel, both clouds are Morton-sorted once after
    padding to the tiles, the source tile boxes computed once, and each
    iteration culls tile pairs from the moved target's boxes at the current
    ell into one compaction that the flow and step passes share
    (align.py:324-364). Returns (iterations, host reads)."""
    params = st.params
    tile_i = dense.DEFAULT_TILE_I if tile_i is None else tile_i
    tile_j = dense.DEFAULT_TILE_J if tile_j is None else tile_j
    culling = spatial_culling and backend == "pallas" and bool(params.is_using_geometry)
    if culling:
        source, _ = morton.sort_cloud(kernels.pad_cloud_to_multiple(source, tile_i))
        target, _ = morton.sort_cloud(kernels.pad_cloud_to_multiple(target, tile_j))
        x_lo, x_hi = morton.tile_aabbs(source.xyz, source.mask, tile_i)
    k = host_reads = 0
    done = False
    while not done and k < max_iter:
        Rinv, Tinv = st.pose_inv()
        y_t = target.transformed(Rinv, Tinv)
        if backend == "jnp":
            stats = kernels.flow_stats(params, st.ell, source, y_t, chunk)
        else:
            comp = None
            if culling:
                y_lo, y_hi = morton.tile_aabbs(y_t.xyz, y_t.mask, tile_j)
                d2max = morton.tile_d2max(params, st.ell, source.xyz, source.mask, tile_i)
                comp = dense.compact_tile_mask(
                    morton.tile_cull_mask(x_lo, x_hi, d2max, y_lo, y_hi))
            stats = dense.flow_stats_tiled(params, st.ell, source, y_t, tile_i, tile_j,
                                           compaction=comp)
        twist, joint_norm = kernels.flow_from_stats(params, source, stats)
        if backend == "jnp":
            coeffs = kernels.step_coeffs(params, st.ell, source, y_t, twist, chunk)
        else:
            coeffs = dense.step_coeffs_tiled(params, st.ell, source, y_t, twist,
                                             tile_i, tile_j, compaction=comp)
        d2_sums = None
        if st.adaptive:
            d2_sums = tuple(kernels.weighted_d2_sum(params, st.ell, a, b, chunk)
                            for a, b in ((source, y_t), (source, source), (y_t, y_t)))
        finished = st.advance(k, twist, joint_norm, stats.nonzeros, stats.a_sum, coeffs,
                              d2_sums)
        k += 1
        done = bool(finished)
        host_reads += 1
    return k, host_reads


def _moved_target(source, target, transform, dev):
    """The clouds on `dev`, and the target moved by the INVERSE of
    `transform`, as inner_product_impl moves it (CvoGPU.cu:1719-1778)."""
    T = torch.as_tensor(transform, dtype=torch.float32).to(dev)
    Rinv, Tinv = lie.invert_rt(*lie.mat44_to_rt(T))
    source, target = source.to(dev), target.to(dev)
    return source, target, target.transformed(Rinv, Tinv)


def inner_product(source: PointCloud, target: PointCloud, transform, ell,
                  params: CvoParams, chunk: int = kernels.DEFAULT_CHUNK, device=None):
    """<f(X), f(Y o T^-1)>: one kernel evaluation, summed (inner_product_impl,
    CvoGPU.cu:1719-1778). `device=None` means the card."""
    dev = resolve_device(device)
    source, _, y_t = _moved_target(source, target, transform, dev)
    ell = torch.as_tensor(ell, dtype=torch.float32).to(dev)
    return kernels.flow_stats(params, ell, source, y_t, chunk).a_sum


def function_angle(source: PointCloud, target: PointCloud, transform, ell,
                   params: CvoParams, approximate: bool = True,
                   chunk: int = kernels.DEFAULT_CHUNK, device=None):
    """cos(theta) overlap indicator (CvoGPU::function_angle,
    CvoGPU.cu:1814-1873): the inner product at `transform` over the two
    functions' norms, sqrt(number of points) each when `approximate`, else
    each cloud's inner product with itself."""
    dev = resolve_device(device)
    fxfz = inner_product(source, target, transform, ell, params, chunk, dev)
    if approximate:
        fx_norm = torch.sqrt(source.num_valid.to(dev))
        fz_norm = torch.sqrt(target.num_valid.to(dev))
    else:
        eye = torch.eye(4, dtype=torch.float32, device=dev)
        fx_norm = torch.sqrt(inner_product(source, source, eye, ell, params, chunk, dev))
        fz_norm = torch.sqrt(inner_product(target, target, eye, ell, params, chunk, dev))
    return fxfz / (fx_norm * fz_norm)


def _inliers(vals, idx, target_capacity: int):
    """Source rows with any association, and targets named by one: the
    scatter-max of JAX's `.at[].max`; index -1 maps to row 0 with value 0,
    so it never sets a flag."""
    hit = (vals > 0).to(torch.int32).reshape(-1)
    rows = torch.where(idx >= 0, idx, 0).reshape(-1).long()
    target_inliers = torch.zeros((target_capacity,), dtype=torch.int32,
                                 device=vals.device).scatter_reduce(0, rows, hit, "amax")
    return torch.any(vals > 0, dim=1), target_inliers.bool()


def compute_association(source: PointCloud, target: PointCloud, transform, ell,
                        params: CvoParams, top_k: int = 64,
                        chunk: int = kernels.DEFAULT_CHUNK, device=None):
    """Soft data association export (CvoGPU::compute_association_gpu,
    CvoGPU.cu:1876-1995): per source row the top-k (value, target index)
    pairs with 0 / -1 padding, and the source and target inlier masks."""
    dev = resolve_device(device)
    source, target, y_t = _moved_target(source, target, transform, dev)
    ell = torch.as_tensor(ell, dtype=torch.float32).to(dev)
    vals, idx = kernels.association_topk(params, ell, source, y_t, top_k, chunk)
    return (vals, idx) + _inliers(vals, idx, target.capacity)


def compute_association_non_isotropic(source: PointCloud, target: PointCloud, transform,
                                      non_isotropic_kernel, params: CvoParams,
                                      top_k: int = 64, chunk: int = kernels.DEFAULT_CHUNK,
                                      device=None):
    """Association under a 3x3 non-isotropic (Mahalanobis) kernel K
    (compute_association_gpu's kernel-matrix overload and
    inner_product_non_isotropic_impl, CvoGPU.cu:1908-1995): the geometric
    factor is exp(-d^T K^-1 d / 2), with is_using_geometric_type forced
    off as in the reference (:1950-1952)."""
    dev = resolve_device(device)
    params = params.replace(is_using_geometric_type=0)
    source, target, y_t = _moved_target(source, target, transform, dev)
    kernel_inv = torch.linalg.inv(
        torch.as_tensor(non_isotropic_kernel, dtype=torch.float32).to(dev))
    vals, idx = kernels.association_topk_dense(params, kernel_inv, source, y_t, top_k, chunk)
    return (vals, idx) + _inliers(vals, idx, target.capacity)
