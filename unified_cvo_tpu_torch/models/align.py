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

`align_batch` registers B pairs at once, the counterpart of the JAX
package's `jax.vmap(align)` (parallel/batch_align.py): the schedule's state
carries a leading lane axis, the lanes iterate in lockstep, a finished lane
is frozen (its state kept as it was, as JAX's vmapped while loop keeps it),
and the host reads one [B, 2] (finished, drift) flag tensor per iteration.
On 'ell' the flow and step passes take all lanes in one launch each
(`ell.flow_reduce_lanes`, `ell.step_cached_lanes`), and a lane's list is
rebuilt on that lane's own drift, the grid builder's lists of every lane
that needs one in one select launch (`select.select_lanes`); on 'pallas'
the lanes share one packed, Morton-sorted state, their tile pairs are culled
together, and the flow and step passes take all lanes in one call each
(`dense.dense_flow_lanes`, `dense.dense_step_lanes`); on 'jnp' the plain
passes run lane after lane. Each lane makes the iterations and builds of
`align` on its pair.

`align(group=...)` and `align(ring_group=...)` run the whole loop over
torch.distributed process groups (JAX's psum_axis and ring_axis,
align.py:184-210 and 364-380): with `group` this rank holds a point shard of
the target and the flow and step sums are all-reduced every iteration; with
`ring_group` both clouds are point shards and target shards rotate around
the ring (parallel/ring.py). Both force the plain blocked kernels ('jnp')
and take the schedule's decisions from all-reduced totals, so every rank
takes the same branches.

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
from unified_cvo_tpu_torch.parallel import comm, ring
from unified_cvo_tpu_torch.utils.pointcloud import PointCloud

BACKENDS = ("auto", "ell", "pallas", "jnp")
NL_BUILDERS = ("auto", "grid", "scan")


class AlignInfo(NamedTuple):
    """What a solve did. From `align_batch`, iterations and nl_rebuilds are
    per-lane lists and the tensors carry the lane axis; host_reads counts
    the batched reads."""
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

    def __init__(self, params, R, T, sqrt_nxny, dev, adaptive=False, history_len=None,
                 lanes: Optional[int] = None):
        f32 = torch.float32
        self.params, self.R, self.T, self.sqrt_nxny = params, R, T, sqrt_nxny
        self.adaptive = adaptive
        self.history = None if history_len is None else {
            name: torch.zeros((history_len,), dtype=f32, device=dev) for name in HISTORY_KEYS}
        lead = () if lanes is None else (lanes,)
        # a lane's matrix products are the unbatched ones, so that each lane
        # follows align's trajectory bit for bit
        self.mm = torch.matmul if lanes is None else lie.lanewise_matmul
        self.ell = torch.full(lead, params.ell_init, dtype=f32, device=dev)
        self.step = torch.zeros(lead, dtype=f32, device=dev)
        self.dist = torch.zeros(lead, dtype=f32, device=dev)
        self.nonzeros = torch.zeros(lead, dtype=torch.int32, device=dev)
        self.a_sum = torch.zeros(lead, dtype=f32, device=dev)
        self.ret = torch.zeros(lead, dtype=torch.int32, device=dev)
        self.ind = indicator_ops.init_state(params.indicator_window_size, dev, lanes)

    _STATE = ("R", "T", "ell", "step", "dist", "nonzeros", "a_sum", "ret", "ind")

    def advance_lanes(self, k: int, active, twist, joint_norm, nz, asum, coeffs,
                      d2_sums=None) -> torch.Tensor:
        """`advance` for every lane, with the lanes where `active` [B] is
        false frozen: their state is kept as it was. Returns the lanes'
        `finished` flags, false on frozen lanes."""
        old = {name: getattr(self, name) for name in self._STATE}
        finished = self.advance(k, twist, joint_norm, nz, asum, coeffs, d2_sums)

        def keep(new, prev):
            a = active.reshape(active.shape + (1,) * (new.dim() - active.dim()))
            return torch.where(a, new, prev)

        for name, prev in old.items():
            new = getattr(self, name)
            setattr(self, name, type(new)(*map(keep, new, prev)) if name == "ind"
                    else keep(new, prev))
        return finished & active

    def advance(self, k: int, twist, joint_norm, nz, asum, coeffs, d2_sums=None
                ) -> torch.Tensor:
        """Apply iteration k's result; returns the on-device `finished` flag.
        Under adaptive ell, `d2_sums` holds the xy, xx and yy weighted sums
        (sum A d2, nonzeros) of this iteration. Every input may carry a
        leading lane axis (coeffs then [B, 4] or four [B] tensors), as the
        state does."""
        p = self.params
        if isinstance(coeffs, torch.Tensor):
            coeffs = coeffs.unbind(-1)
        step_new = step_from_poly(*coeffs, p.min_step, p.max_step)
        degenerate = (joint_norm < 1e-8) | torch.isnan(joint_norm)
        eps_break = ((torch.linalg.vector_norm(twist[..., :3], dim=-1) < p.eps)
                     & (torch.linalg.vector_norm(twist[..., 3:], dim=-1) < p.eps))
        break_now = degenerate | eps_break
        dR, dT = lie.se3_exp(twist, step_new, mm=self.mm)
        dist_new = lie.se3_distance(dR, dT, mm=self.mm)
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
        R_new = torch.where(break_now[..., None, None], self.R, self.mm(self.R, dR))
        self.T = torch.where(break_now[..., None], self.T, self.mm(self.R, dT) + self.T)
        self.R = R_new
        self.ret = torch.where(degenerate, -1, 0).to(torch.int32)
        self.step, self.dist, self.nonzeros, self.a_sum = step_new, dist_new, nz, asum
        return finished

    def pose_inv(self):
        return lie.invert_rt(self.R, self.T, mm=self.mm)


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
    group=None,
    ring_group=None,
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
    params.is_ell_adaptive. record_history fills AlignInfo.history.

    group / ring_group: a torch.distributed process group over which this
    call is one rank of a sharded solve (JAX's psum_axis / ring_axis). With
    `group`, `target` is this rank's point shard and the source is whole;
    with `ring_group`, both are point shards. Every rank of the group calls
    align with its shards; each returns the same result. Both run the plain
    blocked kernels ('jnp'); they exclude each other, adaptive ell and any
    other backend (ValueError, as in JAX)."""
    dev = resolve_device(device)
    adaptive = _adaptive(params, adaptive_ell)
    if group is not None or ring_group is not None:
        if group is not None and ring_group is not None:
            raise ValueError("group and ring_group are mutually exclusive")
        if adaptive:
            raise ValueError("adaptive_ell is not supported under sharded align yet")
        if backend not in ("auto", "jnp"):
            raise ValueError("sharded align runs the blocked plain kernels per shard; "
                             f"backend={backend!r} is not supported with group/ring_group")
        backend = "jnp"
    backend = resolve_backend(params, source.capacity, target.capacity, backend, dev,
                              adaptive)
    max_iter = params.MAX_ITER if max_iter is None else max_iter
    source = source.to(dev)
    target = target.to(dev)
    guess = torch.as_tensor(init_guess, dtype=torch.float32).to(dev)
    nx, ny = source.num_valid, target.num_valid
    if group is not None or ring_group is not None:
        ny = comm.all_reduce_sum(ny, group or ring_group)
        if ring_group is not None:
            nx = comm.all_reduce_sum(nx, ring_group)
    sqrt_nxny = torch.sqrt(torch.clamp(nx * ny, min=1.0))
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
                                    spatial_culling, tile_i, tile_j, chunk, group, ring_group)
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


class _DensePasses:
    """The flow and step passes of one pair on a dense backend
    (align.py:324-384, 433-439): on 'pallas' with the geometric channel both
    clouds are Morton-sorted once after padding to the tiles, the source
    tile boxes computed once, and each iteration culls tile pairs from the
    moved target's boxes at the current ell into one compaction that the
    flow and step passes share; on 'jnp' the blocked plain passes, with the
    sums all-reduced over `group` (target shards) or taken around
    `ring_group` (both clouds sharded)."""

    def __init__(self, params, source, target, backend, spatial_culling, tile_i, tile_j,
                 chunk, group=None, ring_group=None):
        self.params, self.backend, self.chunk = params, backend, chunk
        self.group, self.ring_group = group, ring_group
        self.tile_i = dense.DEFAULT_TILE_I if tile_i is None else tile_i
        self.tile_j = dense.DEFAULT_TILE_J if tile_j is None else tile_j
        self.culling = (spatial_culling and backend == "pallas"
                        and bool(params.is_using_geometry))
        if self.culling:
            source, _ = morton.sort_cloud(kernels.pad_cloud_to_multiple(source, self.tile_i))
            target, _ = morton.sort_cloud(kernels.pad_cloud_to_multiple(target, self.tile_j))
            self.x_lo, self.x_hi = morton.tile_aabbs(source.xyz, source.mask, self.tile_i)
        self.source, self.target = source, target

    def run(self, ell, Rinv, Tinv, adaptive: bool):
        """(twist, joint_norm, nonzeros, a_sum, (B, C, D, E), d2_sums) at
        this pose and ell."""
        params, source, chunk = self.params, self.source, self.chunk
        y_t = self.target.transformed(Rinv, Tinv)
        reduce = None
        if self.ring_group is not None:
            stats = ring.ring_flow_stats(params, ell, source, y_t, self.ring_group, chunk)
            reduce = lambda t: comm.all_reduce_sum(t, self.ring_group)   # noqa: E731
        elif self.backend == "jnp":
            stats = kernels.flow_stats(params, ell, source, y_t, chunk)
            if self.group is not None:
                stats = comm.all_reduce_stats(stats, self.group)
        else:
            comp = None
            if self.culling:
                y_lo, y_hi = morton.tile_aabbs(y_t.xyz, y_t.mask, self.tile_j)
                d2max = morton.tile_d2max(params, ell, source.xyz, source.mask, self.tile_i)
                comp = dense.compact_tile_mask(
                    morton.tile_cull_mask(self.x_lo, self.x_hi, d2max, y_lo, y_hi))
            stats = dense.flow_stats_tiled(params, ell, source, y_t, self.tile_i, self.tile_j,
                                           compaction=comp)
        twist, joint_norm = kernels.flow_from_stats(params, source, stats, reduce=reduce)
        if self.ring_group is not None:
            coeffs = ring.ring_step_coeffs(params, ell, source, y_t, twist, self.ring_group,
                                           chunk)
        elif self.backend == "jnp":
            coeffs = kernels.step_coeffs(params, ell, source, y_t, twist, chunk)
            if self.group is not None:
                coeffs = comm.all_reduce_sum(torch.stack(coeffs), self.group).unbind(0)
        else:
            coeffs = dense.step_coeffs_tiled(params, ell, source, y_t, twist,
                                             self.tile_i, self.tile_j, compaction=comp)
        d2_sums = None
        if adaptive:
            d2_sums = tuple(kernels.weighted_d2_sum(params, ell, a, b, chunk)
                            for a, b in ((source, y_t), (source, source), (y_t, y_t)))
        return twist, joint_norm, stats.nonzeros, stats.a_sum, coeffs, d2_sums


def _dense_loop(st: _Schedule, source, target, max_iter, backend,
                spatial_culling, tile_i, tile_j, chunk, group=None, ring_group=None):
    """One flat loop over the dense passes (_DensePasses). Returns
    (iterations, host reads)."""
    passes = _DensePasses(st.params, source, target, backend, spatial_culling, tile_i,
                          tile_j, chunk, group, ring_group)
    k = host_reads = 0
    done = False
    while not done and k < max_iter:
        Rinv, Tinv = st.pose_inv()
        twist, joint_norm, nz, asum, coeffs, d2_sums = passes.run(st.ell, Rinv, Tinv,
                                                                  st.adaptive)
        finished = st.advance(k, twist, joint_norm, nz, asum, coeffs, d2_sums)
        k += 1
        done = bool(finished)
        host_reads += 1
    return k, host_reads


def align_batch(
    sources: PointCloud,
    targets: PointCloud,
    init_guesses,
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
):
    """Register B pairs at once: the counterpart of jax.vmap(align)
    (parallel/batch_align.py). sources and targets carry a leading lane
    axis (parallel.batch_align.stack_pairs), init_guesses is [B, 4, 4].
    Returns (transforms [B, 4, 4], ret [B], AlignInfo with per-lane
    iterations and builds). The backend and builder are resolved once from
    the clouds' capacities, as for one pair; the other arguments are
    align's. Each lane makes the iterations and builds `align` makes on its
    pair; the lanes iterate in lockstep, a finished lane stays frozen, and
    the host reads one [B, 2] flag tensor an iteration."""
    dev = resolve_device(device)
    adaptive = _adaptive(params, adaptive_ell)
    n_src, n_tgt = sources.xyz.shape[1], targets.xyz.shape[1]
    backend = resolve_backend(params, n_src, n_tgt, backend, dev, adaptive)
    max_iter = params.MAX_ITER if max_iter is None else max_iter
    sources, targets = sources.to(dev), targets.to(dev)
    guess = torch.as_tensor(init_guesses, dtype=torch.float32).to(dev)
    B = guess.shape[0]
    if sources.xyz.shape[0] != B or targets.xyz.shape[0] != B:
        raise ValueError(f"{B} guesses for {sources.xyz.shape[0]} sources and "
                         f"{targets.xyz.shape[0]} targets")
    sqrt_nxny = torch.sqrt(torch.clamp(torch.sum(sources.mask, -1) * torch.sum(targets.mask, -1),
                                       min=1.0))
    st = _Schedule(params, guess[:, :3, :3], guess[:, :3, 3], sqrt_nxny, dev, adaptive,
                   lanes=B)
    if backend == "ell":
        nl_builder = resolve_nl_builder(params, n_src, n_tgt, nl_builder, adaptive)
        iters, host_reads, nl_overflow, rebuilds = _ell_loop_lanes(
            st, sources, targets, max_iter, nl_k, nl_skin, nl_per_cell, nl_builder, chunk)
    else:
        iters, host_reads = _dense_loop_lanes(st, sources, targets, max_iter, backend,
                                              spatial_culling, tile_i, tile_j, chunk)
        nl_overflow = rebuilds = nl_builder = None
    Rf, Tf = st.pose_inv()
    info = AlignInfo(iterations=iters, final_ell=st.ell, final_step=st.step,
                     final_dist=st.dist, nonzeros=st.nonzeros, inner_product=st.a_sum,
                     nl_overflow=nl_overflow, nl_rebuilds=rebuilds, host_reads=host_reads,
                     backend=backend, nl_builder=nl_builder)
    return lie.rt_to_mat44(Rf, Tf), st.ret, info


def _ell_loop_lanes(st: _Schedule, sources, targets, max_iter, nl_k, nl_skin, nl_per_cell,
                    nl_builder, chunk):
    """_ell_loop for B lanes in lockstep. An iteration first builds the list
    of every live lane that is new or drifted (the grid builder: one
    select_lanes launch for those lanes, three under adaptive ell; the scan
    builder lane after lane), into the lanes' [B, 3, K, N] slots and [B, K,
    N] channel factor, then runs one
    flow_reduce_lanes and one step_cached_lanes over all lanes, advances the
    live lanes (frozen ones keep their state), and reads the [B, 2]
    (finished, drift) flags. Under adaptive ell each lane's weighted sums
    over its three lists are taken lane after lane. Returns (iterations,
    host reads, overflow [B], builds), iterations and builds per lane."""
    params = st.params
    use_geo = bool(params.is_using_geometry)
    nl_k = nbr.DEFAULT_K if nl_k is None else nl_k
    nl_skin = nbr.DEFAULT_SKIN if nl_skin is None else nl_skin
    nl_per_cell = nbr.PER_CELL_CAP if nl_per_cell is None else nl_per_cell
    dev = sources.xyz.device
    B = sources.xyz.shape[0]
    srcs = [sources.map(lambda a: a[b]) for b in range(B)]
    tgts = [targets.map(lambda a: a[b]) for b in range(B)]
    I3 = torch.eye(3, dtype=torch.float32, device=dev)
    z3 = torch.zeros((3,), dtype=torch.float32, device=dev)
    nl_overflow = torch.zeros((B,), dtype=torch.int32, device=dev)

    def build(todo, xs, ys, Rs, Ts):
        """The lists of lanes `todo`: the grid builder's in one select_lanes
        launch, the scan builder's lane after lane."""
        ells = [st.ell[b] for b in todo]
        if nl_builder == "scan":
            return [nbr.build_neighbor_list_scan(params, e, x, y, R, T, k=nl_k, skin=nl_skin,
                                                 chunk=chunk)
                    for e, x, y, R, T in zip(ells, xs, ys, Rs, Ts)]
        return nbr.build_neighbor_list_lanes(params, ells, xs, ys, Rs, Ts, k=nl_k,
                                             skin=nl_skin, per_cell_cap=nl_per_cell)

    lists = [None] * B                       # (xy, xx, yy) lists of each lane
    y_xyz = chan = pose_build = r_max = None
    iters, rebuilds = [0] * B, [0] * B
    done, drift = [False] * B, [True] * B
    done_dev = torch.zeros((B,), dtype=torch.bool, device=dev)
    k = host_reads = 0
    while k < max_iter and not all(done):
        Rinv, Tinv = st.pose_inv()
        todo = [b for b in range(B) if not done[b] and drift[b]]
        if todo:
            Rs, Ts = [Rinv[b] for b in todo], [Tinv[b] for b in todo]
            x_l, y_l = [srcs[b] for b in todo], [tgts[b] for b in todo]
            built = [build(todo, x_l, y_l, Rs, Ts)]
            if st.adaptive:
                built.append(build(todo, x_l, x_l, [I3] * len(todo), [z3] * len(todo)))
                built.append(build(todo, [y.transformed(R, T) for y, R, T in zip(y_l, Rs, Ts)],
                                   y_l, Rs, Ts))
        for i, b in enumerate(todo):
            nl = built[0][i]
            overflow = nl.overflow
            nl_xx = nl_yy = None
            if st.adaptive:
                nl_xx, nl_yy = built[1][i], built[2][i]
                overflow = overflow + nl_xx.overflow + nl_yy.overflow
            if y_xyz is None:
                y_xyz = nl.y_xyz.new_empty((B,) + tuple(nl.y_xyz.shape))
                chan = None if nl.chan is None else nl.chan.new_empty((B,) + tuple(nl.chan.shape))
                pose_build = nl.pose_build.new_zeros((B, 12))
                r_max = nl.r_max_t.new_zeros((B,))
            y_xyz[b].copy_(nl.y_xyz)
            if chan is not None:
                chan[b].copy_(nl.chan)
            pose_build[b].copy_(nl.pose_build)
            r_max[b].copy_(nl.r_max_t)
            nl_overflow[b] = torch.maximum(nl_overflow[b], overflow)
            lists[b] = (nl, nl_xx, nl_yy)
            rebuilds[b] += 1
        active = ~done_dev
        xp = ell_ops.pack_x(params, st.ell, sources)
        scal = ell_ops.pack_scalars(params, Rinv, Tinv)
        twist, joint_norm, nz, asum, A = ell_ops.flow_reduce_lanes(
            xp, y_xyz, scal, params.c, params.d, chan=chan, use_geometry=use_geo)
        coeffs = ell_ops.step_cached_lanes(xp, y_xyz, A, scal, twist=twist)
        d2_sums = None
        if st.adaptive:
            per_lane = [_adaptive_sums(params, st.ell[b], srcs[b], tgts[b], lists[b],
                                       Rinv[b], Tinv[b], I3, z3) for b in range(B)]
            d2_sums = tuple(tuple(torch.stack([lane[i][j] for lane in per_lane])
                                  for j in range(2)) for i in range(3))
        finished = st.advance_lanes(k, active, twist, joint_norm, nz, asum, coeffs, d2_sums)
        for b in range(B):
            iters[b] += not done[b]
        k += 1
        done_dev = done_dev | finished
        if use_geo:
            Rinv, Tinv = st.pose_inv()
            if st.adaptive:
                stale = torch.stack([
                    (nbr.stale_bound_exceeded(lists[b][0], Rinv[b], Tinv[b], st.ell[b], nl_skin)
                     | nbr.stale_bound_exceeded(lists[b][1], I3, z3, st.ell[b], nl_skin)
                     | nbr.stale_bound_exceeded(lists[b][2], Rinv[b], Tinv[b], st.ell[b],
                                                nl_skin)) for b in range(B)])
            else:
                stale = _drift_bound_lanes(pose_build, r_max, Rinv, Tinv) > nl_skin
            flags = torch.stack([done_dev, stale & ~done_dev], dim=-1)
            done, drift = (list(v) for v in zip(*flags.tolist()))
        else:
            done, drift = done_dev.tolist(), [False] * B
        host_reads += 1
    return iters, host_reads, nl_overflow, rebuilds


def _adaptive_sums(params, ell, x, y, lists, Rinv, Tinv, I3, z3):
    """One lane's (sum A d2, nonzeros) over its xy, xx and yy lists."""
    nl, nl_xx, nl_yy = lists
    return (nbr.weighted_d2_sum_ell(params, ell, x, nl, Rinv, Tinv),
            nbr.weighted_d2_sum_ell(params, ell, x, nl_xx, I3, z3),
            nbr.weighted_d2_sum_ell(params, ell, y.transformed(Rinv, Tinv), nl_yy, Rinv, Tinv))


def _drift_bound_lanes(pose_build, r_max, Rinv, Tinv):
    """nbr.drift_bound_exceeded's bound for every lane: pose_build [B, 12]
    and r_max [B] of each lane's list, the lanes' pose [B, 3, 3], [B, 3]."""
    B = Rinv.shape[0]
    dR = Rinv.reshape(B, 9).to(torch.float32) - pose_build[:, :9]
    dT = Tinv.to(torch.float32) - pose_build[:, 9:]
    return (torch.sqrt(torch.sum(dR * dR, dim=-1)) * r_max
            + torch.sqrt(torch.sum(dT * dT, dim=-1)))


class _DenseLanes:
    """The flow and step passes of B pairs on 'pallas' (align.py's passes
    under jax.vmap): each lane's clouds padded to the tiles and, with the
    geometric channel, Morton-sorted once, as _DensePasses does for one
    pair, and stacked; each iteration culls every lane's tile pairs at once
    into one [B, nI, nJ] mask and one TileCompactionLanes (a frozen lane's
    count 0), packs the lanes, and runs one dense_flow_lanes and one
    dense_step_lanes call for all of them. The packing, the flow from the
    row sums and ACVO's weighted sums stay lane by lane (torch), so each
    lane's values are _DensePasses' on its pair."""

    def __init__(self, params, sources, targets, spatial_culling, tile_i, tile_j, chunk):
        self.params, self.chunk = params, chunk
        self.tile_i = dense.DEFAULT_TILE_I if tile_i is None else tile_i
        self.tile_j = dense.DEFAULT_TILE_J if tile_j is None else tile_j
        self.culling = spatial_culling and bool(params.is_using_geometry)
        B = sources.xyz.shape[0]
        self.srcs = [sources.map(lambda a: a[b]) for b in range(B)]
        self.tgts = [targets.map(lambda a: a[b]) for b in range(B)]
        if self.culling:
            self.srcs = [morton.sort_cloud(kernels.pad_cloud_to_multiple(x, self.tile_i))[0]
                         for x in self.srcs]
            self.tgts = [morton.sort_cloud(kernels.pad_cloud_to_multiple(y, self.tile_j))[0]
                         for y in self.tgts]
            self.x_xyz = torch.stack([x.xyz for x in self.srcs])
            self.x_mask = torch.stack([x.mask for x in self.srcs])
            self.y_mask = torch.stack([y.mask for y in self.tgts])
            self.x_lo, self.x_hi = morton.tile_aabbs(self.x_xyz, self.x_mask, self.tile_i)
        # the passes' rows: padded to the tiles (a no-op after the sort)
        self.packed = [kernels.pad_cloud_to_multiple(x, self.tile_i) for x in self.srcs]
        self.centers = [dense.cloud_center(x) for x in self.packed]
        self.lo = dense.layout_for(params, self.packed[0])

    def run(self, ell, Rinv, Tinv, done, live, adaptive: bool):
        """(twist [B, 6], joint_norm [B], nonzeros [B], a_sum [B], [B, 4],
        d2_sums) at each lane's pose and ell; `live` [B] bool on the device
        (a frozen lane's passes give zeros; `done`, its host copy, is not
        read)."""
        params, lo, ti, tj = self.params, self.lo, self.tile_i, self.tile_j
        B = len(self.srcs)
        y_t = [self.tgts[b].transformed(Rinv[b], Tinv[b]) for b in range(B)]
        y_p = [kernels.pad_cloud_to_multiple(y, tj) for y in y_t]
        if self.culling:
            y_lo, y_hi = morton.tile_aabbs(torch.stack([y.xyz for y in y_t]), self.y_mask, tj)
            d2max = morton.tile_d2max(params, ell, self.x_xyz, self.x_mask, ti)
            mask = morton.tile_cull_mask(self.x_lo, self.x_hi, d2max, y_lo, y_hi)
        else:
            mask = torch.ones((B, self.packed[0].capacity // ti, y_p[0].capacity // tj),
                              dtype=torch.int32, device=ell.device)
        comp = dense.compact_tile_mask_lanes(mask, live)
        xp = torch.stack([dense.pack_x(params, lo, x, ell[b], center=c)
                          for b, (x, c) in enumerate(zip(self.packed, self.centers))])
        yp = torch.stack([dense.pack_y(lo, y, center=c) for y, c in zip(y_p, self.centers)])
        s, wy, nz, a_sum = dense.dense_flow_lanes(params, lo, xp, yp, comp, ti, tj)
        flows = []
        for b, (x, c) in enumerate(zip(self.srcs, self.centers)):
            n = x.capacity
            # the pass accumulated sum_j a_ij (y_j - c): the raw-frame wy
            stats = kernels.FlowStats(row_sum=s[b][:n], row_wy=(wy[b] + s[b][:, None] * c)[:n],
                                      nonzeros=nz[b], a_sum=a_sum[b])
            flows.append(kernels.flow_from_stats(params, x, stats))
        twist = torch.stack([f[0] for f in flows])
        yp = torch.stack([dense.pack_y(lo, y, twist=twist[b], center=c)
                          for b, (y, c) in enumerate(zip(y_p, self.centers))])
        coeffs = dense.dense_step_lanes(params, lo, xp, yp, comp, ti, tj)
        d2_sums = None
        if adaptive:
            per_lane = [tuple(kernels.weighted_d2_sum(params, ell[b], u, v, self.chunk)
                              for u, v in ((x, y), (x, x), (y, y)))
                        for b, (x, y) in enumerate(zip(self.srcs, y_t))]
            d2_sums = tuple(tuple(torch.stack([lane[i][j] for lane in per_lane])
                                  for j in range(2)) for i in range(3))
        return twist, torch.stack([f[1] for f in flows]), nz, a_sum, coeffs, d2_sums


class _DenseLanewise:
    """The 'jnp' passes of B pairs: each live lane's _DensePasses one after
    another (no kernel to batch), stacked; frozen lanes give zeros."""

    def __init__(self, params, sources, targets, backend, spatial_culling, tile_i, tile_j,
                 chunk):
        self.passes = [_DensePasses(params, sources.map(lambda a: a[b]),
                                    targets.map(lambda a: a[b]), backend, spatial_culling,
                                    tile_i, tile_j, chunk) for b in range(sources.xyz.shape[0])]

    def run(self, ell, Rinv, Tinv, done, live, adaptive: bool):
        """As _DenseLanes.run; the lanes `done` [B] (host) marks are
        skipped (`live` is not read)."""
        outs = []
        for b, passes in enumerate(self.passes):
            if done[b]:
                outs.append(None)
                continue
            twist, jn, nz, asum, coeffs, d2 = passes.run(ell[b], Rinv[b], Tinv[b], adaptive)
            outs.append((twist, jn, nz, asum, torch.stack(coeffs), d2))
        some = next(o for o in outs if o is not None)

        def stacked(get):
            return torch.stack([get(o if o is not None else some) * (o is not None)
                                for o in outs])

        d2_sums = None
        if adaptive:
            d2_sums = tuple(tuple(stacked(lambda o, i=i, j=j: o[5][i][j]) for j in range(2))
                            for i in range(3))
        return tuple(stacked(lambda o, i=i: o[i]) for i in range(5)) + (d2_sums,)


def _dense_loop_lanes(st: _Schedule, sources, targets, max_iter, backend, spatial_culling,
                      tile_i, tile_j, chunk):
    """_dense_loop for B lanes in lockstep: on 'pallas' one call of each
    pass for all lanes (_DenseLanes), on 'jnp' the lanes one after another
    (_DenseLanewise); then one batched advance and one [B] flag read.
    Returns (iterations per lane, host reads)."""
    B = sources.xyz.shape[0]
    if backend == "pallas":
        passes = _DenseLanes(st.params, sources, targets, spatial_culling, tile_i, tile_j,
                             chunk)
    else:
        passes = _DenseLanewise(st.params, sources, targets, backend, spatial_culling, tile_i,
                                tile_j, chunk)
    dev = sources.xyz.device
    iters = [0] * B
    done = [False] * B
    done_dev = torch.zeros((B,), dtype=torch.bool, device=dev)
    k = host_reads = 0
    while k < max_iter and not all(done):
        Rinv, Tinv = st.pose_inv()
        active = ~done_dev
        twist, jn, nz, asum, coeffs, d2_sums = passes.run(st.ell, Rinv, Tinv, done, active,
                                                          st.adaptive)
        finished = st.advance_lanes(k, active, twist, jn, nz, asum, coeffs, d2_sums)
        for b in range(B):
            iters[b] += not done[b]
        k += 1
        done_dev = done_dev | finished
        done = done_dev.tolist()
        host_reads += 1
    return iters, host_reads


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
