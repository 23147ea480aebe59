"""Pairwise RKHS registration by se(3) gradient flow (port of
unified_cvo_tpu/models/align.py): the ELL backend and the dense backends.

Every backend runs the same iteration (align.py:396-537):
    1. flow pass -> row statistics or moments -> unit twist
    2. step pass -> B, C, D, E -> cubic step size       (ops/poly.py)
    3. degenerate-flow / eps breaks (CvoGPU.cu:1452-1458)
    4. pose update R <- R dR, T <- R dT + T with (dR, dT) = exp(step twist)
    5. step-distance break ||log(dR, dT)|| < eps_2 (CvoGPU.cu:1505-1508)
    6. indicator update; past ell_decay_start, ell decays when the two
       indicator windows agree (CvoGPU.cu:1509-1517)
and differs in the two passes:
  'ell'     a Verlet candidate list (grid or scan builder), rebuilt when
            the O(1) drift bound says a target may have moved more than the
            skin since the build, never without geometry (align.py:557-633;
            select, flow and step kernels on the card); colour, semantic and
            geometric-type channels enter as the list's build-time factor
            `chan`;
  'pallas'  dense tiles over Morton-sorted clouds, with (source tile x
            target tile) pairs beyond the kernel support culled every
            iteration (align.py:324-364; dense flow and step kernels on the
            card, their plain versions on the CPU);
  'jnp'     the blocked plain passes of ops/kernels.py, on any device.

All state stays on the device. The loop is a Python loop that reads one
small flag tensor back to the host per iteration (done, and on the ELL path
with geometry drift), and counts those reads in AlignInfo.host_reads.

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

ACVO_TODO = "adaptive ell (ACVO) is not ported yet (ROADMAP queue 1, item 5)"
BACKENDS = ("auto", "ell", "pallas", "jnp")
NL_BUILDERS = ("auto", "grid", "scan")


class AlignInfo(NamedTuple):
    iterations: int
    final_ell: torch.Tensor
    final_step: torch.Tensor
    final_dist: torch.Tensor
    nonzeros: torch.Tensor
    inner_product: torch.Tensor
    nl_overflow: Optional[torch.Tensor] = None  # candidates dropped by the
    #   K / per-cell caps, max over builds (0 = the list was exact)
    nl_rebuilds: Optional[int] = None           # neighbor-list builds (>= 1)
    host_reads: int = 0                         # device-to-host flag reads
    backend: Optional[str] = None               # the backend that ran
    nl_builder: Optional[str] = None            # 'grid' or 'scan' on 'ell'


def has_rank_channel(params) -> bool:
    """Some channel ranks the ELL candidates: distance or a channel kernel."""
    return bool(params.is_using_geometry or nbr.has_channels(params))


def resolve_backend(params, source_cap: int, target_cap: int,
                    backend: str = "auto", device=None) -> str:
    """The JAX package's backend policy (align.py:94-122): 'ell' for large
    clouds with a ranking channel; otherwise a dense backend, 'jnp' for
    clouds under 4096 points and on the CPU, 'pallas' else. ACVO raises
    NotImplementedError naming its ROADMAP item; 'ell' without a ranking
    channel raises ValueError, as in JAX (align.py:253-256)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; the port runs {BACKENDS}")
    if params.is_ell_adaptive:
        raise NotImplementedError(ACVO_TODO)
    if backend == "auto":
        if has_rank_channel(params) and source_cap >= 4096 and target_cap >= 4096:
            return "ell"
        if (device is not None and torch.device(device).type == "cpu") \
                or max(source_cap, target_cap) < 4096:
            return "jnp"
        return "pallas"
    if backend == "ell" and not has_rank_channel(params):
        raise ValueError("backend='ell' needs at least one kernel channel to rank "
                         "candidates; use 'pallas' or 'jnp'")
    return backend


def resolve_nl_builder(params, source_cap: int, target_cap: int,
                       nl_builder: str = "auto") -> str:
    """The JAX package's builder choice (align.py:257-277): the voxel grid
    for geometric configurations whose support at ell_init is at most 2 m
    with both clouds of at least 4096 points, the brute-force scan for
    everything else. The grid needs geometry to bound its cells."""
    if nl_builder not in NL_BUILDERS:
        raise ValueError(f"unknown nl_builder {nl_builder!r}; one of {NL_BUILDERS}")
    if nl_builder == "auto":
        grid = (bool(params.is_using_geometry)
                and nbr.static_support_radius(params) <= 2.0
                and source_cap >= 4096 and target_cap >= 4096)
        return "grid" if grid else "scan"
    if nl_builder == "grid" and not params.is_using_geometry:
        raise ValueError("nl_builder='grid' needs the geometric channel to bound the "
                         "voxel cell size; use nl_builder='scan'")
    return nl_builder


class _Schedule:
    """Loop state shared by every backend, and the part of an iteration that
    follows the two passes (align.py:440-537): step size, breaks, pose
    update, indicator and ell decay, all on the device."""

    def __init__(self, params, R, T, sqrt_nxny, dev):
        f32 = torch.float32
        self.params, self.R, self.T, self.sqrt_nxny = params, R, T, sqrt_nxny
        self.ell = torch.full((), params.ell_init, dtype=f32, device=dev)
        self.step = torch.zeros((), dtype=f32, device=dev)
        self.dist = torch.zeros((), dtype=f32, device=dev)
        self.nonzeros = torch.zeros((), dtype=torch.int32, device=dev)
        self.a_sum = torch.zeros((), dtype=f32, device=dev)
        self.ret = torch.zeros((), dtype=torch.int32, device=dev)
        self.ind = indicator_ops.init_state(params.indicator_window_size, dev)

    def advance(self, k: int, twist, joint_norm, nz, asum, coeffs) -> torch.Tensor:
        """Apply iteration k's result; returns the on-device `finished` flag."""
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
        if k > p.ell_decay_start:
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
):
    """Register target onto source. Returns (transform [4,4], ret, AlignInfo).

    `init_guess` has the convention of CvoGPU::align's init_guess_transform
    (the inverse of the source->target prior). `device=None` means the card;
    clouds and guess are moved there. ret is -1 after a degenerate flow.
    nl_* tune the ELL candidate list (nl_builder 'auto' picks 'grid' or
    'scan' as JAX does); spatial_culling, tile_i and tile_j the 'pallas'
    backend (defaults 128 x 512); chunk the 'jnp' backend and the scan
    builder."""
    dev = resolve_device(device)
    backend = resolve_backend(params, source.capacity, target.capacity, backend, dev)
    max_iter = params.MAX_ITER if max_iter is None else max_iter
    source = source.to(dev)
    target = target.to(dev)
    guess = torch.as_tensor(init_guess, dtype=torch.float32).to(dev)
    sqrt_nxny = torch.sqrt(torch.clamp(source.num_valid * target.num_valid, min=1.0))
    st = _Schedule(params, guess[:3, :3], guess[:3, 3], sqrt_nxny, dev)
    if backend == "ell":
        nl_builder = resolve_nl_builder(params, source.capacity, target.capacity,
                                        nl_builder)
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
    read. Returns (iterations, host reads, overflow, builds)."""
    params = st.params
    use_geo = bool(params.is_using_geometry)
    nl_k = nbr.DEFAULT_K if nl_k is None else nl_k
    nl_skin = nbr.DEFAULT_SKIN if nl_skin is None else nl_skin
    nl_per_cell = nbr.PER_CELL_CAP if nl_per_cell is None else nl_per_cell
    nl_overflow = torch.zeros((), dtype=torch.int32, device=source.xyz.device)
    k = rebuilds = host_reads = 0
    done = False
    while not done and k < max_iter:
        Rinv, Tinv = st.pose_inv()
        if nl_builder == "scan":
            nl = nbr.build_neighbor_list_scan(params, st.ell, source, target, Rinv, Tinv,
                                              k=nl_k, skin=nl_skin, chunk=chunk)
        else:
            nl = nbr.build_neighbor_list(params, st.ell, source, target, Rinv, Tinv,
                                         k=nl_k, skin=nl_skin, per_cell_cap=nl_per_cell)
        nl_overflow = torch.maximum(nl_overflow, nl.overflow)
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
            finished = st.advance(k, twist, joint_norm, nz, asum, coeffs)
            k += 1
            if use_geo:
                Rinv, Tinv = st.pose_inv()
                flags = torch.stack(
                    [finished, nbr.drift_bound_exceeded(nl, Rinv, Tinv, nl_skin)])
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
        finished = st.advance(k, twist, joint_norm, stats.nonzeros, stats.a_sum, coeffs)
        k += 1
        done = bool(finished)
        host_reads += 1
    return k, host_reads
