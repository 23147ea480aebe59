"""Sharding of the registration workload over torch.distributed process
groups (port of unified_cvo_tpu/parallel/sharded.py):

  * dp, data parallel over frame pairs: each rank takes a contiguous block
    of the pair batch;
  * sp, point parallel: the target cloud's points are split over the ranks,
    each rank computes its shard's kernel sums against the whole source,
    and the flow and step sums are all-reduced over sp, so the N x M kernel
    is never held by one rank.

`make_groups` stands in for JAX's make_mesh: the ranks as a (dp, sp) grid,
rank r at (r // sp, r % sp), with one process group per row (sp) and per
column (dp). Like every entry point here it is called by every rank with
the same arguments. As the JAX package's sharded align forces its blocked
jnp kernels (models/align.py:198-210), these paths run the port's plain
blocked passes ('jnp') on each rank's device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from unified_cvo_tpu_torch.config import CvoParams
from unified_cvo_tpu_torch.device import resolve_device
from unified_cvo_tpu_torch.ops import kernels, lie
from unified_cvo_tpu_torch.ops.poly import step_from_poly
from unified_cvo_tpu_torch.parallel import comm
from unified_cvo_tpu_torch.parallel.ring import shard_cloud
from unified_cvo_tpu_torch.utils.pointcloud import PointCloud


class Groups(NamedTuple):
    """This rank's place in a (dp, sp) grid of ranks: its row group `sp`
    and column group `dp` (None on a rank outside the grid)."""
    dp: Optional[object]
    sp: Optional[object]
    dp_size: int
    sp_size: int


def make_groups(sp: int = 1, ranks: Optional[Sequence[int]] = None) -> Groups:
    """The (dp, sp) grid over `ranks` (default: every rank of the default
    group), len(ranks) // sp rows of sp ranks: rank ranks[i * sp + j] sits
    at (i, j). Every rank of the default group must call this, members or
    not (torch.distributed.new_group's rule)."""
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    n = len(ranks)
    if n % sp:
        raise ValueError(f"{n} ranks do not form rows of {sp}")
    me = dist.get_rank()
    dp_group = sp_group = None
    for i in range(n // sp):
        g = dist.new_group(ranks[i * sp:(i + 1) * sp])
        if me in ranks[i * sp:(i + 1) * sp]:
            sp_group = g
    for j in range(sp):
        g = dist.new_group(ranks[j::sp])
        if me in ranks[j::sp]:
            dp_group = g
    return Groups(dp_group, sp_group, n // sp, sp)


def _align_iteration_local(params, sp_group, src: PointCloud, tgt_shard: PointCloud, R, T,
                           ell):
    """One gradient-flow iteration of one pair with the target's points
    sharded over `sp_group` (None: the whole target on this rank)
    (sharded.py:47-73). Returns (R', T', metrics with step, inner_product,
    nonzeros, flow_norm)."""
    Rinv, Tinv = lie.invert_rt(R, T)
    y_t = tgt_shard.transformed(Rinv, Tinv)
    chunk = min(512, y_t.capacity)
    stats = kernels.flow_stats(params, ell, src, y_t, chunk=chunk)
    if sp_group is not None:
        stats = comm.all_reduce_stats(stats, sp_group)
    twist, joint_norm = kernels.flow_from_stats(params, src, stats)
    coeffs = kernels.step_coeffs(params, ell, src, y_t, twist, chunk=chunk)
    if sp_group is not None:
        coeffs = comm.all_reduce_sum(torch.stack(coeffs), sp_group).unbind(0)
    step = step_from_poly(*coeffs, params.min_step, params.max_step)
    dR, dT = lie.se3_exp(twist, step)
    metrics = {"step": step, "inner_product": stats.a_sum, "nonzeros": stats.nonzeros,
               "flow_norm": joint_norm}
    return R @ dR, R @ dT + T, metrics


def make_sharded_full_align(params: CvoParams, group, chunk: int = 512,
                            max_iter: Optional[int] = None, device=None):
    """The whole align loop (indicator, ell schedule, breaks) with the
    target's points sharded over `group` (sharded.py:76-124;
    align(group=...)): every flow and step sum is all-reduced each
    iteration. Returns align_fn(source, target, init_guess) -> (transform
    [4, 4], ret, info dict with iterations, final_ell, nonzeros,
    inner_product); each rank takes its block of the target's points."""
    from unified_cvo_tpu_torch.models.align import align

    def full(src, tgt, ig):
        dev = resolve_device(device)
        T, ret, info = align(src, shard_cloud(tgt, group), ig, params, device=dev,
                             chunk=chunk, max_iter=max_iter, group=group,
                             spatial_culling=False)
        return T, ret, {"iterations": info.iterations, "final_ell": info.final_ell,
                        "nonzeros": info.nonzeros, "inner_product": info.inner_product}

    return full


def make_batched_align_step(params: CvoParams, groups: Groups, device=None):
    """(src_b, tgt_b, R [B, 3, 3], T [B, 3], ell [B]) -> (R', T', metrics of
    [B]) (sharded.py:127-178): the pair batch split over dp, each pair's
    target points over sp, one gradient-flow iteration a pair with the sums
    all-reduced over sp, the results gathered over dp."""

    def step(src_b, tgt_b, R_b, T_b, ell_b):
        dev = resolve_device(device)
        R_b, T_b, ell_b = (torch.as_tensor(v, dtype=torch.float32).to(dev)
                           for v in (R_b, T_b, ell_b))
        lo = dist.get_rank(groups.dp) * (R_b.shape[0] // groups.dp_size)
        n = comm.shard(R_b, groups.dp).shape[0]
        outs = []
        for b in range(lo, lo + n):
            src = src_b.map(lambda a: a[b]).to(dev)
            tgt = shard_cloud(tgt_b.map(lambda a: a[b]), groups.sp).to(dev)
            outs.append(_align_iteration_local(params, groups.sp, src, tgt, R_b[b], T_b[b],
                                               ell_b[b]))
        R_new = comm.all_gather_cat(torch.stack([o[0] for o in outs]), groups.dp)
        T_new = comm.all_gather_cat(torch.stack([o[1] for o in outs]), groups.dp)
        metrics = {k: comm.all_gather_cat(torch.stack([o[2][k] for o in outs]), groups.dp)
                   for k in outs[0][2]}
        return R_new, T_new, metrics

    return step
