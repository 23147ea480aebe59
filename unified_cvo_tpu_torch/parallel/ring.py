"""Ring context parallelism (port of unified_cvo_tpu/parallel/ring.py): the
N x M pairwise kernel with both clouds point-sharded over a process group,
target shards rotating around the ring.

Each rank owns a block of source points (its kernel rows) and starts with
a block of target points; in P steps every target block visits every rank,
so the whole N x M product is covered while no rank holds more than N/P +
M/P points. Row statistics stay with their rows; only the scalar sums
(nonzeros, a_sum, the joint twist, B..E) are all-reduced. The rotation of
each step is posted before that step's kernel block and waited for after
it, as JAX orders them (ring.py:52-60), so the exchange can run under the
block's arithmetic.

Every entry point is called by every rank of the group with the same
arguments; each rank keeps its own shards (comm.shard) and returns the
same result.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from unified_cvo_tpu_torch.config import CvoParams
from unified_cvo_tpu_torch.device import resolve_device
from unified_cvo_tpu_torch.ops import kernels, lie
from unified_cvo_tpu_torch.ops.poly import step_from_poly
from unified_cvo_tpu_torch.parallel import comm
from unified_cvo_tpu_torch.utils.pointcloud import PointCloud

FIELDS = tuple(f.name for f in dataclasses.fields(PointCloud))


def _pack(pc: PointCloud):
    """The cloud's fields side by side, [n, C], and their widths."""
    cols = [getattr(pc, f) for f in FIELDS]
    widths = [None if c is None else (1 if c.dim() == 1 else c.shape[1]) for c in cols]
    flat = torch.cat([c.reshape(c.shape[0], -1) for c in cols if c is not None], dim=1)
    return flat, widths


def _unpack(flat, widths) -> PointCloud:
    out, lo = {}, 0
    for f, w in zip(FIELDS, widths):
        if w is None:
            out[f] = None
            continue
        col = flat[:, lo:lo + w]
        out[f] = col[:, 0] if f == "mask" else col
        lo += w
    return PointCloud(**out)


def _rotate_cloud(pc: PointCloud, group):
    """Start sending this rank's target shard to the next rank of the ring
    (and receiving the previous rank's); `.wait()` of the result gives the
    received PointCloud."""
    flat, widths = _pack(pc)
    ex = comm.ring_exchange(flat, group)

    class _Pending:
        def wait(self):
            return _unpack(ex.wait(), widths)

    return _Pending()


def shard_cloud(pc: PointCloud, group) -> PointCloud:
    """This rank's contiguous block of the cloud's points."""
    return pc.map(lambda a: comm.shard(a, group))


def ring_flow_stats(params, ell, x_shard: PointCloud, y_shard: PointCloud, group,
                    chunk: int = 512) -> kernels.FlowStats:
    """FlowStats of the whole pair from sharded clouds (ring.py:63-101): the
    row statistics of this rank's source rows over every target block, and
    nonzeros and a_sum summed over the group."""
    n = x_shard.capacity
    dev = x_shard.xyz.device
    s = torch.zeros((n,), dtype=torch.float32, device=dev)
    w = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    cnt = torch.zeros((), dtype=torch.int32, device=dev)
    asum = torch.zeros((), dtype=torch.float32, device=dev)
    y_cur = y_shard
    for _ in range(dist.get_world_size(group)):
        nxt = _rotate_cloud(y_cur, group)       # posted before this block's math
        st = kernels.flow_stats(params, ell, x_shard, y_cur, chunk)
        s, w, cnt, asum = s + st.row_sum, w + st.row_wy, cnt + st.nonzeros, asum + st.a_sum
        y_cur = nxt.wait()
    return kernels.FlowStats(s, w, comm.all_reduce_sum(cnt, group),
                             comm.all_reduce_sum(asum, group))


def ring_step_coeffs(params, ell, x_shard: PointCloud, y_shard: PointCloud, twist, group,
                     chunk: int = 512):
    """(B, C, D, E) of the whole pair from sharded clouds (ring.py:104-117)."""
    total = torch.zeros((4,), dtype=torch.float32, device=x_shard.xyz.device)
    y_cur = y_shard
    for _ in range(dist.get_world_size(group)):
        nxt = _rotate_cloud(y_cur, group)
        total = total + torch.stack(kernels.step_coeffs(params, ell, x_shard, y_cur, twist,
                                                        chunk))
        y_cur = nxt.wait()
    return tuple(comm.all_reduce_sum(total, group).unbind(0))


def make_ring_full_align(params: CvoParams, group, chunk: int = 512, max_iter=None,
                         device=None):
    """The whole align loop with both clouds point-sharded over `group`
    (ring.py:120-164; align(ring_group=...)). Returns align_fn(source,
    target, init_guess) -> (transform [4, 4], ret, info dict with
    iterations, final_ell, nonzeros, inner_product); each rank takes its
    blocks of both clouds' points."""
    from unified_cvo_tpu_torch.models.align import align

    def full(x, y, ig):
        dev = resolve_device(device)
        T, ret, info = align(shard_cloud(x, group), shard_cloud(y, group), ig, params,
                             device=dev, chunk=chunk, max_iter=max_iter,
                             ring_group=group, spatial_culling=False)
        return T, ret, {"iterations": info.iterations, "final_ell": info.final_ell,
                        "nonzeros": info.nonzeros, "inner_product": info.inner_product}

    return full


def make_ring_align_iteration(params: CvoParams, group, chunk: int = 512, device=None):
    """One gradient-flow iteration with both clouds point-sharded over
    `group` (ring.py:167-198): step(x, y, R, T, ell) -> (R', T', metrics
    with step, nonzeros, a_sum, flow_norm)."""

    def step(x, y, R, T, ell):
        dev = resolve_device(device)
        x_shard, y_shard = shard_cloud(x, group).to(dev), shard_cloud(y, group).to(dev)
        R = torch.as_tensor(R, dtype=torch.float32).to(dev)
        T = torch.as_tensor(T, dtype=torch.float32).to(dev)
        ell = torch.as_tensor(ell, dtype=torch.float32).to(dev)
        Rinv, Tinv = lie.invert_rt(R, T)
        y_t = y_shard.transformed(Rinv, Tinv)
        stats = ring_flow_stats(params, ell, x_shard, y_t, group, chunk)
        # the flow over the local rows, then the 6-vector summed over the ring
        twist, jn = kernels.flow_from_stats(params, x_shard, stats,
                                            reduce=lambda t: comm.all_reduce_sum(t, group))
        B, C, D, E = ring_step_coeffs(params, ell, x_shard, y_t, twist, group, chunk)
        step_size = step_from_poly(B, C, D, E, params.min_step, params.max_step)
        dR, dT = lie.se3_exp(twist, step_size)
        return R @ dR, R @ dT + T, {"step": step_size, "nonzeros": stats.nonzeros,
                                    "a_sum": stats.a_sum, "flow_norm": jn}

    return step
