"""The collectives of the sharded paths (port of the psum / all_gather /
ppermute calls of unified_cvo_tpu/parallel/), over torch.distributed
process groups.

The caller starts the processes and the group (`init_process_group` with
an address, a world size and a rank). On the gloo backend a CUDA tensor
goes through host memory: gloo's point-to-point ops read host pointers.
Sums run in the tensor's dtype (float32 for every float the paths reduce),
in the order the backend reduces, which is the same on every run of one
group; every rank ends with the same bits.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from unified_cvo_tpu_torch.ops.kernels import FlowStats


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of t that the group's backend can send."""
    if t.device.type == "cuda" and dist.get_backend(group) == "gloo":
        return t.detach().cpu().contiguous()
    return t.detach().clone().contiguous()


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of t over the group's ranks (JAX's psum), on t's device."""
    buf = _wire(t, group)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device)


def all_reduce_stats(stats: FlowStats, group) -> FlowStats:
    """Every field of a FlowStats summed over the group (the target-sharded
    path: each rank's rows cover its target shard): one float32 and one
    int32 all-reduce."""
    n = stats.row_sum.shape[0]
    f = all_reduce_sum(torch.cat([stats.row_sum, stats.row_wy.reshape(-1),
                                  stats.a_sum.reshape(1)]), group)
    nz = all_reduce_sum(stats.nonzeros.reshape(1), group)
    return FlowStats(f[:n], f[n:4 * n].reshape(n, 3), nz[0], f[4 * n])


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's t, concatenated in rank order along `dim` (JAX's tiled
    all_gather), on t's device."""
    buf = _wire(t, group)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim).to(t.device)


def shard(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of t along `dim` (JAX's in_specs
    P(axis)); the axis must divide evenly."""
    n, w = t.shape[dim], dist.get_world_size(group)
    if n % w:
        raise ValueError(f"an axis of {n} does not split evenly over {w} ranks")
    b = n // w
    return t.narrow(dim, dist.get_rank(group) * b, b)


class _Exchange:
    def __init__(self, reqs, recv, device):
        self.reqs, self.recv, self.device = reqs, recv, device

    def wait(self) -> torch.Tensor:
        for r in self.reqs:
            r.wait()
        return self.recv.to(self.device)


def ring_exchange(t: torch.Tensor, group) -> _Exchange:
    """Post the send of t to the next rank of the ring and the receive from
    the previous one (JAX's ppermute with perm i -> i + 1); `.wait()`
    returns what arrived. The caller computes between the two, as JAX's
    ring orders them."""
    w, r = dist.get_world_size(group), dist.get_rank(group)
    if w == 1:
        return _Exchange([], t, t.device)
    send = _wire(t, group)
    recv = torch.empty_like(send)
    nxt = dist.get_global_rank(group, (r + 1) % w)
    prv = dist.get_global_rank(group, (r - 1) % w)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, nxt, group),
                                   dist.P2POp(dist.irecv, recv, prv, group)])
    return _Exchange(reqs, recv, t.device)
