"""Batched frame-to-frame registration (port of
unified_cvo_tpu/parallel/batch_align.py): many whole alignments at once.

JAX vmaps the whole align, so its Pallas kernels run with a batch grid
axis; here `models.align.align_batch` runs the pairs as lanes of one loop,
with the ELL flow and step passes taking every lane in one launch. With a
process group (JAX's dp mesh axis) the lanes are split in contiguous blocks
over the ranks, each rank runs its block, and the results are gathered.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.distributed as dist

from unified_cvo_tpu_torch.config import CvoParams
from unified_cvo_tpu_torch.device import resolve_device
from unified_cvo_tpu_torch.models.align import align_batch
from unified_cvo_tpu_torch.parallel import comm
from unified_cvo_tpu_torch.utils.pointcloud import PointCloud


def stack_pairs(sources: List[PointCloud], targets: List[PointCloud]):
    """Stack equal-capacity clouds into clouds with a leading lane axis
    (a field missing from any cloud is left out)."""

    def cat(clouds):
        out = {}
        for f in dataclasses.fields(PointCloud):
            xs = [getattr(c, f.name) for c in clouds]
            out[f.name] = None if any(x is None for x in xs) else torch.stack(xs)
        return PointCloud(**out)

    return cat(sources), cat(targets)


def _pad_lanes(pc: PointCloud, B: int) -> PointCloud:
    """Repeat the last lane up to B lanes."""
    return pc.map(lambda a: torch.cat([a, a[-1:].expand((B - a.shape[0],) + tuple(a.shape[1:]))]))


def make_batch_align(params: CvoParams, group=None, chunk: int = 1024,
                     max_iter: Optional[int] = None, backend: str = "auto", device=None):
    """fn(src_b, tgt_b, init_b [B, 4, 4]) -> (transforms [B, 4, 4], rets
    [B], iterations [B]). With `group`, every rank of it calls fn with the
    whole batch: the batch is padded to a multiple of the group's size
    (the last pair repeated), each rank registers its contiguous block of
    pairs on its device, and every rank returns the gathered results.
    `fn.last_info` is the AlignInfo of this rank's lanes in the last call
    (per-lane iterations and builds, host reads)."""

    def run(src_b, tgt_b, init_b):
        T, ret, info = align_batch(src_b, tgt_b, init_b, params, device=device,
                                   backend=backend, max_iter=max_iter, chunk=chunk)
        fn.last_info = info
        return T, ret, torch.tensor(info.iterations, dtype=torch.int32, device=T.device)

    if group is None:
        fn = run
        return fn

    def sharded(src_b, tgt_b, init_b):
        resolve_device(device)
        init_b = torch.as_tensor(init_b, dtype=torch.float32)
        B, w = init_b.shape[0], dist.get_world_size(group)
        Bp = -(-B // w) * w
        src_b, tgt_b = _pad_lanes(src_b, Bp), _pad_lanes(tgt_b, Bp)
        init_b = torch.cat([init_b, init_b[-1:].expand(Bp - B, 4, 4)])
        lo, n = dist.get_rank(group) * (Bp // w), Bp // w
        T, ret, iters = run(src_b.map(lambda a: a[lo:lo + n]), tgt_b.map(lambda a: a[lo:lo + n]),
                            init_b[lo:lo + n])
        return tuple(comm.all_gather_cat(v, group)[:B] for v in (T, ret, iters))

    fn = sharded
    return fn
