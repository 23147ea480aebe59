"""Ranks of the port's sharded paths (unified_cvo_tpu_torch/parallel/) for
tests/test_torch_parallel.py: `run_ranks` starts the processes (spawn, a
gloo group on a file:// store, a time limit after which every rank is
killed and the test fails), and `cases` is what each rank runs. This
module imports neither jax nor the JAX package: the ranks load only
torch and the port, and the test holds their results against JAX."""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from unified_cvo_tpu_torch import convert
from unified_cvo_tpu_torch.parallel import batch_align, ring, sharded, sharded_irls
from unified_cvo_tpu_torch.utils.pointcloud import PointCloud


def run_ranks(fn, world: int, store: str, timeout: float, *args):
    """fn(rank, world, store, *args) in `world` spawned processes; raises if
    a rank fails or the ranks are not all done within `timeout` seconds
    (then every rank is killed, so a hung collective fails the test)."""
    ctx = mp.start_processes(_entry, args=(fn, world, store) + args, nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"{world} ranks were not done after {timeout} s")


def hang(rank, world, store):
    """Rank 0 never joins the collective that rank 1 waits in."""
    if rank == 0:
        time.sleep(120)
        return
    dist.all_reduce(torch.zeros(1))


def _entry(rank, fn, world, store, *args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        fn(rank, world, store, *args)
    finally:
        dist.destroy_process_group()


def _cloud(d) -> PointCloud:
    return convert.pointcloud_from_numpy(**d, device="cpu")


def _clouds(d) -> PointCloud:
    """A stacked cloud from numpy arrays with a leading axis."""
    return PointCloud(**{k: None if v is None else torch.from_numpy(np.array(v))
                         for k, v in d.items()})


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def cases(rank, world, store, inp, out_dir):
    """Every sharded path of the port on this rank; the results go to
    out_dir/rank<r>.pt."""
    params = convert.params_from_fields(inp["params"])
    src, tgt = _cloud(inp["src"]), _cloud(inp["tgt"])
    eye4 = torch.eye(4)
    res = {}
    # ring: one iteration, then the whole loop; sp: the whole loop
    step = ring.make_ring_align_iteration(params, dist.group.WORLD, chunk=64, device="cpu")
    res["ring_step"] = step(src, tgt, torch.eye(3), torch.zeros(3), 0.5)
    full = ring.make_ring_full_align(params, dist.group.WORLD, chunk=64, max_iter=120,
                                     device="cpu")
    res["ring_full"] = full(src, tgt, eye4)
    full = sharded.make_sharded_full_align(params, dist.group.WORLD, chunk=64, max_iter=120,
                                          device="cpu")
    res["sp_full"] = full(src, tgt, eye4)
    # dp x sp: one iteration of a 4-pair batch on a 2 x 2 grid
    groups = sharded.make_groups(sp=2)
    src_b, tgt_b = _clouds(inp["src_b"]), _clouds(inp["tgt_b"])
    B = src_b.xyz.shape[0]
    bstep = sharded.make_batched_align_step(params, groups, device="cpu")
    res["dp_sp_step"] = bstep(src_b, tgt_b, torch.eye(3).repeat(B, 1, 1), torch.zeros(B, 3),
                              torch.full((B,), 0.5))
    # dp: whole alignments of a 6-pair batch, lanes split over the 4 ranks
    batch = batch_align.make_batch_align(params, group=dist.group.WORLD, chunk=128,
                                         max_iter=15, device="cpu")
    db = inp["dp_batch"]
    res["dp_batch"] = batch(_clouds(db["src"]), _clouds(db["tgt"]),
                            torch.eye(4).repeat(db["src"]["xyz"].shape[0], 1, 1))
    # the whole IRLS schedule, edges over the ranks, clouds frame-sharded
    ba = inp["irls"]
    bp = convert.params_from_fields(ba["params"])
    solver = sharded_irls.make_sharded_irls_solver(bp, dist.group.WORLD, chunk=256,
                                                   frame_sharded=True, device="cpu")
    ei, ej, valid = sharded_irls.pad_edges(ba["edge_i"], ba["edge_j"], world)
    clouds = sharded_irls.pad_frames(_clouds(ba["clouds"]), world)
    res["irls"] = solver(clouds, ba["init"], ei, ej, valid, ba["pivots"])
    res["elastic_step"] = _elastic_step(rank, inp["elastic"])
    res["elastic_solver"] = _elastic_solver(rank, inp["elastic"])
    torch.save(_np(res), os.path.join(out_dir, f"rank{rank}.pt"))


def _elastic_inputs(el, n_ranks):
    ei, ej, valid = sharded_irls.pad_edges(el["edge_i"], el["edge_j"], n_ranks)
    return _clouds(el["clouds"]), ei, ej, valid, el["pivots"]


def _elastic_step(rank, el):
    """test_elastic.py's first case: BA steps on every rank, then, after
    losing half the ranks, on a group of ranks 0 and 1 from the poses where
    the first group stopped. Returns the poses after each part."""
    params = convert.params_from_fields(el["params"])
    poses = torch.from_numpy(el["init"])
    out = []
    sub = dist.new_group([0, 1])            # every rank takes part in making it
    for group, n, ells in ((dist.group.WORLD, dist.get_world_size(), (0.6, 0.6)),
                           (sub, 2, (0.5, 0.4, 0.3, 0.2, 0.15, 0.1))):
        if rank >= n:
            out.append(None)
            continue
        step = sharded_irls.make_sharded_ba_step(params, group, chunk=256, n_gn_iters=3,
                                                 device="cpu")
        clouds, ei, ej, valid, piv = _elastic_inputs(el, n)
        for ell in ells:
            poses, _, _ = step(clouds, poses, ei, ej, valid, piv, ell)
        out.append(poses)
    return out


def _elastic_solver(rank, el):
    """test_elastic.py's second case: the whole schedule stopped after 4
    outer iterations on every rank, resumed on ranks 0 and 1 from (poses,
    ell) through the solver's ell0 hook, frame-sharded."""
    base = convert.params_from_fields(el["solver_params"])
    poses = torch.from_numpy(el["init"])
    out = []
    sub = dist.new_group([0, 1])
    ell0 = None
    for group, n, max_iters in ((dist.group.WORLD, dist.get_world_size(), 4), (sub, 2, 40)):
        if rank >= n:
            out.append(None)
            continue
        solver = sharded_irls.make_sharded_irls_solver(
            base.replace(multiframe_max_iters=max_iters), group, chunk=256, frame_sharded=True,
            device="cpu")
        clouds, ei, ej, valid, piv = _elastic_inputs(el, n)
        poses, info = solver(sharded_irls.pad_frames(clouds, n), poses, ei, ej, valid, piv,
                             ell0=ell0)
        ell0 = float(info["ell"])
        out.append((poses, info))
    return out


def stacked_numpy(pc) -> dict:
    """A stacked cloud (either package) as numpy arrays, for the ranks."""
    return {k: None if getattr(pc, k) is None else np.asarray(getattr(pc, k))
            for k in ("xyz", "mask", "features", "labels", "geometric_types")}
