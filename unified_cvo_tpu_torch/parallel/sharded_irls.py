"""Distributed multiframe BA (port of unified_cvo_tpu/parallel/sharded_irls.py):
the co-visibility graph's edges split over a process group, the
Gauss-Newton system all-reduced.

Each rank computes the kernel moments of its block of edges (the expensive
part), assembles its partial 6F x 6F system with the port's
irls._assemble_system (its edges' incidence table: the fixed-order sums of
ops/segment.py), and one all-reduce of (H, b, cost) gives every rank the
same system, which each solves identically with irls._solve_and_update
(F is small). Poses stay replicated; the traffic per Gauss-Newton
iteration is (6F)^2 + 6F + 1 floats, whatever the point count.

  * make_sharded_ba_step: one outer iteration at a fixed ell (moments,
    gate, n Gauss-Newton iterations): the building block, kept for
    re-sharding after a rank is lost;
  * make_sharded_irls_solver: the whole IRLS schedule (CvoBatchIRLS,
    IRLS.cpp:77-215), driven by all-reduced totals so every rank takes the
    same branches; one host read of `done` an outer iteration.

Clouds are replicated by default. With frame_sharded=True each rank keeps
only its block of frames at rest and one all_gather an outer iteration
rebuilds the stack for the moment pass. As in JAX the moments are the
dense ones (irls._edge_moments_single). Every rank of the group calls the
returned function with the same whole arguments.
"""

from __future__ import annotations


import numpy as np
import torch

from unified_cvo_tpu_torch.config import CvoParams
from unified_cvo_tpu_torch.device import resolve_device
from unified_cvo_tpu_torch.models import irls
from unified_cvo_tpu_torch.parallel import comm
from unified_cvo_tpu_torch.utils.pointcloud import PointCloud

def pad_edges(edge_i, edge_j, n_devices):
    """Pad the edge list to a multiple of the rank count; padding edges are
    (0, 0) and not valid."""
    E = len(edge_i)
    Ep = ((E + n_devices - 1) // n_devices) * n_devices
    pad = Ep - E
    ei = np.concatenate([np.asarray(edge_i), np.zeros(pad, np.int32)])
    ej = np.concatenate([np.asarray(edge_j), np.zeros(pad, np.int32)])
    valid = np.concatenate([np.ones(E, bool), np.zeros(pad, bool)])
    return ei.astype(np.int32), ej.astype(np.int32), valid


def pad_frames(clouds: PointCloud, n_devices: int) -> PointCloud:
    """Pad the stacked clouds' frame axis to a multiple of the rank count
    with empty (mask 0) frames, for frame-sharded placement; no edge names
    a padding frame."""
    F = clouds.xyz.shape[0]
    extra = -(-F // n_devices) * n_devices - F
    if extra == 0:
        return clouds
    return clouds.map(lambda a: torch.cat([a, a.new_zeros((extra,) + tuple(a.shape[1:]))]))


def _local_moments(params, chunk, clouds, poses, edge_i, edge_j, ell) -> irls.EdgeMoments:
    """The dense edge moments of this rank's edges."""
    out = [irls._edge_moments_single(params, ell, irls._frame(clouds, i), irls._frame(clouds, j),
                                     poses[i], poses[j], chunk)
           for i, j in zip(edge_i.tolist(), edge_j.tolist())]
    return irls.EdgeMoments(*(torch.stack(v) for v in zip(*out)))


def _placed(clouds, group, frame_sharded, dev):
    """The clouds this rank keeps at rest: all of them, or its frame block."""
    clouds = clouds.to(dev)
    return clouds.map(lambda a: comm.shard(a, group)) if frame_sharded else clouds


def _gathered(clouds, group, frame_sharded):
    """The whole stack for a moment pass (transient when frame-sharded)."""
    return clouds.map(lambda a: comm.all_gather_cat(a, group)) if frame_sharded else clouds


class _Setup:
    """A call's inputs on this rank's device: recentred poses (undone by
    `restore`), this rank's edges and their incidence table."""

    def __init__(self, group, poses, edge_i, edge_j, edge_valid, pivot_mask, dev):
        f32 = torch.float32
        poses = torch.as_tensor(poses, dtype=f32).to(dev)
        # recentre the world at the mean frame translation, so the float32
        # moment contractions keep residual-scale accuracy (irls_solve)
        self.center = torch.mean(poses[:, :, 3], dim=0)
        self.poses = torch.cat([poses[:, :, :3], (poses[:, :, 3] - self.center)[..., None]], -1)
        self.ei, self.ej, self.valid = (
            comm.shard(torch.as_tensor(np.asarray(v)).to(dev), group)
            for v in (edge_i, edge_j, edge_valid))
        self.ei, self.ej = self.ei.long(), self.ej.long()
        self.pivot = torch.as_tensor(pivot_mask, dtype=f32).to(dev)
        self.inc = irls.edge_incidence(poses.shape[0], self.ei, self.ej)

    def restore(self, poses):
        return torch.cat([poses[:, :, :3], (poses[:, :, 3] + self.center)[..., None]], -1)


def _gn(s: _Setup, group, poses, mom, edge_active, n_iters, dof_mask=None):
    """n Gauss-Newton iterations with the system all-reduced over the group.
    Returns (poses, cost of the last)."""
    F = poses.shape[0]
    cost = torch.zeros((), dtype=poses.dtype, device=poses.device)
    for _ in range(n_iters):
        H, b, cost = irls._assemble_system(poses, s.ei, s.ej, mom, edge_active, s.inc)
        # the one collective: the tiny system summed over the edge blocks
        flat = comm.all_reduce_sum(torch.cat([H.reshape(-1), b.reshape(-1), cost.reshape(1)]),
                                   group)
        n = 36 * F * F
        H, b, cost = flat[:n].reshape(H.shape), flat[n:n + 6 * F].reshape(F, 6), flat[-1]
        poses, _ = irls._solve_and_update(poses, H, b, s.pivot, 1e-6, dof_mask=dof_mask)
    return poses, cost


def make_sharded_ba_step(params: CvoParams, group, chunk: int = 512, n_gn_iters: int = 4,
                         frame_sharded: bool = False, device=None):
    """step(clouds, poses [F, 3, 4], edge_i, edge_j, edge_valid, pivot_mask,
    ell) -> (poses, cost, total nonzeros): one outer iteration at a fixed
    ell (sharded_irls.py:120-173). Edges are stateless blocks, so the same
    edge list padded by pad_edges for fewer ranks continues on them."""

    def step(clouds, poses, edge_i, edge_j, edge_valid, pivot_mask, ell):
        dev = resolve_device(device)
        s = _Setup(group, poses, edge_i, edge_j, edge_valid, pivot_mask, dev)
        whole = _gathered(_placed(clouds, group, frame_sharded, dev), group, frame_sharded)
        ell = torch.as_tensor(ell, dtype=torch.float32).to(dev)
        mom = _local_moments(params, chunk, whole, s.poses, s.ei, s.ej, ell)
        nz = torch.where(s.valid, mom.nonzeros, torch.zeros_like(mom.nonzeros))
        total = comm.all_reduce_sum(torch.sum(nz).to(torch.int32), group)
        active = s.valid & (mom.nonzeros > params.multiframe_min_nonzeros)
        poses_new, cost = _gn(s, group, s.poses, mom, active, n_gn_iters)
        return s.restore(poses_new), cost, total

    return step


def make_sharded_irls_solver(params: CvoParams, group, chunk: int = 512,
                             translation_only: bool = False, frame_sharded: bool = False,
                             device=None):
    """solve(clouds, init_poses [F, 3, 4], edge_i, edge_j, edge_valid,
    pivot_mask [F], ell0=None) -> (poses [F, 3, 4], info {ell, it, cost,
    nonzeros, host_reads}) (sharded_irls.py:176-258): models/irls.py's
    device schedule with the moment pass and the assembly split over the
    edges. ell0 overrides the starting lengthscale: the restart hook with
    which a solve stopped on one group resumes on a smaller one from
    (poses, ell)."""
    n_solve = int(params.multiframe_iterations_per_solve)
    f32, i32 = torch.float32, torch.int32

    def solve(clouds, init_poses, edge_i, edge_j, edge_valid, pivot_mask, ell0=None):
        dev = resolve_device(device)
        s = _Setup(group, init_poses, edge_i, edge_j, edge_valid, pivot_mask, dev)
        dof_mask = irls._dof_mask(translation_only, dev)
        at_rest = _placed(clouds, group, frame_sharded, dev)
        poses = s.poses
        ell = torch.full((), params.multiframe_ell_init if ell0 is None else float(ell0),
                         dtype=f32, device=dev)
        last_nz = torch.zeros((), dtype=i32, device=dev)
        it = torch.zeros((), dtype=i32, device=dev)
        cost = torch.zeros((), dtype=f32, device=dev)
        total = torch.zeros((), dtype=i32, device=dev)
        host_reads = 0
        while True:
            whole = _gathered(at_rest, group, frame_sharded)
            mom = _local_moments(params, chunk, whole, poses, s.ei, s.ej, ell)
            nz = torch.where(s.valid, mom.nonzeros, torch.zeros_like(mom.nonzeros))
            edge_active = s.valid & (nz > params.multiframe_min_nonzeros)
            sums = comm.all_reduce_sum(torch.stack([torch.sum(nz).to(i32),
                                                    torch.sum(edge_active.to(i32))]), group)
            total = sums[0]
            stop_now = (sums[1] == 0) | (it >= params.multiframe_max_iters)
            do_solve = (total > last_nz) | (it < params.multiframe_iterations_per_ell)
            solving = do_solve & ~stop_now
            p_new, c_new = _gn(s, group, poses, mom, edge_active, n_solve, dof_mask)
            poses = torch.where(solving, p_new, poses)
            cost = torch.where(solving, c_new, cost)
            can_decay = ell >= params.multiframe_ell_min
            decay_now = ~stop_now & ~do_solve & can_decay
            ell = torch.where(decay_now, ell * params.multiframe_ell_decay_rate, ell)
            last_nz = torch.where(solving, total,
                                  torch.where(decay_now, torch.zeros_like(last_nz), last_nz))
            it = it + 1
            done = stop_now | (~do_solve & ~can_decay)
            host_reads += 1
            if bool(done):
                break
        return s.restore(poses), {"ell": ell, "it": it, "cost": cost, "nonzeros": total,
                                  "host_reads": host_reads}

    return solve
