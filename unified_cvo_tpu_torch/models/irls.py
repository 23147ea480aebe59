"""Multiframe IRLS bundle adjustment (port of unified_cvo_tpu/models/irls.py,
the CvoBatchIRLS twin).

The reference (src/cvo/IRLS.cpp:77-215) re-evaluates every edge's kernel
matrix A at the current poses in an outer loop, freezes it, and solves the
weighted point-to-point problem
  J(T) = sum_edges sum_pairs A_ij || T1 p1_i - T2 p2_j ||^2
with Ceres. As in JAX, the cost is quadratic in each edge's homogeneous
second moments
  P11 = sum A h1 h1^T,  P12 = sum A h1 h2^T,  P22 = sum A h2 h2^T
(h = [p; 1], 4x4 each), so one kernel pass per edge per outer iteration
gives 48 numbers, and every Gauss-Newton iteration builds the exact 6x6
pose blocks from T_a P T_b^T contractions. The 6F x 6F system is solved
densely, or by block-Jacobi PCG over the edge blocks for large graphs; the
pivot frames fix the gauge.

The edge pass is the dense streaming pass of ops/kernels.py ('dense') or
the ELL candidate list of ops/neighbors.py ('ell': the grid builder, so the
select kernel on the card, at skin 0 and K = nl_k). Everything else is
small torch.linalg and matmul work, as JAX computes it outside Pallas.

Two engines drive the outer schedule (IRLS.cpp:118-206: edges gated by
multiframe_min_nonzeros, a solve while the total nonzeros grow, else ell
decays, convergence below multiframe_ell_min):
  'host'   a Python loop over host numbers, with one history entry per
           solve and an optional .npz checkpoint per iteration (the keys of
           JAX's host engine, so either package resumes the other's);
  'device' the schedule in device tensors: one host read of the `done`
           flag per outer iteration, counted in the info dict as
           host_reads.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from unified_cvo_tpu_torch import convert
from unified_cvo_tpu_torch.config import CvoParams
from unified_cvo_tpu_torch.device import resolve_device
from unified_cvo_tpu_torch.ops import kernels, lie
from unified_cvo_tpu_torch.ops import neighbors as nbr
from unified_cvo_tpu_torch.ops import segment
from unified_cvo_tpu_torch.utils.pointcloud import PointCloud

IRLS_BACKENDS = ("auto", "ell", "dense")


class EdgeMoments(NamedTuple):
    P11: torch.Tensor       # [E, 4, 4]
    P12: torch.Tensor       # [E, 4, 4]
    P22: torch.Tensor       # [E, 4, 4]
    nonzeros: torch.Tensor  # [E] int32
    overflow: torch.Tensor  # [E] int32: ELL candidate drops (0 on the dense path)


def _homog(xyz):
    return torch.cat([xyz, torch.ones_like(xyz[..., :1])], dim=-1)


def _edge_moments_single(params, ell, c1: PointCloud, c2: PointCloud, T1, T2,
                         chunk: int) -> EdgeMoments:
    """Streaming kernel pass between two transformed clouds -> moments
    (irls.py:55-101). T1, T2 are [3, 4] pose blocks (CvoFrame::pose_vec
    layout). The kernel is evaluated at the transformed points, as
    BinaryStateGPU::update_inner_product does (IRLS_State_GPU.cu:43-79); the
    moments are over the original points, so Gauss-Newton can relinearise
    at any pose without touching the points again."""
    c1_t = c1.transformed(T1[:, :3], T1[:, 3])
    c2_t = c2.transformed(T2[:, :3], T2[:, 3])
    chunk = min(chunk, c2.capacity)
    c2_t = kernels.pad_cloud_to_multiple(c2_t, chunk)
    c2_pad = kernels.pad_cloud_to_multiple(c2, chunk)
    dev = c1.xyz.device
    h1 = _homog(c1.xyz)
    row_sum = torch.zeros((c1.capacity,), dtype=torch.float32, device=dev)
    a_h2 = torch.zeros((c1.capacity, 4), dtype=torch.float32, device=dev)
    col_sums = []
    cnt = torch.zeros((), dtype=torch.int64, device=dev)
    for lo in range(0, c2_t.capacity, chunk):
        a = kernels.kernel_block(params, ell, c1_t, kernels._slice_cloud(c2_t, lo, chunk))
        row_sum = row_sum + torch.sum(a, dim=1)
        a_h2 = a_h2 + kernels._mm(a, _homog(c2_pad.xyz[lo:lo + chunk]))
        col_sums.append(torch.sum(a, dim=0))
        cnt = cnt + torch.sum(a > 0)
    col_sum = torch.cat(col_sums)
    h2 = _homog(c2_pad.xyz)
    P12 = kernels._mm(h1.T, a_h2)
    P11 = kernels._mm((h1 * row_sum[:, None]).T, h1)
    P22 = kernels._mm((h2 * col_sum[:, None]).T, h2)
    return EdgeMoments(P11, P12, P22, cnt.to(torch.int32),
                       torch.zeros((), dtype=torch.int32, device=dev))


def _edge_moments_single_ell(params, ell, c1: PointCloud, c2: PointCloud, T1, T2,
                             nl_k: int, nl_per_cell: int) -> EdgeMoments:
    """Edge moments from an ELL candidate list (irls.py:104-144), the same
    contract as _edge_moments_single. The list is built afresh each outer
    iteration between the transformed clouds, at skin 0 (the reference
    recomputes each edge's kernel matrix then too); the moments are over
    the original coordinates, from the list's raw slots. P22 needs no
    scatter back to target indices: sum_j colsum_j h2_j h2_j^T is the
    slotwise sum of A h2 h2^T."""
    R2, t2 = T2[:, :3], T2[:, 3]
    c1_t = c1.transformed(T1[:, :3], T1[:, 3])
    nl = nbr.build_neighbor_list(params, ell, c1_t, c2, R2, t2, k=nl_k, skin=0.0,
                                 per_cell_cap=nl_per_cell)
    stats, a, _ = nbr.flow_stats_ell(params, ell, c1_t, nl, R2, t2)
    h1 = _homog(c1.xyz)
    rs = stats.row_sum
    P11 = kernels._mm((h1 * rs[:, None]).T, h1)
    # a_h2[:, p] = sum_k A h2_p with h2 = [raw y; 1], over the K-major slots
    ah2 = torch.stack([torch.sum(a * nl.y_xyz[c], dim=0) for c in range(3)] + [rs], dim=-1)
    P12 = kernels._mm(h1.T, ah2)
    h2 = (nl.y_xyz[0], nl.y_xyz[1], nl.y_xyz[2], None)     # None: the row of ones
    ent = {}
    for p in range(4):
        for q in range(p, 4):
            if p == 3 and q == 3:
                ent[p, q] = torch.sum(a)
            elif q == 3:
                ent[p, q] = torch.sum(a * h2[p])
            else:
                ent[p, q] = torch.sum(a * h2[p] * h2[q])
    P22 = torch.stack([torch.stack([ent[min(p, q), max(p, q)] for q in range(4)])
                       for p in range(4)])
    return EdgeMoments(P11, P12, P22, stats.nonzeros, nl.overflow)


def _trace(M):
    return M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2]


def _cross_from(M):
    """vee of the antisymmetric part: sum w (q1 x q2) from M = sum w q1 q2^T."""
    return torch.stack([M[..., 1, 2] - M[..., 2, 1], M[..., 2, 0] - M[..., 0, 2],
                        M[..., 0, 1] - M[..., 1, 0]], dim=-1)


def _block(tl, tr, bl, br):
    return torch.cat([torch.cat([tl, tr], dim=-1), torch.cat([bl, br], dim=-1)], dim=-2)


def _edge_blocks(P11, P12, P22, T1, T2):
    """Gauss-Newton blocks of edges (any leading batch shape) under left
    updates T <- exp(xi) T (irls.py:163-194). With q1 = T1 h1, q2 = T2 h2,
    r = q1 - q2, J1 = [-q1^x I] and J2 = -[-q2^x I], every weighted pair sum
    is a contraction of M_ab = T_a P_ab T_b^T, m1 = T1 P12 e4,
    m2 = T2 P12^T e4 and S = P12[3, 3]. Returns (H_aa, H_bb, H_ab, b_a,
    b_b, cost)."""
    M11 = T1 @ P11 @ T1.transpose(-1, -2)          # sum w q1 q1^T
    M12 = T1 @ P12 @ T2.transpose(-1, -2)          # sum w q1 q2^T
    M22 = T2 @ P22 @ T2.transpose(-1, -2)
    m1 = (T1 @ P12[..., :, 3:4])[..., 0]           # sum w q1
    m2 = (T2 @ P12[..., 3, :, None])[..., 0]       # sum w q2
    S = P12[..., 3, 3][..., None, None]
    I3 = torch.eye(3, dtype=P11.dtype, device=P11.device)

    def tI(M):
        return _trace(M)[..., None, None] * I3

    H_aa = _block(tI(M11) - M11, lie.skew(m1), -lie.skew(m1), S * I3)
    H_bb = _block(tI(M22) - M22, lie.skew(m2), -lie.skew(m2), S * I3)
    H_ab = _block(M12.transpose(-1, -2) - tI(M12), -lie.skew(m1), lie.skew(m2), -S * I3)
    b_a = torch.cat([-_cross_from(M12), m1 - m2], dim=-1)
    cost = _trace(M11) - 2.0 * _trace(M12) + _trace(M22)
    return H_aa, H_bb, H_ab, b_a, -b_a, cost


def _weighted_blocks(poses, edge_i, edge_j, moments: EdgeMoments, edge_active):
    """Every edge's blocks at the current poses, inactive edges zeroed."""
    H_aa, H_bb, H_ab, b_a, b_b, costs = _edge_blocks(
        moments.P11, moments.P12, moments.P22, poses[edge_i], poses[edge_j])
    w = edge_active.to(poses.dtype)
    w3 = w[:, None, None]
    return (H_aa * w3, H_bb * w3, H_ab * w3, b_a * w[:, None], b_b * w[:, None],
            torch.sum(costs * w))


def edge_incidence(F: int, edge_i, edge_j) -> segment.Incidence:
    """The frames' incidence table over the stacked edge ends
    [edge_i; edge_j]: built once a solve, it sums the per-edge rows into
    the frames in a fixed order (ops/segment.py), where index_add's atomics
    add them in no fixed order on the card."""
    return segment.incidence(torch.cat([edge_i, edge_j]), F)


def _gradient(inc: segment.Incidence, b_a, b_b):
    """Each frame's sum of its edges' a-end and b-end rows [F, ...]."""
    return segment.segment_sum(inc, b_a, b_b)


def _assemble_system(poses, edge_i, edge_j, moments: EdgeMoments, edge_active, inc):
    """The 6F x 6F Gauss-Newton system of an edge set (irls.py:197-223):
    (H [F, 6, F, 6], b [F, 6], cost). The blocks go in by the sorted
    index_put_ (deterministic), the gradient by the edges' incidence table
    `inc`."""
    F = poses.shape[0]
    H_aa, H_bb, H_ab, b_a, b_b, cost = _weighted_blocks(poses, edge_i, edge_j, moments,
                                                        edge_active)
    Hp = torch.zeros((F, F, 6, 6), dtype=poses.dtype, device=poses.device)
    Hp.index_put_((edge_i, edge_i), H_aa, accumulate=True)
    Hp.index_put_((edge_j, edge_j), H_bb, accumulate=True)
    Hp.index_put_((edge_i, edge_j), H_ab, accumulate=True)
    Hp.index_put_((edge_j, edge_i), H_ab.transpose(-1, -2), accumulate=True)
    return Hp.permute(0, 2, 1, 3), _gradient(inc, b_a, b_b), cost


def _left_update(poses, delta):
    dR, dt = lie.se3_exp(delta, 1.0)                      # [F, 3, 3], [F, 3]
    R_new = dR @ poses[:, :, :3]
    t_new = (dR @ poses[:, :, 3:4])[..., 0] + dt
    return torch.cat([R_new, t_new[:, :, None]], dim=-1)


def _free_dims(poses, pivot_mask, dof_mask):
    """[F, 6] 1.0 on the tangent dims that may move (pivots and masked dofs
    fixed)."""
    F = poses.shape[0]
    free = 1.0 - pivot_mask.to(poses.dtype)
    dof = (torch.ones((6,), dtype=poses.dtype, device=poses.device) if dof_mask is None
           else torch.as_tensor(dof_mask, dtype=poses.dtype).to(poses.device))
    return dof.expand(F, 6) * free[:, None], free


def _solve_and_update(poses, H, b, pivot_mask, damping, dof_mask=None):
    """Gauge-fix the assembled system, solve it and left-update the poses
    (irls.py:226-248). Returns (poses_new, |delta|)."""
    F = poses.shape[0]
    free6f, free = _free_dims(poses, pivot_mask, dof_mask)
    free6 = free6f.reshape(6 * F)
    Hd = H.reshape(6 * F, 6 * F) * free6[:, None] * free6[None, :]
    # gauge fix: pivot rows and columns zero with a unit diagonal (delta = 0)
    Hd = Hd + torch.diag(torch.where(free6 > 0, torch.full_like(free6, damping),
                                     torch.ones_like(free6)))
    delta = torch.linalg.solve(Hd, -b.reshape(6 * F) * free6).reshape(F, 6)
    delta = delta * free[:, None]
    return _left_update(poses, delta), torch.linalg.vector_norm(delta)


def _solve_cg_blocks(inc: segment.Incidence, edge_i, edge_j, H_aa, H_bb, H_ab, b, free6f,
                     damping, cg_iters, tol=1e-8):
    """Matrix-free block-sparse PCG on the normal equations (irls.py:251-311),
    the stand-in for Ceres SPARSE_SCHUR at covisibility-graph scale
    (IRLS.cpp:146-159): the matvec is three batched [E, 6, 6] x [E, 6]
    contractions and a segment sum over the edge ends (`inc`, from
    edge_incidence), preconditioned by the inverted 6x6 block diagonal.
    Solves H delta = -b on the free dims. JAX's while loop stops once
    rz <= tol * rz0; here every one of the cg_iters iterations runs and the
    state stops changing at that point, so the loop needs no host read."""
    def matvec(x):
        x = x * free6f
        xa, xb = x[edge_i], x[edge_j]
        ya = (H_aa @ xa[..., None])[..., 0] + (H_ab @ xb[..., None])[..., 0]
        yb = (H_ab.transpose(-1, -2) @ xa[..., None])[..., 0] + (H_bb @ xb[..., None])[..., 0]
        return _gradient(inc, ya, yb) * free6f + damping * x

    D = _gradient(inc, H_aa, H_bb)
    D = D * free6f[:, :, None] * free6f[:, None, :]
    D = D + torch.eye(6, dtype=b.dtype, device=b.device) * max(damping, 1e-8)
    D_inv = torch.linalg.inv(D)

    def precond(r):
        return (D_inv @ r[..., None])[..., 0] * free6f

    r = -b * free6f
    x = torch.zeros_like(r)
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    thresh = tol * torch.clamp(rz, min=1e-30)
    for _ in range(cg_iters):
        go = rz > thresh
        Ap = matvec(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-30)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z_n = precond(r_n)
        rz_n = torch.sum(r_n * z_n)
        p_n = z_n + rz_n / torch.clamp(rz, min=1e-30) * p
        x, r, z, p, rz = (torch.where(go, new, old) for new, old in
                          ((x_n, x), (r_n, r), (z_n, z), (p_n, p), (rz_n, rz)))
    return x


def _assemble_and_solve(poses, edge_i, edge_j, moments: EdgeMoments, edge_active,
                        pivot_mask, damping, inc: segment.Incidence, dof_mask=None,
                        solver: str = "dense", cg_iters: int = 100):
    """One Gauss-Newton iteration (irls.py:314-357): 'dense' solves the
    assembled 6F x 6F system; 'cg' runs the block PCG over the edge blocks
    (O(E) memory). dof_mask: [6] 0/1 over (rot, trans); zeroed dims stay
    fixed (the translation-only BA variant). inc: the edges' incidence table
    (edge_incidence). Returns (poses, cost, |delta|)."""
    if solver == "dense":
        H, b, cost = _assemble_system(poses, edge_i, edge_j, moments, edge_active, inc)
        poses_new, dnorm = _solve_and_update(poses, H, b, pivot_mask, damping, dof_mask)
        return poses_new, cost, dnorm
    H_aa, H_bb, H_ab, b_a, b_b, cost = _weighted_blocks(poses, edge_i, edge_j, moments,
                                                        edge_active)
    free6f, _ = _free_dims(poses, pivot_mask, dof_mask)
    delta = _solve_cg_blocks(inc, edge_i, edge_j, H_aa, H_bb, H_ab,
                             _gradient(inc, b_a, b_b), free6f, damping, cg_iters)
    return _left_update(poses, delta), cost, torch.linalg.vector_norm(delta)


def _frame(clouds: PointCloud, f: int) -> PointCloud:
    def pick(a):
        return None if a is None else a[f]

    return PointCloud(xyz=pick(clouds.xyz), mask=pick(clouds.mask),
                      features=pick(clouds.features), labels=pick(clouds.labels),
                      geometric_types=pick(clouds.geometric_types))


def resolve_irls_backend(params, cloud_capacity: int, backend: str = "auto") -> str:
    """JAX's rule (irls.py:378-388): 'ell' only with geometry, a support of
    at most 2 m at multiframe_ell_init and clouds of 32768 points or more
    (each outer iteration uses its list once, so the build has to pay for
    itself); 'dense' else."""
    if backend not in IRLS_BACKENDS:
        raise ValueError(f"unknown IRLS backend {backend!r}; one of {IRLS_BACKENDS}")
    if backend != "auto":
        return backend
    est = nbr.static_support_radius(params.replace(ell_init=params.multiframe_ell_init))
    ell = bool(params.is_using_geometry) and est <= 2.0 and cloud_capacity >= 32768
    return "ell" if ell else "dense"


def make_irls_kernels(params: CvoParams, chunk: int = 1024, backend: str = "auto",
                      nl_k: int = 128, nl_per_cell: int = 32, cloud_capacity: int = 0,
                      solver: str = "dense", cg_iters: int = 100):
    """(moments_fn, gn_fn) for fixed settings (irls.py:360-434).
    moments_fn(clouds, poses, edge_i, edge_j, ell) -> EdgeMoments over the
    edges, one edge after another; gn_fn(poses, edge_i, edge_j, moments,
    edge_active, pivot_mask, n_iters, damping=1e-6, dof_mask=None) ->
    (poses, cost, |delta|) after n_iters Gauss-Newton iterations."""
    backend = resolve_irls_backend(params, cloud_capacity, backend)

    def moments_fn(clouds: PointCloud, poses, edge_i, edge_j, ell) -> EdgeMoments:
        out = []
        for ei, ej in zip(edge_i.tolist(), edge_j.tolist()):
            c1, c2 = _frame(clouds, ei), _frame(clouds, ej)
            if backend == "ell":
                out.append(_edge_moments_single_ell(params, ell, c1, c2, poses[ei],
                                                    poses[ej], nl_k, nl_per_cell))
            else:
                out.append(_edge_moments_single(params, ell, c1, c2, poses[ei], poses[ej],
                                                chunk))
        return EdgeMoments(*(torch.stack(v) for v in zip(*out)))

    def gn_fn(poses, edge_i, edge_j, moments, edge_active, pivot_mask, n_iters: int,
              damping=1e-6, dof_mask=None):
        cost = dnorm = torch.zeros((), dtype=poses.dtype, device=poses.device)
        inc = edge_incidence(poses.shape[0], edge_i, edge_j)
        for _ in range(n_iters):
            poses, cost, dnorm = _assemble_and_solve(
                poses, edge_i, edge_j, moments, edge_active, pivot_mask, damping, inc,
                dof_mask=dof_mask, solver=solver, cg_iters=cg_iters)
        return poses, cost, dnorm

    return moments_fn, gn_fn


def _dof_mask(translation_only: bool, dev):
    return (torch.tensor([0, 0, 0, 1, 1, 1], dtype=torch.float32, device=dev)
            if translation_only else None)


def make_irls_solver(params: CvoParams, chunk: int = 1024, backend: str = "auto",
                     cloud_capacity: int = 0, translation_only: bool = False,
                     solver: str = "dense"):
    """The whole outer schedule on the device (irls.py:437-514). JAX runs it
    as one jitted while loop with one sync per solve; here the schedule
    lives in device tensors, the solve's result is taken or dropped with
    torch.where, and the host reads one `done` flag per outer iteration.

    Returns solve(clouds, init_poses [F, 3, 4], edge_i [E], edge_j [E],
    pivot_mask [F]) -> (poses [F, 3, 4], info): info holds the device
    scalars ell, it, cost, nonzeros, overflow, and host_reads (int)."""
    moments_fn, gn_fn = make_irls_kernels(params, chunk, backend=backend,
                                          cloud_capacity=cloud_capacity, solver=solver)
    n_solve = int(params.multiframe_iterations_per_solve)
    f32, i32 = torch.float32, torch.int32

    def solve(clouds: PointCloud, init_poses, edge_i, edge_j, pivot_mask):
        poses = torch.as_tensor(init_poses, dtype=f32)
        dev = poses.device
        dof_mask = _dof_mask(translation_only, dev)
        # world recentring (see irls_solve), undone on return
        world_center = torch.mean(poses[:, :, 3], dim=0)
        poses = torch.cat([poses[:, :, :3], (poses[:, :, 3] - world_center)[..., None]], -1)
        ell = torch.full((), params.multiframe_ell_init, dtype=f32, device=dev)
        last_nz = torch.zeros((), dtype=i32, device=dev)
        it = torch.zeros((), dtype=i32, device=dev)
        cost = torch.zeros((), dtype=f32, device=dev)
        total = torch.zeros((), dtype=i32, device=dev)
        overflow = torch.zeros((), dtype=i32, device=dev)
        host_reads = 0
        while True:
            mom = moments_fn(clouds, poses, edge_i, edge_j, ell)
            nz = mom.nonzeros
            edge_active = nz > params.multiframe_min_nonzeros
            total = torch.sum(nz).to(i32)
            stop_now = (~torch.any(edge_active)) | (it >= params.multiframe_max_iters)
            do_solve = (total > last_nz) | (it < params.multiframe_iterations_per_ell)
            solving = do_solve & ~stop_now
            p_new, c_new, _ = gn_fn(poses, edge_i, edge_j, mom, edge_active, pivot_mask,
                                    n_solve, dof_mask=dof_mask)
            poses = torch.where(solving, p_new, poses)
            cost = torch.where(solving, c_new, cost)
            can_decay = ell >= params.multiframe_ell_min
            decay_now = ~stop_now & ~do_solve & can_decay
            ell = torch.where(decay_now, ell * params.multiframe_ell_decay_rate, ell)
            last_nz = torch.where(solving, total,
                                  torch.where(decay_now, torch.zeros_like(last_nz), last_nz))
            it = it + 1
            overflow = overflow + torch.sum(mom.overflow).to(i32)
            done = stop_now | (~do_solve & ~can_decay)
            host_reads += 1
            if bool(done):
                break
        poses = torch.cat([poses[:, :, :3], (poses[:, :, 3] + world_center)[..., None]], -1)
        return poses, {"ell": ell, "it": it, "cost": cost, "nonzeros": total,
                       "overflow": overflow, "host_reads": host_reads}

    return solve


def irls_solve(
    clouds: PointCloud,
    init_poses,
    edges: Sequence[Tuple[int, int]],
    pivot_flags: Sequence[bool],
    params: CvoParams,
    chunk: int = 1024,
    log=lambda *a: None,
    checkpoint_path: Optional[str] = None,
    resume: bool = False,
    translation_only: bool = False,
    backend: str = "auto",
    engine: str = "auto",
    solver: str = "auto",
    device=None,
):
    """Outer IRLS loop, the CvoBatchIRLS::solve twin (irls.py:517-671).

    clouds: stacked PointCloud with a leading frame axis [F, N, ...]
    (stack_clouds). init_poses: [F, 3, 4] float32 (CvoFrame::pose_vec
    layout). Returns (poses [F, 3, 4] numpy, history list). `device=None`
    means the card.

    engine: 'device' keeps the schedule on the device (make_irls_solver,
    one host read per outer iteration); 'host' drives it from Python with
    per-iteration logging and checkpoints; 'auto' picks 'host' when
    checkpoint_path or resume asks for snapshots, else 'device'.
    solver: 'auto' picks block PCG ('cg') above 64 frames, else 'dense'.

    History: the host engine returns one dict per solved outer iteration,
    {iter, ell, nonzeros, cost, delta}; the device engine one summary dict,
    {iter, ell, nonzeros, cost, overflow, host_reads}. Candidates dropped by
    the ELL caps are reported through `log` as a WARNING on both engines.

    With checkpoint_path, the host engine writes (poses, world_center, ell,
    iter, last_nonzeros) with numpy.savez after every outer iteration, the
    keys JAX's host engine writes, and resume=True restarts from such a
    file (numpy.savez adds '.npz' to a path without it)."""
    if resume and checkpoint_path is None:
        raise ValueError("resume=True requires checkpoint_path: there is no snapshot to "
                         "resume from otherwise")
    if solver == "auto":
        solver = "cg" if len(init_poses) > 64 else "dense"
    if engine == "auto":
        engine = "host" if (checkpoint_path is not None or resume) else "device"
    if engine == "device" and (checkpoint_path is not None or resume):
        raise ValueError("engine='device' cannot write per-iteration checkpoints; use "
                         "engine='host' (or 'auto') with checkpoint_path / resume")
    dev = resolve_device(device)
    clouds = clouds.to(dev)
    cap = int(clouds.xyz.shape[1])
    edge_i = torch.tensor([e[0] for e in edges], dtype=torch.int64, device=dev)
    edge_j = torch.tensor([e[1] for e in edges], dtype=torch.int64, device=dev)
    pivot_mask = torch.as_tensor(np.asarray(pivot_flags, np.float32)).to(dev)
    init = torch.as_tensor(np.asarray(init_poses, np.float32)).to(dev)
    if engine == "device":
        solve = make_irls_solver(params, chunk, backend=backend, cloud_capacity=cap,
                                 translation_only=translation_only, solver=solver)
        poses, info = solve(clouds, init, edge_i, edge_j, pivot_mask)
        hist = {k: (v if isinstance(v, int) else
                    float(v) if v.dtype.is_floating_point else int(v))
                for k, v in info.items()}
        hist["iter"] = hist.pop("it")
        if hist["overflow"] > 0:
            log(f"WARNING: ELL neighbor caps dropped {hist['overflow']} candidate pairs "
                f"over the solve; raise nl_k / nl_per_cell or use backend='dense'")
        log(f"device solve: {hist}")
        return poses.cpu().numpy(), [hist]

    moments_fn, gn_fn = make_irls_kernels(params, chunk, backend=backend,
                                          cloud_capacity=cap, solver=solver)
    dof_mask = _dof_mask(translation_only, dev)
    # Recentre the world at the mean frame translation: the contractions
    # (M = T P T^T, cost = tr M11 - 2 tr M12 + tr M22) cancel |q|^2-scale
    # terms down to a residual-scale signal, which float32 keeps only while
    # world coordinates stay tens of metres (the reference runs Ceres in
    # doubles, IRLS.cpp:146-159). A pure translation, undone on return; the
    # kernel is translation invariant but for the reference's own
    # range_ell(|transformed point|).
    world_center = torch.mean(init[:, :, 3], dim=0)
    poses = torch.cat([init[:, :, :3], (init[:, :, 3] - world_center)[..., None]], -1)
    ell = params.multiframe_ell_init
    last_nonzeros = 0
    history = []
    iter_ = 0
    if resume and os.path.exists(checkpoint_path):
        snap = convert.irls_checkpoint_from_npz(checkpoint_path)
        poses = torch.as_tensor(snap["poses"].astype(np.float32)).to(dev)
        if snap["world_center"] is not None:
            world_center = torch.as_tensor(snap["world_center"].astype(np.float32)).to(dev)
        ell = float(snap["ell"])
        iter_ = int(snap["iter"])
        last_nonzeros = int(snap["last_nonzeros"])
        log(f"resumed from {checkpoint_path}: iter={iter_} ell={ell:.4f}")
    while True:
        mom = moments_fn(clouds, poses, edge_i, edge_j,
                         torch.tensor(ell, dtype=torch.float32, device=dev))
        nz = mom.nonzeros.cpu().numpy()
        overflow = int(mom.overflow.sum())
        if overflow > 0:
            log(f"WARNING: ELL neighbor caps dropped {overflow} candidate pairs; raise "
                f"nl_k / nl_per_cell or use backend='dense'")
        active = nz > params.multiframe_min_nonzeros
        total_nonzeros = int(nz.sum())
        log(f"iter {iter_}: ell={ell:.4f} nonzeros={total_nonzeros} "
            f"active_edges={int(active.sum())}/{len(edges)}")
        if int(active.sum()) == 0 or iter_ >= params.multiframe_max_iters:
            break
        if total_nonzeros > last_nonzeros or iter_ < params.multiframe_iterations_per_ell:
            last_nonzeros = total_nonzeros
            poses, cost, dnorm = gn_fn(poses, edge_i, edge_j, mom,
                                       torch.as_tensor(active).to(dev), pivot_mask,
                                       params.multiframe_iterations_per_solve,
                                       dof_mask=dof_mask)
            history.append({"iter": iter_, "ell": ell, "nonzeros": total_nonzeros,
                            "cost": float(cost), "delta": float(dnorm)})
            log(f"  solved: cost={float(cost):.6f} |delta|={float(dnorm):.2e}")
        elif ell >= params.multiframe_ell_min:
            last_nonzeros = 0
            ell = ell * params.multiframe_ell_decay_rate
            log(f"  reduce ell to {ell:.4f}")
        else:
            break
        iter_ += 1
        if checkpoint_path:
            np.savez(checkpoint_path, poses=poses.cpu().numpy(),
                     world_center=world_center.cpu().numpy(), ell=ell, iter=iter_,
                     last_nonzeros=last_nonzeros)
    poses = torch.cat([poses[:, :, :3], (poses[:, :, 3] + world_center)[..., None]], -1)
    return poses.cpu().numpy(), history


def stack_clouds(clouds: List[PointCloud]) -> PointCloud:
    """Pad a list of clouds to a common capacity and stack them on a frame
    axis."""
    cap = max(c.capacity for c in clouds)
    clouds = [kernels.pad_cloud_to_multiple(c, cap) for c in clouds]

    def cat(name):
        xs = [getattr(c, name) for c in clouds]
        return None if any(x is None for x in xs) else torch.stack(xs)

    return PointCloud(**{f.name: cat(f.name) for f in dataclasses.fields(PointCloud)})
