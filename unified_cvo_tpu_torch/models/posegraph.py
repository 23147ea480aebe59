"""Keyframe pose-graph SLAM back-end, the PoseGraph/GTSAM layer (port of
unified_cvo_tpu/models/posegraph.py).

Reference (src/graph_optimizer/PoseGraph.cpp, legacy L6): track each new
frame against the last frame with pairwise CVO, gauge tracking quality by
the RKHS inner product, promote to keyframe when the function-angle drops
below threshold (decide_new_keyframe, PoseGraph.cpp:90-104), add a relative
-pose factor, and optimize with GTSAM iSAM2 / fixed-lag smoothing.

As in JAX: factors are SE(3) between-measurements; Gauss-Newton in the
tangent space with the residual r_e = log( Z_e^{-1} T_i^{-1} T_j ),
linearized edge by edge (6x6 blocks, O(E) memory; JAX takes the same
jacobian by forward-mode autodiff, here it is J_j = Jr^-1(r) Ad(T_j^-1),
J_i = -J_j), solved on the device in float32 as a dense 6F x 6F system or
by the matrix-free block PCG of the IRLS solver. The sliding-window marginal
(Schur complement) is formed on the host in float64, as JAX forms it.

Unlike JAX, the poses are carried in float64 between Gauss-Newton steps
(each step is linearized and solved in float32), and incremental mode
solves each subgraph in its own frame. Over a 1000-keyframe, 400 m run
(chip_smoke.py phase 12d, card against CPU on an H100), float32 poses in
the world frame end 3.6e-3 m apart; solved in the subgraph's frame,
5.0e-5 m (the rounding of each pose's rotation, levered along the
chain); with float64 poses as well, 2.0e-7 m. `--posegraph-ablation`
measures the world frame with float64 poses.

JAX pads keyframes and edges to powers of two so that XLA compiles a bounded
number of programs. Eager torch compiles nothing, and the padding only adds
held-fixed identity poses and weight-0 self-loops, which change no pose, so
it is dropped.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from unified_cvo_tpu_torch.device import resolve_device
from unified_cvo_tpu_torch.models.irls import _solve_cg_blocks
from unified_cvo_tpu_torch.ops import lie


class RelativePose(NamedTuple):
    """(curr_id, ref_id, ref_T_curr, cvo inner product), reference
    RelativePose.hpp:7-61."""

    curr_id: int
    ref_id: int
    transform: np.ndarray  # [4,4] ref_T_curr
    inner_product: float


def _edge_error(Ri, ti, Rj, tj, Rz, tz):
    """Each edge's error E = Z^-1 T_i^-1 T_j as (R [..., 3, 3], t [..., 3])."""
    Rit, Rzt = Ri.transpose(-1, -2), Rz.transpose(-1, -2)
    Re = Rzt @ (Rit @ Rj)
    te = (Rzt @ ((Rit @ (tj - ti)[..., None])[..., 0] - tz)[..., None])[..., 0]
    return Re, te


def _edge_residual(R, t, fi, fj, Rz, tz):
    """Stacked residuals r_e = log(Z_e^-1 T_i^-1 T_j) [E, 6] at the poses (R, t)."""
    return lie.se3_log(*_edge_error(R[fi], t[fi], R[fj], t[fj], Rz, tz))


def _adjoint_inv(R, t):
    """Ad(T^{-1}) [..., 6, 6] for twists ordered [omega, v]: with
    T^{-1} = (R^T, -R^T t), Ad = [[R^T, 0], [(-R^T t)^ R^T, R^T]]."""
    Rt = R.transpose(-1, -2)
    ti = -(Rt @ t[..., None])[..., 0]
    zero = torch.zeros_like(Rt)
    return torch.cat([torch.cat([Rt, zero], -1),
                      torch.cat([lie.skew(ti) @ Rt, Rt], -1)], -2)


def _log_jacobian(Re, te, h: float = 1e-5):
    """d log(E exp(eta)) / d eta at eta = 0 [..., 6, 6] (the inverse right
    Jacobian of SE(3) at log E), by central differences in float64 over
    one batched evaluation of the 12 perturbed points."""
    R, t = Re.to(torch.float64), te.to(torch.float64)
    eye = torch.eye(6, dtype=torch.float64, device=R.device)
    dR, dt = lie.se3_exp(torch.cat([eye, -eye]) * h, 1.0)           # [12, 3, 3], [12, 3]
    shape = (12,) + (1,) * (R.dim() - 2)
    Rp = R[None] @ dR.reshape(shape + (3, 3))
    tp = (R[None] @ dt.reshape(shape + (3, 1)))[..., 0] + t[None]
    r = lie.se3_log(Rp, tp)                                          # [12, ..., 6]
    return ((r[:6] - r[6:]) / (2 * h)).movedim(0, -1)                # [..., 6(r), 6(eta)]


def _edge_jacobian(Ri, ti, Rj, tj, Rz, tz):
    """d r / d delta_j [E, 6, 6] in float64 of r = log(Z^-1 T_i^-1 T_j) under
    left updates; d r / d delta_i is its negative. Exact calculus where JAX
    differentiates forward-mode: to first order exp(-d_i) exp(d_j) =
    exp(d_j - d_i), and E0 exp(e) T_j = E0 T_j exp(Ad(T_j^-1) e), so
    J_j = Jr^-1(r) Ad(T_j^-1) with Jr^-1 by float64 central differences
    (the two agree to ~1e-7, JAX's float32 rounding). Forward-mode autodiff
    in eager torch costs ~15 ms of host time a Gauss-Newton iteration at any
    size, which the incremental mode's solve a keyframe cannot afford."""
    Ri, ti, Rj, tj, Rz, tz = (a.to(torch.float64) for a in (Ri, ti, Rj, tj, Rz, tz))
    return _log_jacobian(*_edge_error(Ri, ti, Rj, tj, Rz, tz)) @ _adjoint_inv(Rj, tj)


def _edge_blocks_pg(R, t, fi, fj, Rz, tz, weights):
    """Per-edge residuals (JAX's float32 r) + 6x6 GN blocks, O(E) memory.
    Returns (res [E,6], H_aa, H_bb, H_ab [E,6,6], b_a, b_b [E,6])."""
    res = _edge_residual(R, t, fi, fj, Rz, tz)
    Jj = _edge_jacobian(R[fi], t[fi], R[fj], t[fj], Rz, tz).to(R.dtype)
    Ji = -Jj
    w = weights[:, None, None]
    H_aa = w * torch.einsum("eri,erj->eij", Ji, Ji)
    H_bb = w * torch.einsum("eri,erj->eij", Jj, Jj)
    H_ab = w * torch.einsum("eri,erj->eij", Ji, Jj)
    b_a = weights[:, None] * torch.einsum("eri,er->ei", Ji, res)
    b_b = weights[:, None] * torch.einsum("eri,er->ei", Jj, res)
    return res, H_aa, H_bb, H_ab, b_a, b_b


def _scatter_rows(F, idx, rows):
    return torch.zeros((F,) + rows.shape[1:], dtype=rows.dtype,
                       device=rows.device).index_add(0, idx, rows)


def optimize_pose_graph(
    poses,                     # [F,4,4]
    fi,                        # [E] int
    fj,                        # [E]
    Z,                         # [E,4,4] measured i_T_j
    weights,                   # [E]
    fixed_mask,                # [F] 1.0 = held constant
    iters: int = 10,
    damping: float = 1e-6,
    prior: Optional[dict] = None,
    solver: str = "dense",
    cg_iters: int = 150,
    robust_delta: Optional[float] = None,
    device=None,
):
    """Weighted GN over the pose graph. Returns (optimized poses [F,4,4]
    float64, the last step's norm) on `device` (None means the card).

    solver: 'dense' scatters the blocks into the 6F x 6F matrix and solves
    it (`torch.linalg.solve`, as JAX's jnp.linalg.solve); 'cg' runs the
    block PCG of the IRLS solver (models/irls.py::_solve_cg_blocks), O(E)
    memory for long trajectories. 'cg' does not support `prior`.

    prior: optional Gaussian marginal from sliding-window marginalization
    (the BatchFixedLagSmoother analogue, reference PoseGraph.cpp:421-551):
    {idx [K] local keyframe rows, H [6K,6K], b [6K], lin_R [K,3,3],
    lin_t [K,3]}. Energy 0.5 (xi+delta)^T H (xi+delta) + b^T (xi+delta)
    with xi_k = log(T_k T_lin,k^{-1}); contributes H to the system and
    (H xi + b) to the gradient each GN iteration.

    robust_delta: Huber reweighting (the GTSAM robust noise-model
    analogue): edges whose residual norm exceeds it are downweighted by
    delta/||r||, recomputed from the current residuals every iteration."""
    if solver == "cg" and prior is not None:
        raise ValueError("solver='cg' does not support a marginal prior; "
                         "fixed-lag windows use the dense path")
    dev = resolve_device(device)
    f32 = torch.float32

    def up(a, dtype=f32):
        return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a,
                               dtype=dtype).to(dev)

    poses = up(poses, torch.float64)
    Z, weights, fixed_mask = up(Z), up(weights), up(fixed_mask)
    fi, fj = up(fi, torch.int64), up(fj, torch.int64)
    F = poses.shape[0]
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    Rz = Z[:, :3, :3]
    tz = Z[:, :3, 3]
    free = (1.0 - fixed_mask)[:, None]
    if prior is not None:
        prior = {k: up(v, torch.int64 if k == "idx" else f32) for k, v in prior.items()}

    def blocks(R, t):
        if robust_delta is None:
            return _edge_blocks_pg(R, t, fi, fj, Rz, tz, weights)
        rn = torch.linalg.vector_norm(_edge_residual(R, t, fi, fj, Rz, tz), dim=1)
        w_r = torch.where(rn > robust_delta, robust_delta / torch.clamp(rn, min=1e-12), 1.0)
        return _edge_blocks_pg(R, t, fi, fj, Rz, tz, weights * w_r)

    def step_cg(R, t):
        _, H_aa, H_bb, H_ab, b_a, b_b = blocks(R, t)
        b = _scatter_rows(F, fi, b_a) + _scatter_rows(F, fj, b_b)
        free6f = torch.ones((F, 6), dtype=f32, device=dev) * free
        return _solve_cg_blocks(F, fi, fj, H_aa, H_bb, H_ab, b, free6f, damping, cg_iters)

    def step_dense(R, t):
        _, H_aa, H_bb, H_ab, b_a, b_b = blocks(R, t)
        # scatter the 6x6 blocks into the dense [F,F,6,6] -> [6F,6F] system
        Hb = torch.zeros((F * F, 6, 6), dtype=f32, device=dev)
        Hb = (Hb.index_add(0, fi * F + fi, H_aa).index_add(0, fj * F + fj, H_bb)
              .index_add(0, fi * F + fj, H_ab)
              .index_add(0, fj * F + fi, H_ab.transpose(1, 2)))
        H = Hb.reshape(F, F, 6, 6).permute(0, 2, 1, 3).reshape(6 * F, 6 * F)
        b = (_scatter_rows(F, fi, b_a) + _scatter_rows(F, fj, b_b)).reshape(6 * F)
        if prior is not None:
            pR = R[prior["idx"]]
            pt = t[prior["idx"]]
            Rd = torch.einsum("kil,kjl->kij", pR, prior["lin_R"])   # R lin_R^T
            td = pt - torch.einsum("kij,kj->ki", Rd, prior["lin_t"])
            xi = lie.se3_log(Rd, td).reshape(-1)                    # [6K]
            rows = (prior["idx"][:, None] * 6
                    + torch.arange(6, device=dev)[None, :]).reshape(-1)
            H = H.index_put((rows[:, None], rows[None, :]), prior["H"], accumulate=True)
            b = b.index_put((rows,), prior["H"] @ xi + prior["b"], accumulate=True)
        free6 = torch.repeat_interleave(free[:, 0], 6)
        H = H * free6[:, None] * free6[None, :]
        H = H + torch.diag(torch.where(free6 > 0, damping, 1.0))
        b = b * free6
        return torch.linalg.solve(H, -b).reshape(F, 6) * free

    step = step_cg if solver == "cg" else step_dense
    dn = torch.zeros((), dtype=f32, device=dev)
    for _ in range(iters):
        # linearize and solve in float32, as JAX does; carry the poses in
        # float64, so that rounding a pose does not walk down a long chain
        delta = step(R.to(f32), t.to(f32))
        dR, dt = lie.se3_exp(delta.to(torch.float64), 1.0)
        t = torch.einsum("fij,fj->fi", dR, t) + dt
        R = dR @ R
        dn = torch.linalg.vector_norm(delta)
    out = torch.eye(4, dtype=torch.float64, device=dev).repeat(F, 1, 1)
    out[:, :3, :3] = R
    out[:, :3, 3] = t
    return out, dn


@dataclasses.dataclass
class PoseGraphConfig:
    keyframe_function_angle_threshold: float = 0.6   # is_tracking_bad analogue
    odometry_weight: float = 1.0
    window_size: int = 0                             # 0 = full batch
    optimize_iters: int = 10
    solver: str = "auto"       # 'auto' = dense up to 64 in-window keyframes,
    #   matrix-free block-PCG beyond (full-batch long trajectories);
    #   windows with a marginal prior always solve dense (bounded size)
    robust_delta: Optional[float] = None   # Huber threshold [tangent norm]
    incremental: bool = False  # iSAM2-analogue active-subgraph updates: when
    #   on (and window_size == 0), optimize() solves only the frames touched
    #   since the last call, expanded inc_hops over the factor graph, with
    #   the subgraph boundary held fixed as anchors; frames whose pose moves
    #   more than inc_update_threshold re-activate their neighbourhood next
    #   round (the fluid-relinearization analogue)
    inc_hops: int = 2
    inc_update_threshold: float = 1e-3
    inc_max_rounds: int = 4


class PoseGraph:
    """Online keyframe SLAM driver (PoseGraph::add_new_frame semantics,
    PoseGraph.cpp:272-320): the caller supplies each frame's tracking result
    (relative transform + function angle vs the last keyframe); this class
    keeps keyframes and factors on the host and runs GN on `device` (None
    means the card) after each new keyframe."""

    def __init__(self, config: PoseGraphConfig = PoseGraphConfig(), device=None):
        self.config = config
        self.device = resolve_device(device)
        self.keyframe_poses: List[np.ndarray] = []   # world_T_kf
        self.keyframe_ids: List[int] = []
        self.factors: List[RelativePose] = []
        self.trajectory: List[np.ndarray] = []       # every frame, world_T_f
        self.window_lo = 0                           # first in-window keyframe
        # Gaussian marginal over the window-boundary keyframes:
        # {"ids": global kf indices [K], "H": [6K,6K], "b": [6K],
        #  "lin": [K,4,4] linearization poses}; None until the window slides
        self.prior: Optional[dict] = None
        self._touched: set = set()      # keyframes affected since last solve
        self._adj: dict = {}            # frame -> [factor index]
        self._adj_n = 0
        self.last_active = 0            # variables of the last incremental solve

    @property
    def num_keyframes(self):
        return len(self.keyframe_poses)

    def add_first_frame(self, frame_id: int):
        self.keyframe_poses.append(np.eye(4))
        self.keyframe_ids.append(frame_id)
        self.trajectory.append(np.eye(4))

    def add_frame(self, frame_id: int, kf_T_frame: np.ndarray, function_angle: float,
                  extra_factors: Optional[List[RelativePose]] = None) -> bool:
        """Returns True if the frame became a keyframe. kf_T_frame maps
        frame points into the last keyframe's frame."""
        world_T_frame = self.keyframe_poses[-1] @ kf_T_frame
        self.trajectory.append(world_T_frame)
        if not function_angle < self.config.keyframe_function_angle_threshold:
            return False
        self.factors.append(RelativePose(
            curr_id=len(self.keyframe_poses), ref_id=len(self.keyframe_poses) - 1,
            transform=np.asarray(kf_T_frame, np.float64),
            inner_product=float(function_angle)))
        self.keyframe_poses.append(world_T_frame)
        self.keyframe_ids.append(frame_id)
        self._touched.add(len(self.keyframe_poses) - 1)
        if extra_factors:
            self.factors.extend(extra_factors)
            for f in extra_factors:
                self._touched.update((f.ref_id, f.curr_id))
        self.optimize()
        return True

    def _linearized_system(self, factors, S, loc):
        """(H, b) in float64 of `factors` linearized at the current keyframe
        estimates over the variable set S (local index map loc), weighted as
        optimize_pose_graph weights its system: JAX's whole-graph jacobian,
        assembled from the per-edge blocks in float32 on the CPU."""
        K, E = len(S), len(factors)
        poses = torch.as_tensor(np.stack([self.keyframe_poses[s] for s in S]),
                                dtype=torch.float32)
        R, t = poses[:, :3, :3], poses[:, :3, 3]
        fi = torch.as_tensor([loc[f.ref_id] for f in factors], dtype=torch.int64)
        fj = torch.as_tensor([loc[f.curr_id] for f in factors], dtype=torch.int64)
        Z = torch.as_tensor(np.stack([f.transform for f in factors]), dtype=torch.float32)
        Rz, tz = Z[:, :3, :3], Z[:, :3, 3]
        res = _edge_residual(R, t, fi, fj, Rz, tz)
        Jj = _edge_jacobian(R[fi], t[fi], R[fj], t[fj], Rz, tz).float().numpy()
        w = self.config.odometry_weight
        Jf = np.zeros((E, 6, K, 6))
        Jf[np.arange(E), :, fi.numpy(), :] -= Jj
        Jf[np.arange(E), :, fj.numpy(), :] += Jj
        Jf = Jf.reshape(E * 6, K * 6) * w
        rf = res.numpy().astype(np.float64).reshape(E * 6)
        return Jf.T @ (Jf / w), Jf.T @ rf

    def _marginalize(self, new_lo: int):
        """Schur-complement the keyframes [window_lo, new_lo) out of the
        factors (and existing prior) that touch them, leaving a Gaussian
        marginal on the boundary keyframes: fixed-lag smoothing (GTSAM
        BatchFixedLagSmoother, reference PoseGraph.cpp:421-551), host
        float64 as in JAX."""
        marg = [f for f in self.factors if f.ref_id < new_lo or f.curr_id < new_lo]
        keep = [f for f in self.factors if f.ref_id >= new_lo and f.curr_id >= new_lo]
        ids = set(range(self.window_lo, new_lo))
        for f in marg:
            ids.update((f.ref_id, f.curr_id))
        if self.prior is not None:
            ids.update(self.prior["ids"])
        S = sorted(ids)
        loc = {s: k for k, s in enumerate(S)}
        K = len(S)
        if marg:
            H, b = self._linearized_system(marg, S, loc)
        else:
            H, b = np.zeros((6 * K, 6 * K)), np.zeros(6 * K)

        if self.prior is not None:
            # transport the old prior to the current linearization point:
            # xi = log(T_cur T_lin^{-1}) folds into the gradient
            p_rows = np.concatenate([6 * loc[s] + np.arange(6) for s in self.prior["ids"]])
            xi = []
            for k, s in enumerate(self.prior["ids"]):
                D = self.keyframe_poses[s] @ np.linalg.inv(self.prior["lin"][k])
                xi.append(lie.se3_log(torch.as_tensor(D[:3, :3], dtype=torch.float32),
                                      torch.as_tensor(D[:3, 3], dtype=torch.float32))
                          .numpy().astype(np.float64))
            xi = np.concatenate(xi)
            H[np.ix_(p_rows, p_rows)] += self.prior["H"]
            b[p_rows] += self.prior["H"] @ xi + self.prior["b"]

        # keyframe 0 is globally gauge-fixed (delta_0 = 0): conditioning on
        # it = excluding its rows/cols from both partitions
        def rows_of(ids):
            return (np.concatenate([6 * loc[s] + np.arange(6) for s in ids])
                    if ids else np.zeros(0, np.int64))

        m_rows = rows_of([s for s in S if s < new_lo and s != 0])
        b_ids = [s for s in S if s >= new_lo]
        b_rows = rows_of(b_ids)
        if len(b_rows) and len(m_rows):
            H_mm = H[np.ix_(m_rows, m_rows)] + 1e-9 * np.eye(len(m_rows))
            H_bm = H[np.ix_(b_rows, m_rows)]
            sol_H = np.linalg.solve(H_mm, H[np.ix_(m_rows, b_rows)])
            sol_b = np.linalg.solve(H_mm, b[m_rows])
            self.prior = {"ids": b_ids, "H": H[np.ix_(b_rows, b_rows)] - H_bm @ sol_H,
                          "b": b[b_rows] - H_bm @ sol_b,
                          "lin": np.stack([self.keyframe_poses[s] for s in b_ids])}
        elif len(b_rows):
            self.prior = {"ids": b_ids, "H": H[np.ix_(b_rows, b_rows)], "b": b[b_rows],
                          "lin": np.stack([self.keyframe_poses[s] for s in b_ids])}
        else:
            self.prior = None
        self.factors = keep
        self.window_lo = new_lo

    def _solve(self, S, sub, fixed_mask, prior=None, anchor=None):
        """GN over the variable set S (global kf indices, sorted) with
        factors `sub` on the device; returns the poses [len(S), 4, 4] in
        float64 on the host. `anchor` ([4, 4]) solves in its frame: the
        poses go to float32 as anchor^-1 T and come back as anchor T'. Left
        updates commute with that change of frame (A exp(d) A^-1 =
        exp(Ad(A) d), and Gauss-Newton's step does not depend on a linear
        change of its variables), so the iterates are the world frame's,
        with float32's resolution of the subgraph's extent instead of its
        distance from the origin."""
        loc = {s: k for k, s in enumerate(S)}
        solver = self.config.solver
        if solver == "auto":
            # dense for small active sets, matrix-free block PCG when a
            # long trajectory or a loop-closure cascade activates many
            solver = "cg" if prior is None and len(S) > 64 else "dense"
        poses = np.stack([self.keyframe_poses[s] for s in S])
        if anchor is not None:
            poses = np.linalg.inv(anchor) @ poses
        out, _ = optimize_pose_graph(
            poses,
            np.asarray([loc[f.ref_id] for f in sub], np.int64),
            np.asarray([loc[f.curr_id] for f in sub], np.int64),
            np.stack([f.transform for f in sub]).astype(np.float32),
            np.full(len(sub), self.config.odometry_weight, np.float32),
            np.asarray(fixed_mask, np.float32), iters=self.config.optimize_iters,
            prior=prior, solver=solver, robust_delta=self.config.robust_delta,
            device=self.device)
        out = out.cpu().numpy().astype(np.float64)
        return out if anchor is None else anchor @ out

    def _solve_subgraph(self, S, sub, fixed_mask):
        """Updates self.keyframe_poses in place; returns per-frame update
        magnitudes (dict id -> float)."""
        # the subgraph's own frame: incremental mode runs long trajectories,
        # where float32 world coordinates would round each solve at the
        # trajectory's scale and the rounding would walk down the chain
        out = self._solve(S, sub, fixed_mask, anchor=self.keyframe_poses[S[0]])
        self.last_active = len(S)
        moved = {}
        for k, s in enumerate(S):
            if fixed_mask[k]:
                continue
            moved[s] = float(np.abs(out[k][:3, :4] - self.keyframe_poses[s][:3, :4]).max())
            self.keyframe_poses[s] = out[k]
        return moved

    def _optimize_incremental(self):
        """Active-subgraph update (config.incremental): the per-call cost is
        bounded by the affected neighbourhood, not the trajectory length."""
        F = len(self.keyframe_poses)
        touched = self._touched or {F - 1}
        self._touched = set()
        # extend the cached adjacency with factors added since the last call
        for fidx in range(self._adj_n, len(self.factors)):
            f = self.factors[fidx]
            self._adj.setdefault(f.ref_id, []).append(fidx)
            self._adj.setdefault(f.curr_id, []).append(fidx)
        self._adj_n = len(self.factors)
        adj = self._adj
        cfg = self.config
        for _ in range(cfg.inc_max_rounds):
            active = set(touched)
            for _ in range(cfg.inc_hops):
                front = set()
                for s in active:
                    for fidx in adj.get(s, ()):
                        f = self.factors[fidx]
                        front.add(f.ref_id)
                        front.add(f.curr_id)
                active |= front
            sub_idx = sorted({fidx for s in active for fidx in adj.get(s, ())})
            sub, boundary = [], set()
            for fidx in sub_idx:
                f = self.factors[fidx]
                sub.append(f)
                if f.ref_id not in active:
                    boundary.add(f.ref_id)
                if f.curr_id not in active:
                    boundary.add(f.curr_id)
            if not sub:
                return
            S = sorted(active | boundary)
            fixed_mask = np.asarray([1.0 if s in boundary else 0.0 for s in S], np.float32)
            if not boundary:
                fixed_mask[S.index(0) if 0 in active else 0] = 1.0  # gauge
            moved = self._solve_subgraph(S, sub, fixed_mask)
            # only movement at the active rim (frames sharing a factor with
            # the fixed boundary) can justify pulling more of the graph in
            rim = {s for s in moved
                   if any(self.factors[fidx].ref_id in boundary
                          or self.factors[fidx].curr_id in boundary
                          for fidx in adj.get(s, ()))}
            touched = {s for s, d in moved.items() if d > cfg.inc_update_threshold} & rim
            if not touched:
                return

    def optimize(self):
        F = len(self.keyframe_poses)
        if F < 2 or not self.factors:
            return
        if self.config.incremental and not self.config.window_size:
            self._optimize_incremental()
            return
        lo = self.window_lo
        if self.config.window_size and F - lo > self.config.window_size:
            lo = F - self.config.window_size
            self._marginalize(lo)
        sub = [f for f in self.factors if f.ref_id >= lo and f.curr_id >= lo]
        if not sub:
            return
        S = list(range(lo, F))
        fixed = np.zeros(len(S), np.float32)
        if lo == 0:
            fixed[0] = 1.0   # gauge: the global origin while in window;
            # afterwards the marginal prior anchors the window
        prior_local = None
        if self.prior is not None:
            prior_local = {
                "idx": np.asarray([s - lo for s in self.prior["ids"]], np.int64),
                "H": self.prior["H"], "b": self.prior["b"],
                "lin_R": self.prior["lin"][:, :3, :3], "lin_t": self.prior["lin"][:, :3, 3]}
        out = self._solve(S, sub, fixed, prior=prior_local)
        for k, s in enumerate(S):
            self.keyframe_poses[s] = out[k]

    def write_trajectory(self, path: str):
        """KITTI-format rows of every frame pose (PoseGraph::write_trajectory)."""
        with open(path, "w") as f:
            for T in self.trajectory:
                f.write(" ".join(f"{v:.9g}" for v in T[:3, :4].reshape(-1)) + "\n")
