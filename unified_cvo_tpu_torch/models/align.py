"""Pairwise RKHS registration by se(3) gradient flow, ELL backend
(port of the ELL branch of unified_cvo_tpu/models/align.py).

One solve is two nested loops (align.py:557-633):
  outer, once per (re)build: build the Verlet candidate list at the current
    pose and ell (ops/neighbors.py; select kernel on the card);
  inner, once per iteration (align.py:396-537):
    1. flow pass -> kernel matrix A, unit twist      (flow kernel)
    2. step pass -> B, C, D, E -> cubic step size    (step kernel, poly)
    3. degenerate-flow / eps breaks (CvoGPU.cu:1452-1458)
    4. pose update R <- R dR, T <- R dT + T with (dR, dT) = exp(step twist)
    5. step-distance break ||log(dR, dT)|| < eps_2 (CvoGPU.cu:1505-1508)
    6. indicator update; past ell_decay_start, ell decays when the two
       indicator windows agree (CvoGPU.cu:1509-1517)
    and the inner loop leaves when the O(1) drift bound says a target may
    have moved more than the skin since the build.

All state stays on the device. The loop is a Python loop that reads one
small flags tensor (done, drift) back to the host per iteration, and
counts those reads in AlignInfo.host_reads.

Transform conventions follow the reference exactly: the loop state (R, T)
starts at init_guess and the RETURNED transform is its inverse
[R^T, -R^T T] (update_tf, CvoGPU.cu:94-112).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from unified_cvo_tpu_torch.config import CvoParams
from unified_cvo_tpu_torch.device import resolve_device
from unified_cvo_tpu_torch.ops import ell as ell_ops
from unified_cvo_tpu_torch.ops import indicator as indicator_ops
from unified_cvo_tpu_torch.ops import lie
from unified_cvo_tpu_torch.ops import neighbors as nbr
from unified_cvo_tpu_torch.ops.poly import step_from_poly
from unified_cvo_tpu_torch.utils.pointcloud import PointCloud

DENSE_TODO = ("the dense backends ('jnp', 'pallas') are not ported yet "
              "(ROADMAP queue 1, item 3, and queue 2, items f-g)")
ACVO_TODO = "adaptive ell (ACVO) is not ported yet (ROADMAP queue 1, item 5)"
SCAN_TODO = ("the scan neighbor-list builder is not ported yet "
             "(ROADMAP queue 1, item 4)")


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


def resolve_backend(params, source_cap: int, target_cap: int,
                    backend: str = "auto") -> str:
    """The JAX package's auto policy (align.py:94-122), restricted to what
    the port runs: 'ell' for large clouds with the geometric channel;
    everything the JAX package sends to a dense backend raises."""
    if params.is_ell_adaptive:
        raise NotImplementedError(ACVO_TODO)
    if nbr.has_channels(params):
        raise NotImplementedError(nbr.CHANNELS_TODO)
    if backend == "ell":
        return "ell"
    if backend != "auto":
        raise NotImplementedError(f"backend={backend!r}: {DENSE_TODO}")
    if params.is_using_geometry and source_cap >= 4096 and target_cap >= 4096:
        return "ell"
    raise NotImplementedError(
        f"clouds of {source_cap}/{target_cap} points (under 4096) or without "
        f"the geometric channel go to a dense backend: {DENSE_TODO}; pass "
        "backend='ell' to run the ELL path at any size")


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
    nl_builder: str = "grid",
):
    """Register target onto source. Returns (transform [4,4], ret, AlignInfo).

    `init_guess` has the convention of CvoGPU::align's init_guess_transform
    (the inverse of the source->target prior). `device=None` means the card;
    clouds and guess are moved there. ret is -1 after a degenerate flow."""
    dev = resolve_device(device)
    resolve_backend(params, source.capacity, target.capacity, backend)
    if not params.is_using_geometry:
        raise NotImplementedError(
            "the ELL path without the geometric channel needs the scan "
            f"builder: {SCAN_TODO}")
    if nl_builder != "grid":
        raise NotImplementedError(f"nl_builder={nl_builder!r}: {SCAN_TODO}")
    nl_k = nbr.DEFAULT_K if nl_k is None else nl_k
    nl_skin = nbr.DEFAULT_SKIN if nl_skin is None else nl_skin
    nl_per_cell = nbr.PER_CELL_CAP if nl_per_cell is None else nl_per_cell
    max_iter = params.MAX_ITER if max_iter is None else max_iter

    f32 = torch.float32
    source = source.to(dev)
    target = target.to(dev)
    guess = torch.as_tensor(init_guess, dtype=f32).to(dev)
    R, T = guess[:3, :3], guess[:3, 3]
    sqrt_nxny = torch.sqrt(torch.clamp(source.num_valid * target.num_valid, min=1.0))

    ell = torch.full((), params.ell_init, dtype=f32, device=dev)
    step = torch.zeros((), dtype=f32, device=dev)
    dist = torch.zeros((), dtype=f32, device=dev)
    nonzeros = torch.zeros((), dtype=torch.int32, device=dev)
    a_sum = torch.zeros((), dtype=f32, device=dev)
    ret = torch.zeros((), dtype=torch.int32, device=dev)
    nl_overflow = torch.zeros((), dtype=torch.int32, device=dev)
    ind = indicator_ops.init_state(params.indicator_window_size, dev)
    k = 0
    rebuilds = 0
    host_reads = 0
    done = False

    while not done and k < max_iter:
        # outer loop: rebuild the candidate list at the current pose and ell
        Rinv, Tinv = lie.invert_rt(R, T)
        nl = nbr.build_neighbor_list(params, ell, source, target, Rinv, Tinv,
                                     k=nl_k, skin=nl_skin,
                                     per_cell_cap=nl_per_cell)
        nl_overflow = torch.maximum(nl_overflow, nl.overflow)
        rebuilds += 1
        drift = False
        # inner loop: at least one iteration after every build (the JAX
        # loop's `fresh` flag), then until done, the cap, or drift
        while not done and k < max_iter and not drift:
            Rinv, Tinv = lie.invert_rt(R, T)
            xp = ell_ops.pack_x(params, ell, source)
            twist, joint_norm, nz, asum, A = ell_ops.flow_reduce(
                xp, nl.y_xyz, ell_ops.pack_scalars(params, Rinv, Tinv),
                params.c, params.d)
            B, C, D, E = ell_ops.step_cached(
                xp, nl.y_xyz, A, ell_ops.pack_scalars(params, Rinv, Tinv, twist))
            step_new = step_from_poly(B, C, D, E, params.min_step, params.max_step)

            degenerate = (joint_norm < 1e-8) | torch.isnan(joint_norm)
            eps_break = ((torch.linalg.vector_norm(twist[:3]) < params.eps)
                         & (torch.linalg.vector_norm(twist[3:]) < params.eps))
            break_now = degenerate | eps_break
            dR, dT = lie.se3_exp(twist, step_new)
            dist_new = lie.se3_distance(dR, dT)
            nan_break = torch.isnan(dist_new)
            ind, decrease = indicator_ops.update(
                ind, nz.to(f32) / sqrt_nxny, params.indicator_stable_threshold)
            dist_break = dist_new < params.eps_2
            finished = break_now | nan_break | dist_break
            if k > params.ell_decay_start:
                decay = decrease & ~finished
                ell = torch.where(
                    decay, torch.clamp(ell * params.ell_decay_rate,
                                       min=params.ell_min), ell)
            # the reference breaks before applying the update
            R_new = torch.where(break_now, R, R @ dR)
            T = torch.where(break_now, T, R @ dT + T)
            R = R_new
            ret = torch.where(degenerate, -1, 0).to(torch.int32)
            step, dist, nonzeros, a_sum = step_new, dist_new, nz, asum
            k += 1

            Rinv, Tinv = lie.invert_rt(R, T)
            flags = torch.stack(
                [finished, nbr.drift_bound_exceeded(nl, Rinv, Tinv, nl_skin)])
            done, drift = flags.tolist()
            host_reads += 1

    Rf, Tf = lie.invert_rt(R, T)
    info = AlignInfo(
        iterations=k,
        final_ell=ell,
        final_step=step,
        final_dist=dist,
        nonzeros=nonzeros,
        inner_product=a_sum,
        nl_overflow=nl_overflow,
        nl_rebuilds=rebuilds,
        host_reads=host_reads,
    )
    return lie.rt_to_mat44(Rf, Tf), ret, info
