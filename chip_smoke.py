#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (unified_cvo_tpu_torch) runs on
the GPU: builds the CUDA kernels from csrc/, holds each against its plain
PyTorch version at the bench shapes, then drives the ported paths at full
width (16384 points per frame) and checks their pose errors and that every
kernel of each path was launched:

  ELL path         KITTI_GEOMETRIC_BENCH, backend 'ell' (select,
                   flow_reduce, step_cached), phases 2-5;
  dense path       KITTI_COLOR_BENCH with 5 colour features per point,
                   backend 'pallas' (Morton culling; dense_flow,
                   dense_step), phases 2b, 3b and 4b;
  colour ELL path  KITTI_COLOR_BENCH on the default backend: 'ell' with the
                   grid builder and the channel factor (select, the
                   geometry x channel flow_reduce, step_cached), phases 2c
                   and 3c;
  channel only     KITTI_COLOR_BENCH without geometry: one scan build and
                   the channel-only flow_reduce, phase 3d;
  ACVO path        KITTI_GEOMETRIC_BENCH with is_ell_adaptive: 'ell' with
                   the scan builder, then one pair at ell_max 0.7 on the
                   grid builder (select for the xy, xx and yy lists of each
                   build), phase 6;
  analysis         function_angle, compute_association and
                   compute_association_non_isotropic on a bench pair, held
                   against the same calls on the CPU, phase 7;
  IRLS BA          8 frames x 32768 points, 13 edges, the ELL backend
                   (select at K = 128, P = 32) on both engines, the dense
                   backend, and block PCG against the dense solve on a
                   120-frame chain, phase 8; select is also held against
                   select_plain at K = 128 and 192 with P = 32 there;
  KITTI stereo     5 rendered frames at 1241 x 376 (KITTI seq-00's camera),
                   kitti_odometry.run_frames with the device frontend
                   (census-SGM, DSO selection, backprojection) and
                   KITTI_COLOR_BENCH on the colour ELL path, phase 9;
  TUM RGB-D        5 rendered frames at 640 x 480 with uint16 depth,
                   tum_odometry.run_frames with the device frontend and
                   NL-means, phase 10. Phases 9-10 hold each frontend stage
                   on the card against the same call on the CPU, hold
                   select, flow_reduce and step_cached against their plain
                   versions on the drivers' own clouds (frames 0 and 1, at
                   the drivers' capacities, most slots masked), time the
                   stages and count their launches, and bound each pair's
                   pose error against the rendered trajectory.

Phase 2c also holds flow_rows and step_uncached (the entry points of
pallas_ell.flow_stats_ell_fused and step_coeffs_ell_fused, which no align
path calls, as in JAX) against their plain versions in every variant.

Phase 2b launches each dense kernel twice for bit-equal outputs and checks
it on three compactions (culled, one source tile emptied, every pair
active). `--dense-ablation` stops after phases 1 and 2b and also times
measurement builds of csrc/dense.cu (no first look at the geometric gate,
no queue of survivors, no overlap of staging, nothing fused); it prints no result line.

Phase 2 holds select against select_plain output for output
(torch.equal: the same slots in the same order) at the identity and the
bench guess, at point counts that fill no block evenly, on a cloud with
masked rows, on 9-cell pools, at per_cell_cap 24 and at a support where
rows bind at K, each launched twice for bit-equal outputs; it also times
the build's torch half (`grid_inputs`) and the whole build beside select.
Phases 2 and 2c launch flow_reduce (every variant), flow_rows and
step_cached twice for bit-equal outputs, hold them against their plain
versions at a point count that fills no block evenly, hold the step fed
the flow's twist on the device against its plain version and against the
host-built scalar block, count the device kernels of one call as the nodes
of a captured CUDA graph (1 for every kernel), and check that the
one-launch finish left its ticket counters at 0; every time is printed
beside the launch floor (back-to-back empty kernels).
`--select-ablation` stops after phase 1: it checks, counts and times
measurement builds of csrc/select.cu (the iterated warp argmin instead of
the rank pick, slots stored from their lanes instead of staged); it prints
no result line. `--compare-tree DIR` checks and times select and flow_rows
(and flow_reduce and step_cached beside them) of the package in DIR, e.g.
an unpacked earlier commit, and of this tree in turns, DIR, this, this,
DIR, each in a process of its own (`--kernel-times TREE`), on one card.
`--ell-ablation` stops after phase 1: it checks, counts and times
measurement builds of csrc/ell.cu (the runtime-K slot loop, two block
reductions), then runs the geometric ELL path three times with the step's
twist part built three ways (in the kernel, on the host by twist_scalars,
on the host in matrix form) to show which one moves the pose errors; it
prints no result line.

Usage: python3 chip_smoke.py [--frames 8] [--dense-ablation | --select-ablation |
                             --ell-ablation | --compare-tree DIR]
Exits non-zero, printing no result, without a CUDA device or when any
phase fails. The last line of stdout is the result object.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM published memory rate
F32_FLOPS = 67e12           # H100 SXM published f32 rate outside the tensor cores
# per-slot float operations of the consume kernels and per-candidate of the
# select kernel (transform 18, distance 8, gates/exp/accumulation the rest)
FLOW_OPS_PER_SLOT = 44
STEP_OPS_PER_SLOT = 110
SELECT_OPS_PER_CANDIDATE = 27
# per-slot operations of the A evaluation by variant: the geometric front
# half (transform 18, distance 8, exp, gates), times the channel factor,
# or the channel factor alone (transform and gates only)
A_OPS_PER_SLOT = {"geo": 32, "geo_chan": 34, "chan": 21}

N_POINTS = 16384
MAX_ITER = 1500             # bench.py's iteration cap
DENSE_PAIRS = 3             # timed pairs of the dense path (after one warm-up)
N_CLASSES = 19              # semantic classes of the all-channel kernel check
COLOUR_PAIRS = 3            # timed pairs of the colour ELL path (after one warm-up)
CHAN_ONLY_ITER = 50         # iteration cap of the channel-only pair
# point counts that fill no ELL block shape evenly: even (vector loads) and
# odd (the one-point-a-thread fallback)
N_ODD = (16100, 16099)
N_MASKED = 16000            # points of the select check's cloud with masked rows


def log(*a):
    print(*a, flush=True)


def device_ms(fn, reps=20, trials=5):
    """Median device time of one call, over `trials` runs of `reps`
    back-to-back calls. A sleep kernel holds the stream while the host
    enqueues them, so the events time device work, not launch overhead."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def launch_floor_ms():
    """Device time of one empty kernel launched back to back, as
    device_ms times the kernels: what any one launch costs."""
    return device_ms(lambda: torch.cuda._sleep(0))


def kernels_per_call(fn):
    """Device work items (kernels, copies, fills) that one call of fn
    enqueues: the nodes of a CUDA graph captured from one call after a
    warm-up call. The graph is counted and dropped, never launched, so the
    count does not depend on a trace's buffers being flushed."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        fn()
    n = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(g.raw_cuda_graph()), None, ctypes.byref(n))
    g.reset()
    if rc != 0:
        raise SystemExit(f"cuGraphGetNodes returned {rc}")
    return n.value


def bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def select_exact(sel, args, what):
    """The select kernel against select_plain on one set of inputs: idx,
    y_xyz and kept equal (torch.equal: the same slots in the same order),
    two launches bit-equal. Returns (kept, live slots, rows with kept > K);
    raises SystemExit on a disagreement."""
    got = sel.select(*args)
    again = sel.select(*args)
    want = sel.select_plain(*args)
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(got, want)]
    if not all(same):
        idx_k, idx_p = got[0], want[0]
        rows = torch.nonzero(torch.any(idx_k != idx_p, dim=0)).flatten()[:3].tolist()
        raise SystemExit(f"select differs from select_plain {what}: idx, y_xyz, kept equal "
                         f"{same}; first rows differing {rows}: kernel "
                         f"{[idx_k[:, r].tolist() for r in rows]} plain "
                         f"{[idx_p[:, r].tolist() for r in rows]}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise SystemExit(f"two launches of select on the same inputs differ {what}")
    k = args[4]
    return int(got[2].sum()), int((got[0] >= 0).sum()), int((got[2] > k).sum())


def select_cases(sel, nbr, params, ell, src, tgt, Rinv, Tinv, what, src_masked=None):
    """select held against select_plain (select_exact) at the bench shapes
    and around them: the first n points for each n of N_ODD, a source cloud
    with masked rows (`src_masked`), 9-cell pools (a single-cell y axis),
    per_cell_cap = 24 (a 648-candidate pool) and a skin of 2.5 (rows bind
    at K). Logs each case; returns the bench case's GridInputs."""
    K, P, dims = nbr.DEFAULT_K, nbr.PER_CELL_CAP, nbr.GRID_DIMS
    g = nbr.grid_inputs(params, ell, src, tgt, Rinv, Tinv)
    cases = [("", (g.tab, g.cbase, g.xr2, g.pose, K, P, dims))]
    for n in N_ODD:
        cases.append((f", N = {n}", (g.tab, g.cbase[:n].contiguous(), g.xr2[:n].contiguous(),
                                     g.pose, K, P, dims)))
    if src_masked is not None:
        m = nbr.grid_inputs(params, ell, src_masked, tgt, Rinv, Tinv)
        cases.append((f", {int((src_masked.mask == 0).sum())} masked source rows",
                      (m.tab, m.cbase, m.xr2, m.pose, K, P, dims)))
    for label, kw in ((", 9-cell pools (grid 64 x 1 x 64)", dict(grid_dims=(64, 1, 64))),
                      (", per_cell_cap 24", dict(per_cell_cap=24)),
                      (", skin 2.5", dict(skin=2.5))):
        o = nbr.grid_inputs(params, ell, src, tgt, Rinv, Tinv, **kw)
        cases.append((label, (o.tab, o.cbase, o.xr2, o.pose, K, kw.get("per_cell_cap", P),
                              kw.get("grid_dims", dims))))
    for label, args in cases:
        kept, live, binding = select_exact(sel, args, f"at {what}{label}")
        log(f"select @ {what}{label}: idx, y_xyz and kept equal to select_plain, two launches "
            f"bit-equal; N {args[1].shape[0]}, kept {kept}, live slots {live}, rows with kept "
            f"> K {binding}")
    return g


def flow_agree(fk, fp, what):
    """flow_reduce's result against its plain version: nonzeros exact,
    a_sum rel 1e-5, A abs 1e-6, twist abs 1e-4. Returns (a_sum rel, A abs,
    twist abs, joint norm rel); raises SystemExit on a disagreement."""
    nz_k, nz_p = int(fk[2]), int(fp[2])
    a_rel = abs(float(fk[3]) - float(fp[3])) / abs(float(fp[3]))
    A_err = float(torch.max(torch.abs(fk[4] - fp[4])))
    tw_err = float(torch.max(torch.abs(fk[0] - fp[0])))
    jn_rel = abs(float(fk[1]) - float(fp[1])) / abs(float(fp[1]))
    if not (nz_k == nz_p > 0 and a_rel <= 1e-5 and A_err <= 1e-6 and tw_err <= 1e-4):
        raise SystemExit(f"flow kernel disagrees {what}: nonzeros {nz_k} vs {nz_p}, "
                         f"a_sum rel {a_rel}, A abs {A_err}, twist abs {tw_err}")
    return a_rel, A_err, tw_err, jn_rel


def step_agree(bk, bp, what):
    """A step kernel's B..E against the plain version's: rel 1e-3 + 1e-4."""
    if not bool(torch.all(torch.abs(bk - bp) <= 1e-3 * torch.abs(bp) + 1e-4)):
        raise SystemExit(f"step kernel disagrees {what}: {bk.tolist()} vs {bp.tolist()}")
    return float(torch.max(torch.abs(bk - bp)))


def ell_consume_checks(ell_ops, params, xp, y_xyz, scal, Rinv, Tinv, what, chan=None,
                       use_geometry=True):
    """The one-launch consume kernels on one list: flow_reduce, step_cached
    and step_uncached each launched twice for bit-equal outputs, the
    uncached step bit-equal to the cached one on the flow kernel's A, the
    step fed the flow's twist on the device against its plain version fed
    the same twist and within rtol 1e-4 of the step on the host-built
    block, and flow and step (both forms) against their plain versions at
    the first n points for each n of N_ODD. Returns the largest flow and
    step errors."""
    ch = dict(chan=chan, use_geometry=use_geometry)
    fk = ell_ops.flow_reduce(xp, y_xyz, scal, params.c, params.d, **ch)
    fk2 = ell_ops.flow_reduce(xp, y_xyz, scal, params.c, params.d, **ch)
    scal_t = ell_ops.pack_scalars(params, Rinv, Tinv, fk[0])
    bk = ell_ops.step_cached(xp, y_xyz, fk[4], scal_t)
    bk2 = ell_ops.step_cached(xp, y_xyz, fk[4], scal_t)
    bu = ell_ops.step_uncached(xp, y_xyz, scal_t, **ch)
    bu2 = ell_ops.step_uncached(xp, y_xyz, scal_t, **ch)
    bd = ell_ops.step_cached(xp, y_xyz, fk[4], scal, twist=fk[0])
    bd2 = ell_ops.step_cached(xp, y_xyz, fk[4], scal, twist=fk[0])
    bdp = ell_ops.step_cached_plain(xp, y_xyz, fk[4], scal, twist=fk[0])
    torch.cuda.synchronize()
    if not (all(torch.equal(a, b) for a, b in zip(fk, fk2)) and torch.equal(bk, bk2)
            and torch.equal(bu, bu2) and torch.equal(bd, bd2)):
        raise SystemExit(f"two launches on the same inputs differ {what}")
    if not torch.equal(bu, bk):
        raise SystemExit(f"step_uncached {bu.tolist()} differs from step_cached {bk.tolist()} "
                         f"on the kernel's A {what}")
    if not bool(torch.all(torch.abs(bd - bk) <= 1e-4 * torch.abs(bk))):
        raise SystemExit(f"step with the twist on the device {bd.tolist()} against the "
                         f"host-built block {bk.tolist()} {what}")
    s_err = step_agree(bd, bdp, f"with the twist on the device {what}")

    f_err = 0.0
    for n in N_ODD:
        xo, yo = xp[:, :n].contiguous(), y_xyz[..., :n].contiguous()
        cho = dict(chan=None if chan is None else chan[:, :n].contiguous(),
                   use_geometry=use_geometry)
        fo = ell_ops.flow_reduce(xo, yo, scal, params.c, params.d, **cho)
        fop = ell_ops.flow_reduce_plain(xo, yo, scal, params.c, params.d, **cho)
        _, A_err, tw_err, _ = flow_agree(fo, fop, f"at N = {n} {what}")
        scal_o = ell_ops.pack_scalars(params, Rinv, Tinv, fop[0])
        s_err = max(s_err, step_agree(ell_ops.step_cached(xo, yo, fop[4], scal_o),
                                      ell_ops.step_cached_plain(xo, yo, fop[4], scal_o),
                                      f"at N = {n} {what}"),
                    step_agree(ell_ops.step_cached(xo, yo, fop[4], scal, twist=fop[0]),
                               ell_ops.step_cached_plain(xo, yo, fop[4], scal, twist=fop[0]),
                               f"with the twist on the device at N = {n} {what}"))
        f_err = max(f_err, A_err, tw_err)
    return f_err, s_err


def graph_ms(fn):
    """Device time of one call of fn captured as a CUDA graph, by
    device_ms over back-to-back replays: for a call of many small ops,
    whose host enqueue alone outlasts device_ms's sleep kernel."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return device_ms(g.replay)


def build_timings(nbr, params, ell, src, tgt, Rinv, Tinv, reps=20):
    """One neighbor-list build of the geometric ELL path at the bench
    shapes, by parts: `grid_inputs` (the torch half: table fill, stable sort,
    scatters) and the whole `build_neighbor_list` (grid_inputs, select and
    the list's small reductions). Device ms by CUDA events over graph
    replays (graph_ms), device work items a call as graph nodes, and wall
    ms per call with the host included (each call synchronised)."""
    fns = {"grid_inputs": lambda: nbr.grid_inputs(params, ell, src, tgt, Rinv, Tinv),
           "build_neighbor_list": lambda: nbr.build_neighbor_list(params, ell, src, tgt,
                                                                  Rinv, Tinv)}
    out = {}
    for name, fn in fns.items():
        ms = graph_ms(fn)
        nodes = kernels_per_call(fn)
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(walls)
        out[name] = {"device_ms": ms, "graph_nodes": nodes, "wall_ms": wall}
        log(f"time   build part {name}: device {ms:.4f} ms (graph replays), {nodes} device "
            f"work items a call (graph nodes), wall {wall:.4f} ms a call with the host "
            f"(median of {reps}, synchronised)")
    return out


def check_counters_zero(ell_ops, dev, where):
    counters = ell_ops.finish_counters(dev)
    if int(torch.count_nonzero(counters)):
        raise SystemExit(f"finish counters {counters.tolist()} not back at 0 after {where}")
    log(f"finish counters after {where}: {counters.tolist()}")


def check_kernels(frames_np, guess_np, params, dev, results, floor):
    from unified_cvo_tpu_torch.ops import ell as ell_ops
    from unified_cvo_tpu_torch.ops import lie
    from unified_cvo_tpu_torch.ops import neighbors as nbr
    from unified_cvo_tpu_torch.ops import select as sel
    from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud

    src = make_pointcloud(frames_np[0], bucket=N_POINTS, device=dev)
    tgt = make_pointcloud(frames_np[1], bucket=N_POINTS, device=dev)
    src_masked = make_pointcloud(frames_np[0][:N_MASKED], bucket=N_POINTS, device=dev)
    K, P, dims = nbr.DEFAULT_K, nbr.PER_CELL_CAP, nbr.GRID_DIMS
    ell = torch.full((), params.ell_init, dtype=torch.float32, device=dev)
    eye = torch.eye(4, device=dev)
    for name, guess in (("identity", eye), ("bench guess", torch.from_numpy(guess_np).to(dev))):
        Rinv, Tinv = lie.invert_rt(guess[:3, :3], guess[:3, 3])
        g = select_cases(sel, nbr, params, ell, src, tgt, Rinv, Tinv, name,
                         src_masked if name == "bench guess" else None)
        args = (g.tab, g.cbase, g.xr2, g.pose, K, P, dims)
        sel_err = 0.0          # select_cases held every output equal
        y_xyz = sel.select(*args)[1]
        xp = ell_ops.pack_x(params, ell, src)
        scal = ell_ops.pack_scalars(params, Rinv, Tinv)
        fk = ell_ops.flow_reduce(xp, y_xyz, scal, params.c, params.d)
        fp = ell_ops.flow_reduce_plain(xp, y_xyz, scal, params.c, params.d)
        a_rel, A_err, tw_err, jn_rel = flow_agree(fk, fp, f"at {name}")
        log(f"flow   @ {name}: nonzeros {int(fk[2])} (exact), a_sum rel {a_rel:.3g}, "
            f"A abs {A_err:.3g}, twist abs {tw_err:.3g}, joint norm rel {jn_rel:.3g}")

        scal_t = ell_ops.pack_scalars(params, Rinv, Tinv, fp[0])
        A = fp[4]
        bk = ell_ops.step_cached(xp, y_xyz, A, scal_t)
        bp = ell_ops.step_cached_plain(xp, y_xyz, A, scal_t)
        st_err = step_agree(bk, bp, f"at {name}")
        log(f"step   @ {name}: B..E kernel {bk.tolist()} plain {bp.tolist()}")
        f_err, s_err = ell_consume_checks(ell_ops, params, xp, y_xyz, scal, Rinv, Tinv,
                                          f"at {name}")
        A_err, st_err = max(A_err, tw_err, f_err), max(st_err, s_err)
        log(f"consume @ {name}: flow_reduce, step_cached and step_uncached reruns bit-equal, "
            f"step_uncached equal to step_cached, device-twist step within tolerance of its "
            f"plain version and within rtol 1e-4 of the host-built block, N = "
            f"{' and '.join(map(str, N_ODD))} within tolerance")

        if name != "bench guess":
            continue
        # timings at the main path's shapes (bench guess pose)
        N = src.capacity
        cid = sel.pool_cells(g.cbase, dims)
        touched = int(torch.unique(cid[cid < dims[0] * dims[1] * dims[2]]).numel())
        cands = int((g.tab[cid.long()][..., 3 * P:] >= 0).sum())
        sel_bytes = (touched * 4 * P * 4 + N * (16 + 12) + 48
                     + K * N * 4 + 3 * K * N * 4 + N * 4)
        slot_bytes = 3 * K * N * 4 + 6 * N * 4 + 32 * 4
        build = build_timings(nbr, params, ell, src, tgt, Rinv, Tinv)
        timings = {
            "select": (lambda: sel.select(*args), lambda: sel.select_plain(*args),
                       bound(sel_bytes, SELECT_OPS_PER_CANDIDATE * cands), sel_err,
                       "unified_cvo_tpu/ops/pallas_select.py:39 (_select_kernel)",
                       "unified_cvo_tpu_torch/csrc/select.cu"),
            "flow_reduce": (lambda: ell_ops.flow_reduce(xp, y_xyz, scal, params.c, params.d),
                            lambda: ell_ops.flow_reduce_plain(xp, y_xyz, scal, params.c, params.d),
                            bound(slot_bytes + K * N * 4 + 36, FLOW_OPS_PER_SLOT * K * N),
                            A_err,
                            "unified_cvo_tpu/ops/pallas_ell.py:184 (_flow_reduce_kernel)",
                            "unified_cvo_tpu_torch/csrc/ell.cu"),
            # the form the loop launches: the flow's own block and its twist
            "step_cached": (lambda: ell_ops.step_cached(xp, y_xyz, A, scal, twist=fp[0]),
                            lambda: ell_ops.step_cached_plain(xp, y_xyz, A, scal, twist=fp[0]),
                            bound(slot_bytes + K * N * 4 + 24 + 16, STEP_OPS_PER_SLOT * K * N),
                            st_err,
                            "unified_cvo_tpu/ops/pallas_ell.py:230 (_step_kernel_cached)",
                            "unified_cvo_tpu_torch/csrc/ell.cu"),
        }
        for kname, (kfn, pfn, (b_ms, b_by), err, replaces, source) in timings.items():
            ms = device_ms(kfn)
            plain_ms = device_ms(pfn)
            results[kname] = {
                "name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            n_dev = kernels_per_call(kfn)
            if n_dev != 1:
                raise SystemExit(f"{kname}: one call launched {n_dev} device kernels, not 1")
            results[kname].update(launches_per_call=n_dev, launch_floor_ms=floor)
            log(f"time   {kname}: kernel {ms:.4f} ms (launch floor {floor:.4f} ms), plain "
                f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {n_dev} device kernel a "
                f"call (graph nodes)")
        results["select"]["build"] = build
    check_counters_zero(ell_ops, dev, "phase 2")


def dense_pair_ops(lo, step: bool) -> int:
    """f32 operations per (source, target) pair of the dense kernels at
    layout `lo`, counting each expf, division and comparison as one."""
    ops = 2                                        # sp gate and select
    if lo.use_geo_type:
        ops += 9                                   # dot, n2, cos^2, gate
    if lo.use_geometry:
        ops += 13                                  # d2, gate, exp, scale
    for on, dim in ((lo.use_intensity, lo.feature_dim), (lo.use_semantics, lo.num_classes)):
        if on:
            ops += 2 * dim + 9                     # dot, distance, gate, exp
    return ops + (59 if step else 8)               # step tail / flow moments


GATE_OPS = 10   # d2 (3 subtractions, 3 products, 3 additions) and its comparison


def dense_ops(lo, pairs: int, gated: int, step: bool) -> int:
    """Operations this run's data needs: a pair that fails the geometric
    gate is zero whatever its channels say, so it needs the gate alone;
    the `gated` pairs that pass need all of dense_pair_ops."""
    per = dense_pair_ops(lo, step)
    if not lo.use_geometry:
        return pairs * per
    return pairs * GATE_OPS + gated * (per - GATE_OPS)


def dense_agree(dense, params, lo, xp, yp, yp_t, comp, ti, tj, label):
    """dense_flow and dense_step against their plain versions on one
    compaction, each launched twice: the two launches must be bit-equal.
    Raises SystemExit on any disagreement."""
    fk = dense.dense_flow(params, lo, xp, yp, comp, ti, tj)
    fk2 = dense.dense_flow(params, lo, xp, yp, comp, ti, tj)
    fp = dense.dense_flow_plain(params, lo, xp, yp, comp, ti, tj)
    bk = dense.dense_step(params, lo, xp, yp_t, comp, ti, tj)
    bk2 = dense.dense_step(params, lo, xp, yp_t, comp, ti, tj)
    bp = dense.dense_step_plain(params, lo, xp, yp_t, comp, ti, tj)
    torch.cuda.synchronize()
    s_ok = torch.allclose(fk[0], fp[0], rtol=1e-5, atol=1e-7)
    wy_ok = torch.allclose(fk[1], fp[1], rtol=1e-5, atol=1e-6)
    a_rel = abs(float(fk[3]) - float(fp[3])) / max(abs(float(fp[3])), 1e-30)
    nz_k, nz_p = int(fk[2]), int(fp[2])
    f_err = max(float(torch.max(torch.abs(fk[0] - fp[0]))),
                float(torch.max(torch.abs(fk[1] - fp[1]))))
    if not (nz_k == nz_p and s_ok and wy_ok and a_rel <= 1e-5):
        raise SystemExit(f"dense_flow disagrees ({label}): nonzeros {nz_k} vs {nz_p}, "
                         f"rows s ok {s_ok}, wy ok {wy_ok}, a_sum rel {a_rel}, "
                         f"max abs {f_err}")
    s_err = float(torch.max(torch.abs(bk - bp)))
    if not bool(torch.all(torch.abs(bk - bp) <= 2e-4 * torch.abs(bp) + 1e-6)):
        raise SystemExit(f"dense_step disagrees ({label}): {bk.tolist()} vs {bp.tolist()}")
    if not (all(torch.equal(a, b) for a, b in zip(fk, fk2)) and torch.equal(bk, bk2)):
        raise SystemExit(f"two launches on the same inputs differ ({label})")
    return {"nz": nz_k, "a_rel": a_rel, "f_err": f_err, "s_err": s_err, "bk": bk, "bp": bp,
            "fp": fp}


# measurement builds of csrc/dense.cu for --dense-ablation: what each part
# of the design is worth at the colour set's bench shapes
DENSE_VARIANTS = (
    ("every pair in full (-DDENSE_PREFILTER=0)", ("-DDENSE_PREFILTER=0",)),
    ("survivors not queued (-DDENSE_COMPACT=0)", ("-DDENSE_COMPACT=0",)),
    ("staging not overlapped (-DDENSE_ASYNC=0)", ("-DDENSE_ASYNC=0",)),
    ("nothing fused (-fmad=false)", ("-fmad=false",)),
    ("every pair in full, nothing fused", ("-DDENSE_PREFILTER=0", "-fmad=false")),
)


def dense_ablation(dense, case):
    """Times the package's build of the dense kernels and each measurement
    build in turn on one case (checked against the plain version first)."""
    from concurrent.futures import ThreadPoolExecutor

    from unified_cvo_tpu_torch.ops import cuda_lib

    params, lo, xp, yp, yp_t, comp, ti, tj = case
    with ThreadPoolExecutor(len(DENSE_VARIANTS)) as pool:
        libs = list(pool.map(lambda v: cuda_lib.load_variant("dense", v[1]), DENSE_VARIANTS))
    builds = [("package build", None)] + [
        (label, lib) for (label, _), lib in zip(DENSE_VARIANTS, libs)]
    for label, lib in builds + builds[:1]:
        dense.use_build(lib)
        got = dense_agree(dense, params, lo, xp, yp, yp_t, comp, ti, tj, label)
        f_ms = device_ms(lambda: dense.dense_flow(params, lo, xp, yp, comp, ti, tj))
        s_ms = device_ms(lambda: dense.dense_step(params, lo, xp, yp_t, comp, ti, tj))
        log(f"ablation {label}: first look {dense.library_has_first_look()}, nonzeros "
            f"{got['nz']} (exact), dense_flow {f_ms:.4f} ms, dense_step {s_ms:.4f} ms")
    dense.use_build(None)


# measurement builds of csrc/ell.cu for --ell-ablation: what each part of
# the design is worth
ELL_VARIANTS = (
    ("runtime-K slot loop (-DELL_UNROLL=0)", ("-DELL_UNROLL=0",)),
    ("two block reductions in the flow (-DELL_FUSED_SUM=0)", ("-DELL_FUSED_SUM=0",)),
)


# measurement builds of csrc/select.cu for --select-ablation: what the pick
# and the staged stores are worth on the same gather
SELECT_VARIANTS = (
    ("iterated warp argmin (-DSELECT_ITER_ARGMIN=1)", ("-DSELECT_ITER_ARGMIN=1",)),
    ("slots stored from their lanes (-DSELECT_DIRECT_STORE=1)", ("-DSELECT_DIRECT_STORE=1",)),
)


def select_ablation(frames_np, guess_np, params, dev, floor):
    """--select-ablation: the package's build of csrc/select.cu and each
    measurement build in turn, each checked (select_cases at the bench
    guess: every output equal to select_plain, two launches bit-equal), its
    device kernels a call counted (1), then timed at the bench shapes
    (N = 16384, K = 32, P = 8) and at per_cell_cap = 24, beside its
    registers."""
    from concurrent.futures import ThreadPoolExecutor

    from unified_cvo_tpu_torch.ops import cuda_lib
    from unified_cvo_tpu_torch.ops import lie
    from unified_cvo_tpu_torch.ops import neighbors as nbr
    from unified_cvo_tpu_torch.ops import select as sel
    from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud

    src = make_pointcloud(frames_np[0], bucket=N_POINTS, device=dev)
    tgt = make_pointcloud(frames_np[1], bucket=N_POINTS, device=dev)
    src_masked = make_pointcloud(frames_np[0][:N_MASKED], bucket=N_POINTS, device=dev)
    ell = torch.full((), params.ell_init, dtype=torch.float32, device=dev)
    guess = torch.from_numpy(guess_np).to(dev)
    Rinv, Tinv = lie.invert_rt(guess[:3, :3], guess[:3, 3])
    K, dims = nbr.DEFAULT_K, nbr.GRID_DIMS
    timed = {}
    for P in (nbr.PER_CELL_CAP, 24):
        g = nbr.grid_inputs(params, ell, src, tgt, Rinv, Tinv, per_cell_cap=P)
        timed[f"P {P}"] = (g.tab, g.cbase, g.xr2, g.pose, K, P, dims)
    with ThreadPoolExecutor(len(SELECT_VARIANTS)) as pool:
        list(pool.map(lambda v: cuda_lib.build_all(["select"], v[1]), SELECT_VARIANTS))
    libs = [cuda_lib.load_variant("select", flags) for _, flags in SELECT_VARIANTS]
    builds = [("package build", (), None, cuda_lib.build_report("select"))] + [
        (label, flags, lib, cuda_lib.build_report("select", flags)) for (label, flags), lib in
        zip(SELECT_VARIANTS, libs)]
    for label, flags, lib, report in builds + builds[:1]:
        sel.use_build(lib)
        design = sel.library_design()
        for flag in flags:
            key, value = flag[2:].split("=")
            if design[key] != int(value):
                raise SystemExit(f"ablation {label}: the build reports {design}")
        select_cases(sel, nbr, params, ell, src, tgt, Rinv, Tinv, f"bench guess, {label}",
                     src_masked)
        times = []
        for case, args in timed.items():
            n_dev = kernels_per_call(lambda: sel.select(*args))
            if n_dev != 1:
                raise SystemExit(f"ablation {label}: select launched {n_dev} device kernels "
                                 f"a call at {case}, not 1")
            times.append(f"{case} {device_ms(lambda: sel.select(*args)):.4f} ms")
        regs = register_counts(report)
        reg_txt = ", ".join(f"<{', '.join(template_ints(k))}> {r}" + (f" (spill {b} B)" if b else "")
                            for k, (r, b) in sorted(regs.items()) if "select_kernel" in k)
        log(f"ablation {label}: select " + ", ".join(times) + f" (launch floor {floor:.4f} "
            f"ms); 1 device kernel a call (graph nodes); checks passed; registers by "
            f"instantiation <P, candidates a lane>: {reg_txt or 'no compiler report'}; "
            f"design {design}")
    sel.use_build(None)


def template_ints(mangled):
    """The integer template arguments of a mangled kernel name."""
    return re.findall(r"Li(\d+)E", mangled)


def register_counts(report):
    """{kernel entry (mangled name): (registers a thread, spill store
    bytes)} from a ptxas -v report."""
    out, entry, spill = {}, None, 0
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry, spill = line.split("'")[1], 0
        elif "bytes spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in line and entry is not None:
            out[entry] = (int(line.split("Used")[1].split()[0]), spill)
            entry = None
    return out


def ell_ablation(frames_np, feats, guess_np, dev, floor):
    """--ell-ablation: the package's build of csrc/ell.cu and each
    measurement build in turn, each checked on the geometric and the colour
    bench list (ell_consume_checks, and flow_reduce against its plain
    version at full N), its device kernels a call counted (1 in every
    build), then timed: flow_reduce (geometry, geometry x chan) and
    step_cached in the loop's form (the flow's twist) at the bench
    shapes."""
    from concurrent.futures import ThreadPoolExecutor

    from unified_cvo_tpu_torch.config import KITTI_COLOR_BENCH, KITTI_GEOMETRIC_BENCH
    from unified_cvo_tpu_torch.ops import cuda_lib
    from unified_cvo_tpu_torch.ops import ell as ell_ops
    from unified_cvo_tpu_torch.ops import lie
    from unified_cvo_tpu_torch.ops import neighbors as nbr
    from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud

    n = len(frames_np[0])
    guess = torch.from_numpy(guess_np).to(dev)
    Rinv, Tinv = lie.invert_rt(guess[:3, :3], guess[:3, 3])
    src = make_pointcloud(frames_np[0], features=feats, bucket=n, device=dev)
    tgt = make_pointcloud(frames_np[1], features=feats, bucket=n, device=dev)
    lists = []
    for params in (KITTI_GEOMETRIC_BENCH, KITTI_COLOR_BENCH):
        ell = torch.full((), params.ell_init, dtype=torch.float32, device=dev)
        nl = nbr.build_neighbor_list(params, ell, src, tgt, Rinv, Tinv)
        lists.append((params, nl, ell_ops.pack_x(params, ell, src),
                      ell_ops.pack_scalars(params, Rinv, Tinv)))
    with ThreadPoolExecutor(len(ELL_VARIANTS)) as pool:
        list(pool.map(lambda v: cuda_lib.build_all(["ell"], v[1]), ELL_VARIANTS))
    libs = [cuda_lib.load_variant("ell", flags) for _, flags in ELL_VARIANTS]
    builds = [("package build", (), None, cuda_lib.build_report("ell"))] + [
        (label, flags, lib, cuda_lib.build_report("ell", flags)) for (label, flags), lib in
        zip(ELL_VARIANTS, libs)]
    for label, flags, lib, report in builds + builds[:1]:
        ell_ops.use_build(lib)
        design = ell_ops.library_design()
        for flag in flags:
            key, value = flag[2:].split("=")
            if design[key] != int(value):
                raise SystemExit(f"ablation {label}: the build reports {design}")
        times, per_call = [], {}
        for params, nl, xp, scal in lists:
            v = ell_ops.variant(nl.chan, True)
            fk = ell_ops.flow_reduce(xp, nl.y_xyz, scal, params.c, params.d, chan=nl.chan)
            fp = ell_ops.flow_reduce_plain(xp, nl.y_xyz, scal, params.c, params.d,
                                           chan=nl.chan)
            flow_agree(fk, fp, f"({v}, {label})")
            ell_consume_checks(ell_ops, params, xp, nl.y_xyz, scal, Rinv, Tinv,
                               f"({v}, {label})", chan=nl.chan)
            fns = {f"flow_reduce {v}": lambda: ell_ops.flow_reduce(
                xp, nl.y_xyz, scal, params.c, params.d, chan=nl.chan)}
            if v == "geo":
                fns["step_cached"] = lambda: ell_ops.step_cached(xp, nl.y_xyz, fk[4], scal,
                                                                 twist=fk[0])
            for kname, fn in fns.items():
                per_call[kname] = kernels_per_call(fn)
                times.append((kname, device_ms(fn)))
        if any(c != 1 for c in per_call.values()):
            raise SystemExit(f"ablation {label}: device kernels a call {per_call}, expected 1")
        regs = register_counts(report)
        reg_txt = ", ".join(
            f"{kind} <= {max(r for k, (r, _) in regs.items() if kind in k)} registers"
            for kind in ("flow_kernel", "step_kernel") if any(kind in k for k in regs))
        log(f"ablation {label}: " + ", ".join(f"{k} {t:.4f} ms" for k, t in times)
            + f" (launch floor {floor:.4f} ms); 1 device kernel a call (graph nodes); "
            f"checks passed; {reg_txt or 'registers: no compiler report'}; design {design}")
    ell_ops.use_build(None)
    check_counters_zero(ell_ops, dev, "the ablation")


def matrix_twist_part(twist):
    """The twist part of the scalar block in matrix form: W = skew(omega),
    W @ v, W @ (W v) and torch.dot. The same values as
    ops/ell.py::twist_scalars (cross products, dots summed left to right,
    the order the kernel follows); only the roundings may differ."""
    from unified_cvo_tpu_torch.ops import lie

    omega, v = twist[:3].to(torch.float32), twist[3:].to(torch.float32)
    W = lie.skew(omega)
    Wv = W @ v
    c2 = W @ Wv
    return torch.cat([torch.stack([torch.dot(omega, omega), torch.dot(v, v)]), omega, v, Wv, c2,
                      torch.stack([torch.dot(v, Wv), torch.dot(Wv, Wv), torch.dot(v, c2),
                                   torch.dot(v, omega)])])


def pose_error_witness(frames_np, T_true, guess_np, dev):
    """--ell-ablation: the geometric ELL path as phase 3 runs it, three
    times: the step's twist part built in the kernel (the package's loop),
    then on the host by ops/ell.py::twist_scalars, then on the host in
    matrix form. The first two differ only in where the same operations
    run, the last two only in their order; what is left between the first
    and another build of the kernels is the kernels' own sum order."""
    from unified_cvo_tpu_torch.apps import f2f_sequence as f2f
    from unified_cvo_tpu_torch.config import KITTI_GEOMETRIC_BENCH
    from unified_cvo_tpu_torch.ops import ell as ell_ops
    from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud

    frames = [make_pointcloud(f, bucket=N_POINTS, device=dev) for f in frames_np]
    guess = torch.from_numpy(guess_np).to(dev)
    kernel = ell_ops.step_cached
    first = None
    for label, twist_part in (("in the kernel", None),
                              ("on the host, twist_scalars", ell_ops.twist_scalars),
                              ("on the host, matrix form", matrix_twist_part)):
        if twist_part is not None:
            def step(xp, y_xyz, a, scal, twist=None, twist_part=twist_part):
                if twist is not None:
                    scal, twist = torch.cat([scal[:ell_ops.S_OM2], twist_part(twist)]), None
                return kernel(xp, y_xyz, a, scal, twist)

            step.launches = 0   # the wrapper counts its launches under the module's name
            ell_ops.step_cached = step
        t0 = time.perf_counter()
        res, infos = f2f.run_sequence(frames[1:], guess, KITTI_GEOMETRIC_BENCH, device=dev,
                                      max_iter=MAX_ITER)
        torch.cuda.synchronize()
        ell_ops.step_cached = kernel
        errs = f2f.pose_errors(res, T_true[1:])
        same = first is not None and all(torch.equal(a, b) for a, b in zip(res, first))
        first = res if first is None else first
        log(f"pose-error witness, twist part {label}: max {max(errs):.6f} mean "
            f"{sum(errs) / len(errs):.6f}, per frame {[round(e, 6) for e in errs]}, "
            f"iterations {[i.iterations for i in infos]}, "
            f"{time.perf_counter() - t0:.1f} s"
            + ("" if first is res else f"; transforms bit-equal to the kernel's: {same}"))


def check_dense_kernels(frames_np, feats, guess_np, dev, results, ablation=False):
    """Phase 2b: dense_flow and dense_step against their plain versions at
    the bench shapes (frames 0 -> 1 at the bench guess, ell_init culling,
    tiles 128 x 512) for (a) KITTI_COLOR_BENCH with 5 features and (b) every
    channel: geometry, intensity, 19 one-hot semantic classes and mixed
    geometric types, (c) geometry only and (d) a set without an
    instantiation of its own. Each set on three compactions: the culled
    one, the same with one source tile emptied, and every pair active; set
    (a) also on two other tilings (half-filled row blocks and short chunks,
    two row blocks per tile); every kernel launched twice for bit-equal
    outputs."""
    from unified_cvo_tpu_torch.config import KITTI_COLOR_BENCH, KITTI_GEOMETRIC_BENCH
    from unified_cvo_tpu_torch.ops import dense, kernels, lie, morton
    from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud

    rng = np.random.default_rng(11)
    n = len(frames_np[0])
    labels = np.eye(N_CLASSES, dtype=np.float32)[rng.integers(0, N_CLASSES, n)]
    geo = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    sets = {
        "a: colour (F=5)": (KITTI_COLOR_BENCH, {}, "colour"),
        "b: all channels (F=5, C=19, geo types)": (
            KITTI_COLOR_BENCH.replace(is_using_semantics=1, is_using_geometric_type=1),
            dict(labels=labels, geometric_types=geo), "all_channels"),
        "c: geometry only": (KITTI_GEOMETRIC_BENCH, {}, "geometry"),
        "d: colour and semantics, an unlisted set (F=5, C=19)": (
            KITTI_COLOR_BENCH.replace(is_using_semantics=1), dict(labels=labels), "generic"),
    }
    ti, tj = dense.DEFAULT_TILE_I, dense.DEFAULT_TILE_J
    guess = torch.from_numpy(guess_np).to(dev)
    Rinv, Tinv = lie.invert_rt(guess[:3, :3], guess[:3, 3])
    errs = {"dense_flow": 0.0, "dense_step": 0.0}
    for label, (params, extra, instance) in sets.items():
        src, _ = morton.sort_cloud(make_pointcloud(frames_np[0], features=feats, bucket=n,
                                                   device=dev, **extra))
        tgt, _ = morton.sort_cloud(make_pointcloud(frames_np[1], features=feats, bucket=n,
                                                   device=dev, **extra))
        y_t = tgt.transformed(Rinv, Tinv)
        ell = torch.full((), params.ell_init, dtype=torch.float32, device=dev)

        def cull_mask(ti, tj):
            x_lo, x_hi = morton.tile_aabbs(src.xyz, src.mask, ti)
            y_lo, y_hi = morton.tile_aabbs(y_t.xyz, y_t.mask, tj)
            return morton.tile_cull_mask(
                x_lo, x_hi, morton.tile_d2max(params, ell, src.xyz, src.mask, ti), y_lo, y_hi)

        mask = cull_mask(ti, tj)
        comp = dense.compact_tile_mask(mask)
        n_act = int(comp.n)
        lo = dense.layout_for(params, src)
        chosen = dense.library_instance(lo)
        if not chosen == dense.kernel_instance(lo) == instance:
            raise SystemExit(f"dense ({label}): the library runs the {chosen} instantiation, "
                             f"ops/dense.py says {dense.kernel_instance(lo)}, expected {instance}")
        center = dense.cloud_center(src)
        xp = dense.pack_x(params, lo, src, ell, center=center)
        yp = dense.pack_y(lo, y_t, center=center)
        fp = dense.dense_flow_plain(params, lo, xp, yp, comp, ti, tj)
        stats = kernels.FlowStats(fp[0], fp[1] + fp[0][:, None] * center, fp[2], fp[3])
        twist, _ = kernels.flow_from_stats(params, src, stats)
        yp_t = dense.pack_y(lo, y_t, twist=twist, center=center)
        got = dense_agree(dense, params, lo, xp, yp, yp_t, comp, ti, tj, label)
        errs["dense_flow"] = max(errs["dense_flow"], got["f_err"])
        errs["dense_step"] = max(errs["dense_step"], got["s_err"])
        pairs = n_act * ti * tj
        gated = dense.geometric_gate_count(lo, xp, yp, comp, ti, tj)
        log(f"dense  @ {label} ({chosen} instantiation): {n_act} of {comp.pair_i.numel()} "
            f"tile pairs active ({pairs / 1e6:.1f} M point pairs, {gated} pass the geometric "
            f"gate); flow nonzeros {got['nz']} (exact), a_sum rel {got['a_rel']:.3g}, rows "
            f"max abs {got['f_err']:.3g}; step B..E kernel {got['bk'].tolist()} plain "
            f"{got['bp'].tolist()}; two launches bit-equal")
        busiest = int(torch.argmax(mask.sum(dim=1)))
        emptied = mask.clone()
        emptied[busiest] = 0
        for kind, m in (("source tile %d emptied" % busiest, emptied),
                        ("every pair active", torch.ones_like(mask))):
            other = dense.compact_tile_mask(m)
            o = dense_agree(dense, params, lo, xp, yp, yp_t, other, ti, tj, f"{label}, {kind}")
            errs["dense_flow"] = max(errs["dense_flow"], o["f_err"])
            errs["dense_step"] = max(errs["dense_step"], o["s_err"])
            zero_rows = bool(torch.all(o["fp"][0][busiest * ti:(busiest + 1) * ti] == 0))
            log(f"dense  @ {label}, {kind}: {int(other.n)} tile pairs, flow nonzeros "
                f"{o['nz']} (exact), rows max abs {o['f_err']:.3g}, step max abs "
                f"{o['s_err']:.3g}; two launches bit-equal"
                + (f"; rows of tile {busiest} zero" if kind.startswith("source") and zero_rows
                   else ""))

        for ti2, tj2 in ((64, 64), (256, 256)) if label.startswith("a") else ():
            other = dense.compact_tile_mask(cull_mask(ti2, tj2))
            o = dense_agree(dense, params, lo, xp, yp, yp_t, other, ti2, tj2,
                            f"{label}, tiles {ti2} x {tj2}")
            log(f"dense  @ {label}, tiles {ti2} x {tj2}: {int(other.n)} of "
                f"{other.pair_i.numel()} tile pairs, flow nonzeros {o['nz']} (exact), rows max "
                f"abs {o['f_err']:.3g}, step max abs {o['s_err']:.3g}; two launches bit-equal")

        # timings at every channel set; set (a) is the main path's and goes
        # into the kernels line
        comp_bytes = 4 * (3 * comp.pair_i.numel() + 1) + comp.row_has.numel()
        in_bytes = 4 * (xp.numel()) + comp_bytes
        timings = {
            "dense_flow": (lambda: dense.dense_flow(params, lo, xp, yp, comp, ti, tj),
                           lambda: dense.dense_flow_plain(params, lo, xp, yp, comp, ti, tj),
                           in_bytes + 4 * yp.numel() + 4 * 5 * n + 8, False,
                           "unified_cvo_tpu/ops/pallas_kernels.py:398 (_flow_kernel)"),
            "dense_step": (lambda: dense.dense_step(params, lo, xp, yp_t, comp, ti, tj),
                           lambda: dense.dense_step_plain(params, lo, xp, yp_t, comp, ti, tj),
                           in_bytes + 4 * yp_t.numel() + 16, True,
                           "unified_cvo_tpu/ops/pallas_kernels.py:429 (_step_kernel)"),
        }
        for kname, (kfn, pfn, nbytes, step, replaces) in timings.items():
            b_ms, b_by = bound(nbytes, dense_ops(lo, pairs, gated, step))
            every_ms, _ = bound(nbytes, pairs * dense_pair_ops(lo, step))
            ms = device_ms(kfn)
            plain_ms = device_ms(pfn, reps=3, trials=3)
            log(f"time   {kname} ({label}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {b_ms:.4f} ms ({b_by}; {every_ms:.4f} ms if every pair needed "
                f"every operation)")
            if label.startswith("a"):
                results[kname] = {
                    "name": kname, "route": "cuda",
                    "source": "unified_cvo_tpu_torch/csrc/dense.cu", "replaces": replaces,
                    "launches": None, "max_abs_err": None, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                    "bound_ms_every_pair": every_ms}
        if ablation and label.startswith("a"):
            dense_ablation(dense, (params, lo, xp, yp, yp_t, comp, ti, tj))
    for kname, err in errs.items():
        results[kname]["max_abs_err"] = err


def rows_agree(ell_ops, rk, xp, y_xyz, scal, ch, use_geo, what, nz=None):
    """flow_rows' result against its plain version: cnt and nonzeros
    exact, s rtol 1e-5 atol 1e-7, wy rtol 1e-5 atol 1e-6 (channel only:
    rtol 1e-4 atol 1e-5), a_sum rel 1e-5; nonzeros also equal to `nz` when
    given. Returns (a_sum rel, largest row error); raises SystemExit on a
    disagreement."""
    rp = ell_ops.flow_rows_plain(xp, y_xyz, scal, **ch)
    torch.cuda.synchronize()
    # without geometry every live slot carries an O(0.1) A, so wy sums 32
    # terms of |A y| up to ~20 and takes the JAX test's own wy tolerance
    # (rtol 1e-4 atol 1e-5, test_neighbors.py:293)
    wy_tol = dict(rtol=1e-5, atol=1e-6) if use_geo else dict(rtol=1e-4, atol=1e-5)
    s_ok = torch.allclose(rk[0], rp[0], rtol=1e-5, atol=1e-7)
    wy_ok = torch.allclose(rk[1], rp[1], **wy_tol)
    r_rel = abs(float(rk[4]) - float(rp[4])) / abs(float(rp[4]))
    nz_ok = int(rk[3]) == int(rp[3]) and (nz is None or int(rp[3]) == nz)
    if not (s_ok and wy_ok and torch.equal(rk[2], rp[2]) and nz_ok and r_rel <= 1e-5):
        raise SystemExit(f"flow_rows {what} disagrees: s ok {s_ok}, wy ok {wy_ok} (max abs "
                         f"{float(torch.max(torch.abs(rk[1] - rp[1])))}), cnt equal "
                         f"{torch.equal(rk[2], rp[2])}, nonzeros {int(rk[3])} vs {int(rp[3])} "
                         f"({nz}), a_sum rel {r_rel}")
    return r_rel, max(float(torch.max(torch.abs(rk[0] - rp[0]))),
                      float(torch.max(torch.abs(rk[1] - rp[1]))))


def check_ell_channel_kernels(frames_np, feats, guess_np, dev, results, floor):
    """Phase 2c: the ELL kernel variants at the bench shapes (frames 0 -> 1,
    bench guess, K = 32, ell_init): flow_reduce, flow_rows and
    step_uncached against their plain versions on four lists: geometry
    only (KITTI_GEOMETRIC_BENCH, grid), colour (KITTI_COLOR_BENCH, grid,
    chan), all channels (plus 19 one-hot classes and geometric types, grid,
    chan) and channel only (KITTI_COLOR_BENCH without geometry, scan,
    chan). Logs each variant's time, plain time and bound; flow_rows and
    step_uncached take the launches of these checks, since no path
    launches them."""
    from unified_cvo_tpu_torch.config import KITTI_COLOR_BENCH, KITTI_GEOMETRIC_BENCH
    from unified_cvo_tpu_torch.ops import ell as ell_ops
    from unified_cvo_tpu_torch.ops import lie
    from unified_cvo_tpu_torch.ops import neighbors as nbr
    from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud

    rng = np.random.default_rng(11)
    n = len(frames_np[0])
    extra = dict(labels=np.eye(N_CLASSES, dtype=np.float32)[rng.integers(0, N_CLASSES, n)],
                 geometric_types=np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)])
    all_ch = KITTI_COLOR_BENCH.replace(is_using_semantics=1, is_using_geometric_type=1)
    sets = [("geometry only", KITTI_GEOMETRIC_BENCH, {}, "grid"),
            ("colour", KITTI_COLOR_BENCH, {}, "grid"),
            ("all channels", all_ch, extra, "grid"),
            ("channel only", KITTI_COLOR_BENCH.replace(is_using_geometry=0), {}, "scan")]
    guess = torch.from_numpy(guess_np).to(dev)
    Rinv, Tinv = lie.invert_rt(guess[:3, :3], guess[:3, 3])
    variants = {"flow_reduce": {}, "flow_rows": {}, "step_uncached": {}}
    errs = dict.fromkeys([*variants, "step_cached"], 0.0)
    timed = []
    ell_ops.reset_launches()
    for label, params, fields, builder in sets:
        src = make_pointcloud(frames_np[0], features=feats, bucket=n, device=dev, **fields)
        tgt = make_pointcloud(frames_np[1], features=feats, bucket=n, device=dev, **fields)
        ell = torch.full((), params.ell_init, dtype=torch.float32, device=dev)
        build = nbr.build_neighbor_list if builder == "grid" else nbr.build_neighbor_list_scan
        nl = build(params, ell, src, tgt, Rinv, Tinv)
        use_geo = bool(params.is_using_geometry)
        v = ell_ops.variant(nl.chan, use_geo)
        K = nl.y_xyz.shape[1]
        xp = ell_ops.pack_x(params, ell, src)
        scal = ell_ops.pack_scalars(params, Rinv, Tinv)
        ch = dict(chan=nl.chan, use_geometry=use_geo)

        fk = ell_ops.flow_reduce(xp, nl.y_xyz, scal, params.c, params.d, **ch)
        fp = ell_ops.flow_reduce_plain(xp, nl.y_xyz, scal, params.c, params.d, **ch)
        torch.cuda.synchronize()
        a_rel, A_err, tw_err, _ = flow_agree(fk, fp, f"({v}) on the {label} list")
        nz_k, nz_p = int(fk[2]), int(fp[2])
        f_err, s_err = ell_consume_checks(ell_ops, params, xp, nl.y_xyz, scal, Rinv, Tinv,
                                          f"({v}) on the {label} list", **ch)
        errs["flow_reduce"] = max(errs["flow_reduce"], A_err, tw_err, f_err)
        errs["step_cached"] = max(errs["step_cached"], s_err)

        rk = ell_ops.flow_rows(xp, nl.y_xyz, scal, **ch)
        rk2 = ell_ops.flow_rows(xp, nl.y_xyz, scal, **ch)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(rk, rk2)):
            raise SystemExit(f"two launches of flow_rows ({v}) differ on the {label} list")
        r_rel, r_err = rows_agree(ell_ops, rk, xp, nl.y_xyz, scal, ch, use_geo,
                                  f"({v}) on the {label} list", nz_p)
        for n_odd in N_ODD:
            cho = dict(chan=None if nl.chan is None else nl.chan[:, :n_odd].contiguous(),
                       use_geometry=use_geo)
            xo, yo = xp[:, :n_odd].contiguous(), nl.y_xyz[..., :n_odd].contiguous()
            _, e = rows_agree(ell_ops, ell_ops.flow_rows(xo, yo, scal, **cho), xo, yo, scal, cho,
                              use_geo, f"({v}) at N = {n_odd} on the {label} list")
            r_err = max(r_err, e)
        n_rows = kernels_per_call(lambda: ell_ops.flow_rows(xp, nl.y_xyz, scal, **ch))
        if n_rows != 1:
            raise SystemExit(f"flow_rows ({v}): one call launched {n_rows} device kernels, not 1")
        errs["flow_rows"] = max(errs["flow_rows"], r_err)

        scal_t = ell_ops.pack_scalars(params, Rinv, Tinv, fp[0])
        bk = ell_ops.step_uncached(xp, nl.y_xyz, scal_t, **ch)
        bp = ell_ops.step_uncached_plain(xp, nl.y_xyz, scal_t, **ch)
        bc = ell_ops.step_cached(xp, nl.y_xyz, fk[4], scal_t)
        torch.cuda.synchronize()
        if not (bool(torch.all(torch.abs(bk - bp) <= 1e-3 * torch.abs(bp) + 1e-4))
                and torch.equal(bk, bc)):
            raise SystemExit(f"step_uncached ({v}) disagrees on the {label} list: kernel "
                             f"{bk.tolist()}, plain {bp.tolist()}, cached kernel {bc.tolist()}")
        errs["step_uncached"] = max(errs["step_uncached"], float(torch.max(torch.abs(bk - bp))))
        log(f"ell {v:8s} @ {label} ({builder} list, K {K}, {int(nl.valid.sum())} live slots, "
            f"overflow {int(nl.overflow)}): flow_reduce nonzeros {nz_k} (exact), a_sum rel "
            f"{a_rel:.3g}, A abs {A_err:.3g}, twist abs {tw_err:.3g}; flow_rows s, wy, cnt "
            f"within tolerance, a_sum rel {r_rel:.3g}, {n_rows} device kernel a call (graph "
            f"nodes); step_uncached B..E {bk.tolist()} (plain {bp.tolist()}, equal to "
            f"step_cached on the kernel's A); reruns bit-equal, device-twist step within "
            f"rtol 1e-4, N = {' and '.join(map(str, N_ODD))} within tolerance")
        if label != "all channels":
            timed.append((v, xp, nl, scal, scal_t, ch, params))

    check_counters_zero(ell_ops, dev, "phase 2c")
    launches = {name: (getattr(ell_ops, name).launches, dict(getattr(ell_ops, name).variant_launches))
                for name in ("flow_rows", "step_uncached")}
    for v, xp, nl, scal, scal_t, ch, params in timed:
        K, N = nl.y_xyz.shape[1], nl.y_xyz.shape[2]
        slot_in = 3 * K * N * 4 + 6 * N * 4 + 32 * 4 + (K * N * 4 if nl.chan is not None else 0)
        a_ops = A_OPS_PER_SLOT[v]
        fns = {
            "flow_reduce": (
                lambda: ell_ops.flow_reduce(xp, nl.y_xyz, scal, params.c, params.d, **ch),
                lambda: ell_ops.flow_reduce_plain(xp, nl.y_xyz, scal, params.c, params.d, **ch),
                bound(slot_in + K * N * 4 + 36, (a_ops + 12) * K * N)),
            "flow_rows": (
                lambda: ell_ops.flow_rows(xp, nl.y_xyz, scal, **ch),
                lambda: ell_ops.flow_rows_plain(xp, nl.y_xyz, scal, **ch),
                bound(slot_in + 5 * N * 4 + 8, (a_ops + 8) * K * N)),
            "step_uncached": (
                lambda: ell_ops.step_uncached(xp, nl.y_xyz, scal_t, **ch),
                lambda: ell_ops.step_uncached_plain(xp, nl.y_xyz, scal_t, **ch),
                bound(slot_in + 16, (a_ops + STEP_OPS_PER_SLOT) * K * N)),
        }
        for kname, (kfn, pfn, (b_ms, b_by)) in fns.items():
            ms, plain_ms = device_ms(kfn), device_ms(pfn)
            variants[kname][v] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                                  "bound_by": b_by}
            log(f"time   {kname} ({v}): kernel {ms:.4f} ms (launch floor {floor:.4f} ms), "
                f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    results["flow_reduce"]["variants"] = variants["flow_reduce"]
    for kname in ("flow_reduce", "step_cached"):
        results[kname]["max_abs_err"] = max(results[kname]["max_abs_err"], errs[kname])
    for kname, replaces in (("flow_rows", "unified_cvo_tpu/ops/pallas_ell.py:168 (_flow_kernel)"),
                            ("step_uncached",
                             "unified_cvo_tpu/ops/pallas_ell.py:249 (_step_kernel, reduced)")):
        geo = variants[kname]["geo"]
        results[kname] = {
            "name": kname, "route": "cuda", "source": "unified_cvo_tpu_torch/csrc/ell.cu",
            "replaces": replaces, "launches": launches[kname][0],
            "max_abs_err": errs[kname], "ms": geo["ms"], "plain_ms": geo["plain_ms"],
            "bound_ms": geo["bound_ms"], "bound_by": geo["bound_by"], "library_ms": None,
            "variants": variants[kname], "launches_by_variant": launches[kname][1],
            "launched_by": "phase 2c checks (no align path calls it, as in JAX)",
            "launches_per_call": 1, "launch_floor_ms": floor}


def kernel_times(frames_np, feats, guess_np, dev, floor):
    """--kernel-times TREE: the select and flow_rows kernels of the
    unified_cvo_tpu_torch package found first on the path (TREE's), each
    held against its plain version, its device kernels a call counted and
    timed at the bench shapes: select at the bench guess, flow_rows in its
    three variants (geometry and colour on grid lists, channel only on a
    scan list), flow_reduce geo and step_cached (the loop's form) beside
    them. Prints one JSON line."""
    import unified_cvo_tpu_torch
    from unified_cvo_tpu_torch.config import KITTI_COLOR_BENCH, KITTI_GEOMETRIC_BENCH
    from unified_cvo_tpu_torch.ops import ell as ell_ops
    from unified_cvo_tpu_torch.ops import lie
    from unified_cvo_tpu_torch.ops import neighbors as nbr
    from unified_cvo_tpu_torch.ops import select as sel
    from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud

    guess = torch.from_numpy(guess_np).to(dev)
    Rinv, Tinv = lie.invert_rt(guess[:3, :3], guess[:3, 3])
    times, nodes = {}, {}

    def timed(name, fn):
        nodes[name] = kernels_per_call(fn)
        times[name] = device_ms(fn)

    params = KITTI_GEOMETRIC_BENCH
    src = make_pointcloud(frames_np[0], features=feats, bucket=N_POINTS, device=dev)
    tgt = make_pointcloud(frames_np[1], features=feats, bucket=N_POINTS, device=dev)
    ell = torch.full((), params.ell_init, dtype=torch.float32, device=dev)
    g = nbr.grid_inputs(params, ell, src, tgt, Rinv, Tinv)
    args = (g.tab, g.cbase, g.xr2, g.pose, nbr.DEFAULT_K, nbr.PER_CELL_CAP, nbr.GRID_DIMS)
    select_exact(sel, args, "at the bench guess")
    timed("select", lambda: sel.select(*args))
    for params, builder in ((KITTI_GEOMETRIC_BENCH, nbr.build_neighbor_list),
                            (KITTI_COLOR_BENCH, nbr.build_neighbor_list),
                            (KITTI_COLOR_BENCH.replace(is_using_geometry=0),
                             nbr.build_neighbor_list_scan)):
        ell = torch.full((), params.ell_init, dtype=torch.float32, device=dev)
        nl = builder(params, ell, src, tgt, Rinv, Tinv)
        use_geo = bool(params.is_using_geometry)
        ch = dict(chan=nl.chan, use_geometry=use_geo)
        v = ell_ops.variant(nl.chan, use_geo)
        xp = ell_ops.pack_x(params, ell, src)
        scal = ell_ops.pack_scalars(params, Rinv, Tinv)
        rows_agree(ell_ops, ell_ops.flow_rows(xp, nl.y_xyz, scal, **ch), xp, nl.y_xyz, scal, ch,
                   use_geo, f"({v})")
        timed(f"flow_rows {v}", lambda: ell_ops.flow_rows(xp, nl.y_xyz, scal, **ch))
        if v == "geo":
            fk = ell_ops.flow_reduce(xp, nl.y_xyz, scal, params.c, params.d)
            timed("flow_reduce geo", lambda: ell_ops.flow_reduce(xp, nl.y_xyz, scal, params.c,
                                                                 params.d))
            timed("step_cached", lambda: ell_ops.step_cached(xp, nl.y_xyz, fk[4], scal,
                                                             twist=fk[0]))
    log(json.dumps({"tree": unified_cvo_tpu_torch.__file__, "launch_floor_ms": floor,
                    "ms": times, "graph_nodes": nodes}))


def compare_trees(other, frames):
    """--compare-tree DIR: kernel_times of the package in DIR and of this
    tree's, each in a process of its own, in the order DIR, this, this,
    DIR, on one card; then a table of the four runs."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    order = ((other, "other"), (here, "this"), (here, "this"), (other, "other"))
    runs = []
    for tree, _ in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--frames", str(frames),
                              "--kernel-times", os.path.abspath(tree)],
                             capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise SystemExit(f"kernel times of {tree} failed ({out.returncode}):\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        log(f"tree {tree}: " + out.stdout.strip().splitlines()[-1])
    names = list(runs[1]["ms"])
    log(f"{'ms (graph nodes)':20s}" + "  ".join(f"{label:>14s}" for _, label in order))
    for name in names:
        log(f"{name:20s}" + "  ".join(
            f"{r['ms'].get(name, float('nan')):9.4f} ({r['graph_nodes'].get(name, 0)})"
            for r in runs))


def reset_launch_counts():
    from unified_cvo_tpu_torch.ops import dense
    from unified_cvo_tpu_torch.ops import ell as ell_ops
    from unified_cvo_tpu_torch.ops import select as sel

    ell_ops.reset_launches()
    for fn in (sel.select, dense.dense_flow, dense.dense_step):
        fn.launches = 0


def launch_counts():
    from unified_cvo_tpu_torch.ops import dense
    from unified_cvo_tpu_torch.ops import ell as ell_ops
    from unified_cvo_tpu_torch.ops import select as sel

    return {"select": sel.select.launches, "flow_reduce": ell_ops.flow_reduce.launches,
            "flow_reduce_by_variant": dict(ell_ops.flow_reduce.variant_launches),
            "step_cached": ell_ops.step_cached.launches,
            "dense_flow": dense.dense_flow.launches, "dense_step": dense.dense_step.launches}


def profile_main_path(f2f, frames, guess, params, dev, iters=200, label="", **align_kw):
    """Where an iteration's time goes: one pair capped at `iters` iterations
    under torch.profiler. Prints wall time, device kernels and device busy
    time per iteration, the device's idle share and the heaviest kernels."""
    from torch.profiler import ProfilerActivity, profile

    f2f.run_sequence(frames[:2], guess, params, device=dev, max_iter=iters, **align_kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, infos = f2f.run_sequence(frames[:2], guess, params, device=dev, max_iter=iters,
                                    **align_kw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n = infos[0].iterations
    per_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            cnt, tot = per_name.get(e.name, (0, 0.0))
            per_name[e.name] = (cnt + 1, tot + us)
    busy_us = sum(t for _, t in per_name.values())
    launches = sum(c for c, _ in per_name.values())
    if not launches:
        log("profile: the profiler recorded no device activity (device time not measured)")
        return
    log(f"profile{label} ({n} iterations of one pair, profiler on): wall {wall_us / n:.1f} us/iter, "
        f"{launches / n:.1f} device kernels+copies/iter, device busy {busy_us / n:.1f} us/iter, "
        f"device idle share {1 - busy_us / wall_us:.4f}")
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (cnt, tot) in top:
        log(f"  {tot / n:8.2f} us/iter  {cnt / n:6.2f}/iter  {name[:90]}")


ACVO_PAIRS = 2               # timed pairs of the ACVO path (after one warm-up pair)
ACVO_GRID_ELL_MAX = 0.7      # ell_max of the extra ACVO frame: support 1.84 m, grid builder
ACVO_POSE_ERROR_BOUND = 0.05 # bench.py's bound
TOPK = 64                    # top_k of the association export (phase 7)
BA_FRAMES = 8                # frames of the IRLS bundle adjustment (phase 8)
BA_POINTS = 32768            # points per frame: the auto backend resolves to 'ell'
BA_ROT, BA_TRANS = 0.02, 0.1 # perturbation of the initial poses (rad, m)
BA_SELECT_K = (128, 192)     # select held against select_plain at P = 32 on one edge


def acvo_path(f2f, frames, T_true, guess, dev, smi, results):
    """Phase 6: the ACVO path (KITTI_GEOMETRIC_BENCH with is_ell_adaptive,
    auto backend: 'ell' with the scan builder, since the support at ell_max
    is 3.16 m) on bench pairs after one warm-up pair, then one more pair
    with ell_max 0.7 (support 1.84 m), where the grid builder runs select
    for the xy, xx and yy lists of every build. Per pair: wall ms,
    iterations, builds, final ell, pose error, host reads, launches;
    flow_reduce and step_cached must launch once per iteration, select three
    times per build on the grid pair and never on the scan pairs."""
    from unified_cvo_tpu_torch.config import KITTI_GEOMETRIC_BENCH
    from unified_cvo_tpu_torch.ops import lie

    acvo = KITTI_GEOMETRIC_BENCH.replace(is_ell_adaptive=1)
    t0 = time.perf_counter()
    f2f.run_sequence(frames[:2], guess, acvo, device=dev, max_iter=MAX_ITER)
    torch.cuda.synchronize()
    log(f"ACVO warm-up pair: {time.perf_counter() - t0:.2f} s")
    rows, g = [], guess
    plan = [(acvo, "scan")] * ACVO_PAIRS + [(acvo.replace(ell_max=ACVO_GRID_ELL_MAX), "grid")]
    for k, (params, builder) in enumerate(plan, start=1):
        reset_launch_counts()
        t0 = time.perf_counter()
        res, infos = f2f.run_sequence(frames[k:k + 2], g, params, device=dev,
                                      max_iter=MAX_ITER)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = launch_counts()
        info = infos[0]
        g = lie.rt_to_mat44(*lie.invert_rt(*lie.mat44_to_rt(res[0])))
        err = f2f.pose_errors(res, T_true[k:k + 1])[0]
        row = {"pair": k, "ell_max": params.ell_max, "builder": info.nl_builder, "ms": ms,
               "iterations": info.iterations, "builds": info.nl_rebuilds,
               "final_ell": float(info.final_ell), "pose_error": err,
               "host_reads": info.host_reads, "overflow": int(info.nl_overflow),
               "launches": {key: n[key] for key in ("select", "flow_reduce", "step_cached")}}
        rows.append(row)
        log(f"ACVO pair {k} (ell_max {params.ell_max}, {info.backend} + {info.nl_builder}): "
            f"{ms:.2f} ms, {info.iterations} iterations, {info.nl_rebuilds} builds, final ell "
            f"{float(info.final_ell):.6f}, pose error {err:.6f}, {info.host_reads} host reads, "
            f"overflow {int(info.nl_overflow)}, launches {row['launches']} ({smi})")
        want_select = 3 * info.nl_rebuilds if builder == "grid" else 0
        if not ((info.backend, info.nl_builder) == ("ell", builder)
                and n["flow_reduce"] == n["step_cached"] == info.iterations
                == info.host_reads
                and n["flow_reduce_by_variant"].get("geo") == info.iterations
                and n["select"] == want_select):
            raise SystemExit(f"ACVO pair {k}: {info.backend}/{info.nl_builder}, launches {n}, "
                             f"{info.iterations} iterations, {info.nl_rebuilds} builds")
        if not err < ACVO_POSE_ERROR_BOUND:
            raise SystemExit(f"ACVO pair {k}: pose error {err} is not below "
                             f"{ACVO_POSE_ERROR_BOUND}")
    for name in ("select", "flow_reduce", "step_cached"):
        results[name]["launches_acvo"] = [r["launches"][name] for r in rows]
    return rows


def topk_agree(vk, ik, vc, ic, what):
    """Top-k rows from the card against the same call on the CPU: values
    rtol 1e-5, dead entries alike, indices equal where a row's values are
    distinct (more than rtol 1e-5 from both neighbours), and equal as sets
    among the entries clearly above the row's last kept value."""
    vk, ik = vk.cpu(), ik.cpu()
    if not (torch.allclose(vk, vc, rtol=1e-5, atol=0)
            and torch.equal(ik < 0, ic < 0) and torch.equal(vk > 0, vc > 0)):
        raise SystemExit(f"{what}: values differ, max abs {float((vk - vc).abs().max())}")
    gap = 1e-5 * vc.abs()
    distinct = torch.ones_like(vc, dtype=torch.bool)
    distinct[:, 1:] &= (vc[:, 1:] - vc[:, :-1]).abs() > gap[:, 1:]
    distinct[:, :-1] &= (vc[:, :-1] - vc[:, 1:]).abs() > gap[:, :-1]
    if not torch.equal(ik[distinct], ic[distinct]):
        raise SystemExit(f"{what}: indices differ where values are distinct")
    above = vc > (vc[:, -1:] + gap[:, -1:])
    for r in torch.nonzero(torch.any(above, dim=1)).flatten().tolist():
        if set(ik[r][above[r]].tolist()) != set(ic[r][above[r]].tolist()):
            raise SystemExit(f"{what}: row {r} keeps other targets above its cut")
    return int(distinct.sum()), float((vk - vc).abs().max())


def event_ms(fn):
    """Device time of one call by CUDA events (after a warm-up call), and
    its result."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def analysis_phase(src_np, tgt_np, T_rel, guess_np, dev, smi):
    """Phase 7: the analysis entry points on a bench pair at the bench
    shapes: function_angle (approximate) at the guess's transform and at the
    main path's converged transform (it must grow), compute_association
    at top_k 64, and compute_association_non_isotropic with a diagonal 3x3
    kernel, each held against the same call on the CPU on the same inputs
    (values rtol 1e-5, indices where values are distinct, inlier masks
    equal) and timed by CUDA events."""
    from unified_cvo_tpu_torch.config import KITTI_GEOMETRIC_BENCH as params
    from unified_cvo_tpu_torch.models import (compute_association,
                                              compute_association_non_isotropic,
                                              function_angle)
    from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud

    cpu = torch.device("cpu")
    src = {d: make_pointcloud(src_np, bucket=N_POINTS, device=d) for d in (dev, cpu)}
    tgt = {d: make_pointcloud(tgt_np, bucket=N_POINTS, device=d) for d in (dev, cpu)}
    # the entry points move the target by the inverse of their transform,
    # and align's result maps target to source: pass the loop's pose, which
    # starts at the guess and ends at the inverse of the result
    at_guess = guess_np.astype(np.float32)
    converged = np.linalg.inv(T_rel.detach().cpu().numpy().astype(np.float64)).astype(np.float32)
    ell = params.ell_init
    K = np.diag([0.04, 0.04, 0.09]).astype(np.float32)
    calls = {
        "function_angle at the guess": lambda d: function_angle(
            src[d], tgt[d], at_guess, ell, params, device=d),
        "function_angle at the converged pose": lambda d: function_angle(
            src[d], tgt[d], converged, ell, params, device=d),
        "compute_association": lambda d: compute_association(
            src[d], tgt[d], converged, ell, params, top_k=TOPK, device=d),
        "compute_association_non_isotropic": lambda d: compute_association_non_isotropic(
            src[d], tgt[d], converged, K, params, top_k=TOPK, device=d),
    }
    out = {}
    for name, call in calls.items():
        ms, got = event_ms(lambda: call(dev))
        t0 = time.perf_counter()
        want = call(cpu)
        cpu_s = time.perf_counter() - t0
        if name.startswith("function_angle"):
            rel = abs(float(got) - float(want)) / abs(float(want))
            if not rel <= 1e-5:
                raise SystemExit(f"{name}: card {float(got)} against CPU {float(want)}")
            out[name] = float(got)
            log(f"{name}: {float(got):.6f} (CPU {float(want):.6f}, rel {rel:.3g}), card "
                f"{ms:.3f} ms (CUDA events), CPU {cpu_s:.1f} s ({smi})")
            continue
        vals, idx, s_in, t_in = got
        n_dist, v_err = topk_agree(vals, idx, want[0], want[1], name)
        if not (torch.equal(s_in.cpu(), want[2]) and torch.equal(t_in.cpu(), want[3])):
            raise SystemExit(f"{name}: inlier masks differ from the CPU's")
        out[name] = {"associations": int((vals > 0).sum()), "source_inliers": int(s_in.sum()),
                     "target_inliers": int(t_in.sum())}
        log(f"{name}: {out[name]}, values max abs {v_err:.3g} from the CPU's, {n_dist} "
            f"indices checked one by one, inlier masks equal; card {ms:.3f} ms (CUDA events), "
            f"CPU {cpu_s:.1f} s ({smi})")
    if not out["function_angle at the converged pose"] > out["function_angle at the guess"]:
        raise SystemExit(f"function_angle did not grow from the guess to the converged pose: "
                         f"{out}")
    return out


def _ba_exp(xi):
    from unified_cvo_tpu_torch.ops import lie

    R, t = lie.se3_exp(torch.from_numpy(np.asarray(xi, np.float32)), 1.0)
    return torch.cat([R, t[:, None]], 1).numpy()


def _compose(A, B):
    """[3, 4] poses: A . B."""
    return np.concatenate([A[:, :3] @ B[:, :3], (A[:, :3] @ B[:, 3:] + A[:, 3:])], 1)


def _bunnyish(rng, n=256):
    """test_irls.py's BA cloud: a unit sphere and a flat box."""
    sph = rng.normal(size=(n // 2, 3))
    sph /= np.linalg.norm(sph, axis=1, keepdims=True)
    box = rng.uniform(-1, 1, size=(n - n // 2, 3)) * np.array([1.5, 0.2, 1.0])
    return np.concatenate([sph, box]).astype(np.float32)


def ate(poses, true):
    """RMS of the frames' translation errors (m)."""
    return float(np.sqrt(np.mean([np.sum((p[:, 3] - t[:, 3]) ** 2)
                                  for p, t in zip(poses, true)])))


def irls_phase(f2f, dev, smi, results, floor):
    """Phase 8: multiframe IRLS BA. 8 frames of the bench scene at 32768
    points, chain and skip-one edges (13), pivot frame 0, initial poses the
    true ones moved by seeded twists of 0.02 rad and 0.1 m; the auto backend
    ('ell': select at K = 128, P = 32, skin 0, once per edge per outer
    iteration) on both engines, which must agree (rtol 1e-4, atol 1e-4) and
    lower the ATE. Then select against select_plain on one edge's grid
    inputs at K = 128 and 192, P = 32 (torch.equal, two launches
    bit-equal, timed beside its bound), the dense backend on 4 frames of
    4096 points, and block PCG against the dense solve on test_irls.py's
    120-frame chain."""
    from unified_cvo_tpu_torch.config import KITTI_GEOMETRIC_BENCH as params
    from unified_cvo_tpu_torch.models import irls
    from unified_cvo_tpu_torch.ops import neighbors as nbr
    from unified_cvo_tpu_torch.ops import select as sel
    from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud

    frames_np, T_true = f2f.make_sequence(BA_POINTS, BA_FRAMES - 1)
    true = [np.eye(3, 4, dtype=np.float32)]
    for T in T_true:                     # frame k+1 = T_k . frame k: pose_{k+1} = pose_k T_k^-1
        Ti = np.linalg.inv(np.asarray(T, np.float64))[:3].astype(np.float32)
        true.append(_compose(true[-1], Ti).astype(np.float32))
    rng = np.random.default_rng(8)
    init = [true[0]]
    for f in range(1, BA_FRAMES):
        w, v = rng.normal(size=3), rng.normal(size=3)
        xi = np.concatenate([BA_ROT * w / np.linalg.norm(w), BA_TRANS * v / np.linalg.norm(v)])
        init.append(_compose(_ba_exp(xi), true[f]).astype(np.float32))
    init = np.stack(init)
    edges = [(i, i + 1) for i in range(BA_FRAMES - 1)] + [(i, i + 2) for i in range(BA_FRAMES - 2)]
    piv = [True] + [False] * (BA_FRAMES - 1)
    clouds = irls.stack_clouds([make_pointcloud(f, bucket=BA_POINTS, device=dev)
                                for f in frames_np])
    backend = irls.resolve_irls_backend(params, BA_POINTS)
    if backend != "ell":
        raise SystemExit(f"IRLS auto backend at {BA_POINTS} points resolved to {backend}")
    out = {}
    for engine in ("device", "host", "device"):     # the first device solve warms up
        reset_launch_counts()
        t0 = time.perf_counter()
        poses, hist = irls.irls_solve(clouds, init, edges, piv, params, engine=engine,
                                      device=dev)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        out[engine] = (poses, hist, sec, sel.select.launches)
    poses_d, hist_d, sec_d, sel_d = out["device"]
    poses_h, hist_h, sec_h, sel_h = out["host"]
    outer = hist_d[0]["iter"]
    ate0, ate_d, ate_h = ate(init, true), ate(poses_d, true), ate(poses_h, true)
    log(f"IRLS BA ({BA_FRAMES} frames x {BA_POINTS} points, {len(edges)} edges, backend "
        f"{backend}): device engine {outer} outer iterations, {sec_d:.2f} s, "
        f"{1e3 * sec_d / outer:.2f} ms per outer iteration, {hist_d[0]['host_reads']} host "
        f"reads, overflow {hist_d[0]['overflow']}, select launches {sel_d}, final ell "
        f"{hist_d[0]['ell']:.6f}, nonzeros {hist_d[0]['nonzeros']} ({smi})")
    log(f"  host engine: {len(hist_h)} solves, last iteration {hist_h[-1]['iter'] if hist_h else None}, "
        f"{sec_h:.2f} s, select launches {sel_h}")
    log(f"  ATE before {ate0:.6f} m, after: device engine {ate_d:.6f} m, host engine "
        f"{ate_h:.6f} m; engines max abs {float(np.abs(poses_d - poses_h).max()):.3g}")
    if sel_d != len(edges) * outer:
        raise SystemExit(f"IRLS device engine: {sel_d} select launches for {outer} outer "
                         f"iterations of {len(edges)} edges")
    if not np.allclose(poses_d, poses_h, rtol=1e-4, atol=1e-4):
        raise SystemExit(f"IRLS engines disagree: max abs {float(np.abs(poses_d - poses_h).max())}")
    if not (ate_d < ate0 and ate_h < ate0 and np.array_equal(poses_d[0], init[0])):
        raise SystemExit(f"IRLS BA did not lower the ATE ({ate0} -> {ate_d}, {ate_h}) or moved "
                         f"the pivot")
    ba = {"frames": BA_FRAMES, "points": BA_POINTS, "edges": len(edges), "outer": outer,
          "s_device": sec_d, "ms_per_outer": 1e3 * sec_d / outer, "s_host": sec_h,
          "host_reads": hist_d[0]["host_reads"], "overflow": hist_d[0]["overflow"],
          "ate_before": ate0, "ate_after": ate_d, "select_launches": sel_d}

    # select at the BA's list shape, on edge (0, 1) at the initial poses
    c1 = irls._frame(clouds, 0).transformed(torch.from_numpy(init[0][:, :3]).to(dev),
                                            torch.from_numpy(init[0][:, 3]).to(dev))
    c2 = irls._frame(clouds, 1)
    R2, t2 = (torch.from_numpy(init[1][:, :3]).to(dev), torch.from_numpy(init[1][:, 3]).to(dev))
    ell = torch.full((), params.multiframe_ell_init, dtype=torch.float32, device=dev)
    P, dims = 32, nbr.GRID_DIMS
    g = nbr.grid_inputs(params, ell, c1, c2, R2, t2, skin=0.0, per_cell_cap=P)
    N = c1.capacity
    cid = sel.pool_cells(g.cbase, dims)
    touched = int(torch.unique(cid[cid < dims[0] * dims[1] * dims[2]]).numel())
    cands = int((g.tab[cid.long()][..., 3 * P:] >= 0).sum())
    for K in BA_SELECT_K:
        args = (g.tab, g.cbase, g.xr2, g.pose, K, P, dims)
        sel.select.launches = 0
        kept, live, binding = select_exact(sel, args, f"at the BA edge (0, 1), K = {K}, P = {P}")
        check_launches = sel.select.launches
        n_dev = kernels_per_call(lambda: sel.select(*args))
        if n_dev != 1:
            raise SystemExit(f"select at K = {K}: {n_dev} device kernels a call, not 1")
        ms, plain_ms = device_ms(lambda: sel.select(*args)), device_ms(lambda: sel.select_plain(*args))
        nbytes = touched * 4 * P * 4 + N * (16 + 12) + 48 + K * N * 4 + 3 * K * N * 4 + N * 4
        b_ms, b_by = bound(nbytes, SELECT_OPS_PER_CANDIDATE * cands)
        name = f"select (K={K}, P={P})"
        results[name] = {
            "name": name, "route": "cuda", "source": "unified_cvo_tpu_torch/csrc/select.cu",
            "replaces": "unified_cvo_tpu/ops/pallas_select.py:39 (_select_kernel)",
            "launches": sel_d if K == 128 else check_launches, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "launches_per_call": n_dev, "launch_floor_ms": floor,
            "launched_by": ("the IRLS BA path (phase 8, device engine)" if K == 128 else
                            "the phase 8 check only (JAX's ELL moments test runs K = 192)")}
        log(f"select @ BA edge (0, 1), K = {K}, P = {P} (pool 864, runtime P, direct stores): "
            f"equal to select_plain, two launches bit-equal; kept {kept}, live slots {live}, "
            f"rows with kept > K {binding}; kernel {ms:.4f} ms (launch floor {floor:.4f} ms), "
            f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), 1 device kernel a call")

    # the dense backend: 4 frames of 4096 points
    small = irls.stack_clouds([make_pointcloud(f[:4096], bucket=4096, device=dev)
                               for f in frames_np[:4]])
    t0 = time.perf_counter()
    poses_s, hist_s = irls.irls_solve(small, init[:4], [(0, 1), (1, 2), (2, 3), (0, 2), (1, 3)],
                                      piv[:4], params, backend="dense", device=dev)
    torch.cuda.synchronize()
    sec_s = time.perf_counter() - t0
    ate_s0, ate_s = ate(init[:4], true[:4]), ate(poses_s, true[:4])
    log(f"IRLS dense backend (4 frames x 4096 points, 5 edges): {hist_s[0]['iter']} outer "
        f"iterations, {sec_s:.2f} s, ATE {ate_s0:.6f} -> {ate_s:.6f} m")
    if not (np.all(np.isfinite(poses_s)) and np.array_equal(poses_s[0], init[0])):
        raise SystemExit("IRLS dense backend: non-finite poses or a moved pivot")

    # block PCG against the dense solve: test_irls.py's 120-frame chain
    rng = np.random.default_rng(0)
    base = _bunnyish(rng)
    F = 120
    pts, truth = [], []
    for f in range(F):
        xi = (0.015 * rng.normal(size=6)).astype(np.float32) * (0.0 if f == 0 else 1.0)
        T = _ba_exp(xi)
        truth.append(T)
        pts.append(((base - T[:, 3]) @ T[:, :3]).astype(np.float32))
    chain = irls.stack_clouds([make_pointcloud(x, bucket=256, device=dev) for x in pts])
    eye = np.tile(np.eye(3, 4, dtype=np.float32), (F, 1, 1))
    cedges = [(i, i + 1) for i in range(F - 1)] + [(i, i + 3) for i in range(F - 3)]
    short = params.replace(multiframe_max_iters=6, multiframe_iterations_per_ell=2,
                           multiframe_iterations_per_solve=3, sp_thres=0.002,
                           multiframe_ell_init=0.6, multiframe_ell_min=0.05,
                           multiframe_min_nonzeros=20)
    solved = {}
    for solver in ("dense", "cg"):
        t0 = time.perf_counter()
        solved[solver], _ = irls.irls_solve(chain, eye, cedges, [True] + [False] * (F - 1), short,
                                            chunk=256, engine="device", solver=solver,
                                            device=dev)
        torch.cuda.synchronize()
        solved[solver + "_s"] = time.perf_counter() - t0
    gap = float(np.abs(solved["cg"] - solved["dense"]).max())
    err0 = max(np.abs(eye[f] - truth[f]).max() for f in range(F))
    err1 = max(np.abs(solved["cg"][f] - truth[f]).max() for f in range(F))
    log(f"IRLS PCG against dense (120 frames, {len(cedges)} edges): max abs {gap:.3g} (atol "
        f"2e-4), error {err0:.4f} -> {err1:.4f}; dense {solved['dense_s']:.2f} s, PCG "
        f"{solved['cg_s']:.2f} s")
    if not (gap <= 2e-4 and err1 < 0.7 * err0):
        raise SystemExit(f"IRLS PCG: {gap} from the dense solve, error {err0} -> {err1}")
    return ba


# ---- phases 9-10: images to trajectory, the device frontends and drivers
STEREO_FRAMES = 5            # phase 9: rendered stereo frames (4 pairs)
RGBD_FRAMES = 5              # phase 10: rendered RGB-D frames (4 pairs)
# KITTI odometry sequence 00's left camera and stereo baseline, full width
KITTI00 = {"fx": 718.856, "cx": 607.1928, "cy": 185.2157, "baseline": 0.5372,
           "cols": 1241, "rows": 376}
# the TUM RGB-D camera the reference's calibration files give (fr1 defaults)
TUM_CAMERA = {"fx": 525.0, "cx": 319.5, "cy": 239.5, "depth_scale": 5000.0,
              "cols": 640, "rows": 480}
# Pairs that JAX's own frontend and driver, fed the same rendered frames with
# the same settings on the CPU, also end above the bench bound: the first
# stereo pair runs the first-frame schedule from the identity and stops at the
# cap at ell 0.33, mid-descent. Each entry: (JAX's pose error, the se(3) log
# of JAX's relative pose, {list builds: spread}). The spread is the farthest
# any CPU run of either package with that many builds ended from JAX's pose,
# the guess moved by +-1e-6 m or the source cloud by one ulp: last-bit
# changes move this pair by up to that much, and a change in whether the
# drift bound triggers one more build moves it further. From `JAX_PLATFORMS=cpu
# python tests/test_torch_odometry.py stereo --spread --port` (ROADMAP section
# 3). The card's run must make a number of builds seen there, and end within
# that number's spread of JAX's pose.
JAX_MISSES = {
    "phase 9": {0: (0.074307, (-1.614563080e-04, 9.696566500e-03, -7.273391238e-04,
                               4.112411290e-03, 3.883998143e-03, 2.759748101e-01),
                    {2: 8.49e-4, 3: 0.0167})},
    "phase 10": {}}
DISP_TOL = 1e-5              # disparity, card against CPU (abs; masks equal)
CLOUD_TOL = 1e-5             # cloud xyz (rtol and atol) and features (abs)
NLM_TOL = 1e-3               # NL-means output on the 0-255 scale (abs)


def _camera(Calibration, fx, cx, cy, cols, rows, **kw):
    K = np.array([[fx, 0.0, cx], [0.0, fx, cy], [0.0, 0.0, 1.0]], np.float32)
    return Calibration(K, cols=cols, rows=rows, **kw)


def dso_cells(image, capacity):
    """The DSO selection of an image, from its grey level on."""
    from unified_cvo_tpu_torch.frontend import device as fe

    gs = fe.device_gray_and_gradients(image)[2]
    return fe.dso_select_device(gs, fe.dso_block_thresholds(gs), 3, capacity)


def stereo_frames():
    """KITTI seq-00's camera, scripts/bench_driver.py's scene and step:
    (calibration, [(left BGR, right BGR)], camera-to-world poses)."""
    from unified_cvo_tpu_torch.frontend.calibration import Calibration
    from unified_cvo_tpu_torch.utils import synth

    calib = _camera(Calibration, **KITTI00)
    scene = synth.corridor_scene(seed=3)
    traj = synth.corridor_trajectory(STEREO_FRAMES, step=0.35)
    return calib, [synth.render_stereo(scene, calib, T)[:2] for T in traj], traj


def rgbd_frames():
    """The TUM camera in the TUM fixture's corridor (test_e2e_accuracy.py),
    depth quantised to uint16 at depth_scale; a depth past the uint16
    range (13.1 m at depth_scale 5000) is 0, no measurement, as a TUM depth
    map marks it (clipped, it would be a false wall at 13.1 m):
    (calibration, [(BGR, depth, timestamp)], poses)."""
    from unified_cvo_tpu_torch.frontend.calibration import Calibration
    from unified_cvo_tpu_torch.utils import synth

    calib = _camera(Calibration, **TUM_CAMERA)
    scene = synth.corridor_scene(5, half_width=2.5, floor_y=1.2, ceil_y=-1.2, length=30.0)
    traj = synth.corridor_trajectory(RGBD_FRAMES, step=0.08, yaw_rate=0.015, bob=0.005)
    frames = []
    for i, T in enumerate(traj):
        bgr, depth = synth.render_frame(scene, calib, T)
        q = depth * calib.depth_scale
        d16 = np.where((q > 0) & (q <= 65535), q, 0).astype(np.uint16)
        frames.append((bgr, d16, f"{1000.0 + 0.1 * i:.4f}"))
    return calib, frames, traj


def profiled(fn):
    """(device kernels and copies, device busy ms) of one call of fn after a
    warm-up call, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n, busy_us = 0, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n += 1
            busy_us += e.time_range.elapsed_us()
    return n, busy_us / 1e3


def stage_times(stages, smi):
    """Card ms (CUDA events, one call after a warm-up) and launches per call
    (torch.profiler) of each frontend stage."""
    out = {}
    for name, fn in stages.items():
        ms, _ = event_ms(fn)
        n, busy = profiled(fn)
        out[name] = {"ms": ms, "launches": n, "device_busy_ms": busy}
        log(f"  {name}: {ms:.2f} ms (CUDA events), {n} device kernels+copies a call, "
            f"device busy {busy:.2f} ms ({smi})" if n else
            f"  {name}: {ms:.2f} ms (CUDA events), launches not measured (the profiler "
            f"recorded no device activity) ({smi})")
    return out


def clouds_agree(pk, pc, what):
    """A cloud from the card against the same call on the CPU: masks equal,
    xyz rtol/atol 1e-5, features abs 1e-5. Returns the largest xyz error."""
    pk = pk.to("cpu")
    if not torch.equal(pk.mask, pc.mask):
        raise SystemExit(f"{what}: masks differ in {int((pk.mask != pc.mask).sum())} slots")
    if not (torch.allclose(pk.xyz, pc.xyz, rtol=CLOUD_TOL, atol=CLOUD_TOL)
            and torch.allclose(pk.features, pc.features, rtol=0, atol=CLOUD_TOL)):
        raise SystemExit(f"{what}: xyz or features differ, max abs "
                         f"{float((pk.xyz - pc.xyz).abs().max())} / "
                         f"{float((pk.features - pc.features).abs().max())}")
    return float((pk.xyz - pc.xyz).abs().max())


def selection_agrees(gs, dev, capacity, what):
    """Block thresholds and DSO selection on the card against the CPU on the
    same gradients: thresholds equal, uv and valid equal, slot order included."""
    from unified_cvo_tpu_torch.frontend import device as fe

    ths = fe.dso_block_thresholds(gs)
    ths_k = fe.dso_block_thresholds(gs.to(dev))
    uv, valid = fe.dso_select_device(gs, ths, 3, capacity)
    uv_k, valid_k = fe.dso_select_device(gs.to(dev), ths_k, 3, capacity)
    if not (torch.equal(ths_k.cpu(), ths) and torch.equal(uv_k.cpu(), uv)
            and torch.equal(valid_k.cpu(), valid)):
        raise SystemExit(f"{what}: the DSO selection on the card differs from the CPU's")
    return int(valid.sum())


def driver_kernel_checks(src, tgt, T_rel, params, dev, results, what):
    """select, flow_reduce (geometry x channel) and step_cached against their
    plain versions on a driver's own clouds: frames 0 and 1 from the device
    frontend at the driver's capacity, most slots masked, the list built as
    align builds it (grid builder, K = 32), at the first pair's start (the
    identity, the first-frame ell) and at the rendered relative pose (the
    preset's ell). select output for output (select_exact); flow_agree;
    step_agree on the step in the loop's form (the flow's twist on the
    device) and on the host-built block. Folds the errors into the kernels'
    max_abs_err; raises SystemExit on a disagreement."""
    from unified_cvo_tpu_torch.ops import ell as ell_ops
    from unified_cvo_tpu_torch.ops import lie
    from unified_cvo_tpu_torch.ops import neighbors as nbr
    from unified_cvo_tpu_torch.ops import select as sel

    K, P, dims = nbr.DEFAULT_K, nbr.PER_CELL_CAP, nbr.GRID_DIMS
    use_geo = bool(params.is_using_geometry)
    masked = int((src.mask == 0).sum())
    for label, p, T in (("identity, first-frame ell", params.first_frame(), np.eye(4)),
                        ("rendered relative pose", params, T_rel)):
        Tk = torch.from_numpy(np.asarray(T, np.float32)).to(dev)
        Rinv, Tinv = lie.invert_rt(Tk[:3, :3], Tk[:3, 3])
        ell = torch.full((), p.ell_init, dtype=torch.float32, device=dev)
        at = f"{what}, {label}"
        g = nbr.grid_inputs(p, ell, src, tgt, Rinv, Tinv)
        kept, live, binding = select_exact(sel, (g.tab, g.cbase, g.xr2, g.pose, K, P, dims), at)
        nl = nbr.build_neighbor_list(p, ell, src, tgt, Rinv, Tinv)
        v = ell_ops.variant(nl.chan, use_geo)
        if v != "geo_chan":
            raise SystemExit(f"{at}: the list runs the {v} variant, not geo_chan")
        xp = ell_ops.pack_x(p, ell, src)
        scal = ell_ops.pack_scalars(p, Rinv, Tinv)
        ch = dict(chan=nl.chan, use_geometry=use_geo)
        fk = ell_ops.flow_reduce(xp, nl.y_xyz, scal, p.c, p.d, **ch)
        fp = ell_ops.flow_reduce_plain(xp, nl.y_xyz, scal, p.c, p.d, **ch)
        torch.cuda.synchronize()
        a_rel, A_err, tw_err, _ = flow_agree(fk, fp, f"({v}) at {at}")
        scal_t = ell_ops.pack_scalars(p, Rinv, Tinv, fp[0])
        steps = [(ell_ops.step_cached(xp, nl.y_xyz, fp[4], scal, twist=fp[0]),
                  ell_ops.step_cached_plain(xp, nl.y_xyz, fp[4], scal, twist=fp[0]),
                  f"with the twist on the device at {at}"),
                 (ell_ops.step_cached(xp, nl.y_xyz, fp[4], scal_t),
                  ell_ops.step_cached_plain(xp, nl.y_xyz, fp[4], scal_t), f"at {at}")]
        s_err = max(step_agree(*st) for st in steps)
        s_rel = max(float(torch.max(torch.abs(bk - bp) / torch.abs(bp).clamp_min(1e-30)))
                    for bk, bp, _ in steps)
        results["flow_reduce"]["max_abs_err"] = max(results["flow_reduce"]["max_abs_err"],
                                                    A_err, tw_err)
        results["step_cached"]["max_abs_err"] = max(results["step_cached"]["max_abs_err"], s_err)
        log(f"kernels @ {at}: N {src.capacity}, {masked} masked source rows; select equal to "
            f"select_plain, two launches bit-equal (kept {kept}, live slots {live}, rows with "
            f"kept > K {binding}); flow_reduce ({v}) nonzeros {int(fk[2])} (exact), a_sum rel "
            f"{a_rel:.3g}, A abs {A_err:.3g}, twist abs {tw_err:.3g}; step_cached within "
            f"tolerance in both forms (max abs {s_err:.3g}, rel {s_rel:.3g})")


def jax_gap(xi, T):
    """|log(exp(xi)^-1 T)|: how far the transform T lies from JAX's."""
    from unified_cvo_tpu_torch.ops import lie

    R, t = lie.se3_exp(torch.tensor(xi, dtype=torch.float64), 1.0)
    E = np.linalg.inv(lie.rt_to_mat44(R, t).numpy()) @ T
    return float(torch.linalg.vector_norm(lie.se3_log(torch.from_numpy(E[:3, :3]),
                                                      torch.from_numpy(E[:3, 3]))))


def driver_report(phase, label, poses, traj, records, seconds, launches, smi):
    """Pose errors against the rendered trajectory, ATE and RPE, align ms,
    iterations and builds per pair, fps; raises unless every pair is below
    the bench bound (or, on a pair of JAX_MISSES, within the CPU runs' spread
    of JAX's pose for its number of builds) and every align kernel went
    through the path."""
    from unified_cvo_tpu_torch.apps import f2f_sequence as f2f
    from unified_cvo_tpu_torch.utils import metrics

    n = len(records)
    rel = [np.linalg.inv(poses[k]) @ poses[k + 1] for k in range(n)]
    true = [np.linalg.inv(traj[k + 1]) @ traj[k] for k in range(n)]
    errs = f2f.pose_errors(rel, true)
    iters = [r.info.iterations for r in records]
    builds = [r.info.nl_rebuilds for r in records]
    row = {"pairs": n, "seconds": seconds, "fps": n / seconds,
           "align_ms": [1e3 * r.wait_seconds for r in records],
           "frontend_enqueue_ms": [1e3 * r.frontend_seconds for r in records],
           "iterations": iters, "builds": builds,
           "final_ell": [float(r.info.final_ell) for r in records],
           "host_reads": [r.info.host_reads for r in records],
           "overflow": [int(r.info.nl_overflow) for r in records],
           "pose_errors": errs,
           "ate_m": metrics.ate_rmse(traj[:len(poses)], poses),
           "rpe_m": metrics.rpe_rmse(traj[:len(poses)], poses),
           "launches": {k: launches[k] for k in ("select", "flow_reduce", "step_cached")},
           "backend": sorted({(r.info.backend, r.info.nl_builder) for r in records})}
    log(f"{label}: {n} pairs in {seconds:.3f} s, {n / seconds:.4f} aligned frames/s "
        f"(driver, frontend included) ({smi})")
    log(f"  align ms/pair {[round(x, 2) for x in row['align_ms']]}, iterations {iters}, "
        f"final ell {[round(x, 6) for x in row['final_ell']]}, builds {builds}, host reads "
        f"{row['host_reads']}, overflow {row['overflow']}, backend {row['backend']}")
    log(f"  pose error |xi| per pair {[round(e, 6) for e in errs]}; trajectory ATE "
        f"{row['ate_m']:.6f} m, RPE {row['rpe_m']:.6f} m")
    log(f"  launches {launches}")
    if not all(r.ret == 0 and (r.info.backend, r.info.nl_builder) == ("ell", "grid")
               for r in records):
        raise SystemExit(f"{label}: a pair did not run 'ell' with the grid builder, or "
                         f"its flow was degenerate")
    if not (launches["select"] >= sum(builds) > 0
            and launches["flow_reduce_by_variant"].get("geo_chan") == launches["flow_reduce"]
            == launches["step_cached"] == sum(iters)):
        raise SystemExit(f"{label}: launch counts {launches} do not match {sum(builds)} "
                         f"builds and {sum(iters)} iterations")
    row["jax_misses"] = {}
    for k, err in enumerate(errs):
        if err < f2f.POSE_ERROR_BOUND:
            continue
        if k not in JAX_MISSES[phase]:
            raise SystemExit(f"{label}: pair {k}'s pose error {err} is not below "
                             f"{f2f.POSE_ERROR_BOUND}")
        jax_err, xi, spreads = JAX_MISSES[phase][k]
        gap = jax_gap(xi, rel[k])
        spread = spreads.get(builds[k])
        row["jax_misses"][k] = {"jax_pose_error": jax_err, "pose_error": err, "gap": gap,
                                "builds": builds[k], "spread": spread}
        log(f"  pair {k}: pose error {err:.6f} is above {f2f.POSE_ERROR_BOUND} as JAX's "
            f"({jax_err:.6f} on the same frames, CPU); the poses lie {gap:.3g} apart, "
            f"{builds[k]} builds, whose last-bit spread on the CPU is {spread}")
        if spread is None or not gap <= spread:
            raise SystemExit(f"{label}: pair {k} ends {gap} from JAX's pose after {builds[k]} "
                             f"builds, not within the spread that CPU runs with as many "
                             f"builds show ({spreads})")
    return row


def stereo_phase(dev, smi, results):
    """Phase 9: the KITTI stereo path at full width, images to trajectory on
    the card. Frame 0's frontend on the card is held against the port's call
    on the CPU (disparity: masks equal, abs 1e-5; block thresholds and
    selection equal, slot order included; the cloud: masks equal, xyz
    rtol/atol 1e-5, features abs 1e-5); each stage is timed by CUDA events
    and its launches counted; then kitti_odometry.run_frames registers the
    4 pairs (KITTI_COLOR_BENCH, bench.py's 1500-iteration cap, capacity
    32768, max_disp by the width rule: 128) and every pair must end below
    the bench bound with select, flow_reduce and step_cached launched. Those
    three kernels are first held against their plain versions on the
    driver's clouds of frames 0 and 1 (driver_kernel_checks)."""
    from unified_cvo_tpu_torch.apps import kitti_odometry
    from unified_cvo_tpu_torch.config import KITTI_COLOR_BENCH
    from unified_cvo_tpu_torch.frontend import device as fe
    from unified_cvo_tpu_torch.ops import sgm

    t0 = time.perf_counter()
    calib, frames, traj = stereo_frames()
    log(f"phase 9: {len(frames)} stereo frames rendered at {calib.cols} x {calib.rows} "
        f"in {time.perf_counter() - t0:.2f} s (host)")
    cap, md = kitti_odometry.CAPACITY, kitti_odometry.max_disp_for(calib.cols)
    cpu = torch.device("cpu")
    left, right = frames[0]
    gray_l, _, gs = fe.device_gray_and_gradients(torch.from_numpy(left))
    gray_r = fe.device_gray_and_gradients(torch.from_numpy(right))[0]
    t0 = time.perf_counter()
    disp = sgm.sgm_disparity_device(gray_l, gray_r, max_disp=md)
    cpu_s = time.perf_counter() - t0
    gl_k, gr_k = gray_l.to(dev), gray_r.to(dev)
    disp_k = sgm.sgm_disparity_device(gl_k, gr_k, max_disp=md).cpu()
    if not (torch.equal(disp_k > 0, disp > 0)
            and float((disp_k - disp).abs().max()) <= DISP_TOL):
        raise SystemExit(f"phase 9: the disparity on the card differs from the CPU's, max abs "
                         f"{float((disp_k - disp).abs().max())}, "
                         f"{int(((disp_k > 0) != (disp > 0)).sum())} masks differ")
    n_sel = selection_agrees(gs, dev, cap, "phase 9")

    def cloud(d, pair=frames[0]):
        return fe.device_pointcloud_from_stereo(*pair, calib, capacity=cap, max_disp=md,
                                                device=d)

    xyz_err = clouds_agree(cloud(dev), cloud(cpu), "phase 9 cloud")
    clouds = [cloud(dev, pair) for pair in frames]
    valid = [int(c.mask.sum()) for c in clouds]
    driver_kernel_checks(clouds[0], clouds[1], np.linalg.inv(traj[0]) @ traj[1],
                         KITTI_COLOR_BENCH, dev, results, "phase 9 frames 0 -> 1")
    del clouds
    log(f"phase 9 frontend, card against CPU on frame 0: disparity masks equal "
        f"({float((disp > 0).float().mean()):.4f} valid), abs {float((disp_k - disp).abs().max())}"
        f" (CPU SGM {cpu_s:.1f} s); selection equal ({n_sel} cells); cloud masks equal, xyz "
        f"max abs {xyz_err:.3g}")
    log(f"  valid points per frame {valid} of {cap}")
    lk = torch.from_numpy(left).to(dev)
    cost = sgm._cost_volume(sgm.census_5x5(gl_k), sgm.census_5x5(gr_k), md)
    stages = stage_times({
        "frontend (device_pointcloud_from_stereo, upload included)": lambda: cloud(dev),
        "SGM (sgm_disparity_device)": lambda: sgm.sgm_disparity_device(gl_k, gr_k, max_disp=md),
        "SGM scans (_aggregate)": lambda: sgm._aggregate(cost, md, 10, 120),
        "DSO selection (gray, gradients, thresholds, select)": lambda: dso_cells(lk, cap),
    }, smi)
    del cost

    reset_launch_counts()
    t0 = time.perf_counter()
    poses, records = kitti_odometry.run_frames(
        frames, calib, KITTI_COLOR_BENCH, capacity=cap, max_iter=MAX_ITER, frontend="device",
        device=dev, log=lambda *a: None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    out = driver_report("phase 9", "phase 9 KITTI stereo driver (kitti_odometry.run_frames, "
                        "--device-frontend)", poses, traj, records, seconds, launches, smi)
    out.update(valid_points=valid, frontend=stages, cpu_sgm_s=cpu_s,
               frontend_checks={"disparity_max_abs": float((disp_k - disp).abs().max()),
                                "selected_cells": n_sel, "cloud_xyz_max_abs": xyz_err})
    for name in ("select", "flow_reduce", "step_cached"):
        results[name]["launches_kitti_stereo"] = launches[name]
    return out


def rgbd_phase(dev, smi, results):
    """Phase 10: the TUM RGB-D path at 640 x 480 with NL-means, images to
    trajectory on the card. On frame 0: NL-means on the card against the
    CPU (abs 1e-3 on the 0-255 scale); then the rest of the chain on the
    card's denoised image, on the card and on the CPU (thresholds and
    selection equal, slot order included; cloud masks equal, xyz rtol/atol
    1e-5). The whole entry point with NL-means is compared too, and the
    slots where its two clouds differ are printed: NL-means' last bits
    differ between the devices, and the fixed-point grey level floors
    them. Then tum_odometry.run_frames registers the 4 pairs
    (KITTI_COLOR_BENCH, the 1500-iteration cap, capacity 16384,
    denoise=True) under the same bound and launch checks as phase 9, after
    the same kernel checks on its clouds of frames 0 and 1."""
    from unified_cvo_tpu_torch.apps import tum_odometry
    from unified_cvo_tpu_torch.config import KITTI_COLOR_BENCH
    from unified_cvo_tpu_torch.frontend import device as fe
    from unified_cvo_tpu_torch.ops import nlm

    t0 = time.perf_counter()
    calib, frames, traj = rgbd_frames()
    log(f"phase 10: {len(frames)} RGB-D frames rendered at {calib.cols} x {calib.rows} in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    cap = tum_odometry.CAPACITY
    cpu = torch.device("cpu")
    bgr, depth, _ = frames[0]
    img = torch.from_numpy(bgr).to(torch.float32)
    t0 = time.perf_counter()
    dn = nlm.nlm_denoise(img)
    cpu_s = time.perf_counter() - t0
    dn_k = nlm.nlm_denoise(img.to(dev))
    nlm_err = float((dn_k.cpu() - dn).abs().max())
    if not nlm_err <= NLM_TOL:
        raise SystemExit(f"phase 10: NL-means on the card differs from the CPU's by {nlm_err}")
    dn_host = dn_k.cpu()
    n_sel = selection_agrees(fe.device_gray_and_gradients(dn_host)[2], dev, cap, "phase 10")

    def cloud(d, image, denoise, dmap=depth):
        return fe.device_pointcloud_from_rgbd(image, dmap, calib, capacity=cap,
                                              denoise=denoise, device=d)

    xyz_err = clouds_agree(cloud(dev, dn_host, False), cloud(cpu, dn_host, False),
                           "phase 10 cloud on the card's denoised image")
    whole_k, whole_c = cloud(dev, bgr, True).to("cpu"), cloud(cpu, bgr, True)
    differ = int((whole_k.mask != whole_c.mask).sum()
                 + ((whole_k.mask == whole_c.mask) & (whole_k.mask > 0)
                    & ~torch.isclose(whole_k.xyz, whole_c.xyz, rtol=CLOUD_TOL,
                                     atol=CLOUD_TOL).all(1)).sum())
    clouds = [cloud(dev, f[0], True, f[1]) for f in frames]
    valid = [int(c.mask.sum()) for c in clouds]
    driver_kernel_checks(clouds[0], clouds[1], np.linalg.inv(traj[0]) @ traj[1],
                         KITTI_COLOR_BENCH, dev, results, "phase 10 frames 0 -> 1")
    del clouds
    log(f"phase 10 frontend, card against CPU on frame 0: NL-means max abs {nlm_err:.3g} "
        f"(CPU {cpu_s:.1f} s); on the card's denoised image selection equal ({n_sel} cells), "
        f"cloud masks equal, xyz max abs {xyz_err:.3g}; the whole entry point with NL-means "
        f"on each device: {differ} of {cap} slots differ")
    log(f"  valid points per frame {valid} of {cap}")
    img_k = img.to(dev)
    stages = stage_times({
        "frontend (device_pointcloud_from_rgbd, NL-means, upload included)":
            lambda: cloud(dev, bgr, True),
        "NL-means (nlm_denoise)": lambda: nlm.nlm_denoise(img_k),
        "DSO selection (gray, gradients, thresholds, select)": lambda: dso_cells(dn_k, cap),
    }, smi)

    reset_launch_counts()
    t0 = time.perf_counter()
    poses, _, records = tum_odometry.run_frames(
        frames, calib, KITTI_COLOR_BENCH, capacity=cap, max_iter=MAX_ITER, denoise=True,
        device_frontend=True, device=dev, log=lambda *a: None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    out = driver_report("phase 10", "phase 10 TUM RGB-D driver (tum_odometry.run_frames, "
                        "--device-frontend, NL-means)", poses, traj, records, seconds,
                        launches, smi)
    out.update(valid_points=valid, frontend=stages, cpu_nlm_s=cpu_s,
               frontend_checks={"nlm_max_abs": nlm_err, "selected_cells": n_sel,
                                "cloud_xyz_max_abs": xyz_err,
                                "whole_entry_point_slots_differing": differ})
    for name in ("select", "flow_reduce", "step_cached"):
        results[name]["launches_tum_rgbd"] = launches[name]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=8,
                    help="timed frame pairs of the main path (after one warm-up pair)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--dense-ablation", action="store_true",
                      help="build, check and time the dense kernels and their measurement "
                           "builds (phases 1 and 2b only), then stop without a result line")
    mode.add_argument("--select-ablation", action="store_true",
                      help="build, check and time the select kernel and its measurement "
                           "builds (after phase 1), then stop without a result line")
    mode.add_argument("--kernel-times", metavar="TREE",
                      help="check and time select and flow_rows of the package in TREE at "
                           "the bench shapes (after phase 1), print one JSON line, stop")
    mode.add_argument("--compare-tree", metavar="DIR",
                      help="--kernel-times of DIR and of this tree in turns (DIR, this, "
                           "this, DIR), each in a process of its own, then stop")
    mode.add_argument("--ell-ablation", action="store_true",
                      help="build, check and time the ELL consume kernels and their "
                           "measurement builds (after phase 1), then stop without a "
                           "result line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.compare_tree:
        compare_trees(args.compare_tree, args.frames)
        return 0
    if args.kernel_times:                    # this package: the one found first on the path
        sys.path.insert(0, args.kernel_times)
    if args.frames < 8:
        print("chip_smoke: the main path needs at least 8 timed frames", file=sys.stderr)
        return 2

    from unified_cvo_tpu_torch.apps import f2f_sequence as f2f
    from unified_cvo_tpu_torch.config import KITTI_COLOR_BENCH
    from unified_cvo_tpu_torch.config import KITTI_GEOMETRIC_BENCH as params
    from unified_cvo_tpu_torch.ops import cuda_lib
    from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud

    # ---- phase 1: card, versions, build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    reports = cuda_lib.build_all()
    for name in cuda_lib.SOURCES:
        cuda_lib.load(name)
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(reports)} (nvcc, in parallel)")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {name}.cu: {line.strip()}")
            elif "Compiling entry function" in line:
                log(f"  {name}.cu: {line.split("'")[1]}")

    dev = torch.device("cuda")
    frames_np, T_true, feats = f2f.make_sequence(N_POINTS, args.frames + 1, features=True)
    guess_np = f2f.initial_guess()

    # ---- phase 2: each kernel against its plain version at bench shapes
    results = {}
    floor = launch_floor_ms()
    log(f"launch floor: {floor:.4f} ms per empty kernel, back to back")
    if args.dense_ablation:
        check_dense_kernels(frames_np, feats, guess_np, dev, results, ablation=True)
        return 0
    if args.kernel_times:
        kernel_times(frames_np, feats, guess_np, dev, floor)
        return 0
    if args.select_ablation:
        select_ablation(frames_np, guess_np, params, dev, floor)
        return 0
    if args.ell_ablation:
        ell_ablation(frames_np, feats, guess_np, dev, floor)
        pose_error_witness(frames_np, T_true, guess_np, dev)
        return 0
    check_kernels(frames_np, guess_np, params, dev, results, floor)
    t0 = time.perf_counter()
    check_dense_kernels(frames_np, feats, guess_np, dev, results)
    log(f"phase 2b (dense kernel checks and timings): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    check_ell_channel_kernels(frames_np, feats, guess_np, dev, results, floor)
    log(f"phase 2c (ELL kernel variants, checks and timings): {time.perf_counter() - t0:.2f} s")

    # ---- phase 3: the main path
    frames = [make_pointcloud(f, bucket=N_POINTS, device=dev) for f in frames_np]
    guess = torch.from_numpy(guess_np).to(dev)
    t0 = time.perf_counter()
    f2f.run_sequence(frames[:2], guess, params, device=dev, max_iter=MAX_ITER)
    torch.cuda.synchronize()
    log(f"warm-up pair: {time.perf_counter() - t0:.2f} s")
    reset_launch_counts()
    t0 = time.perf_counter()
    res, infos = f2f.run_sequence(frames[1:], guess, params, device=dev,
                                  max_iter=MAX_ITER)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    errs = f2f.pose_errors(res, T_true[1:])
    main_pair = res[0]                       # frames 1 -> 2, for phase 7
    iters = [i.iterations for i in infos]
    builds = [i.nl_rebuilds for i in infos]
    reads = [i.host_reads for i in infos]
    n = len(res)
    log(f"main path: {n} frames, {1e3 * seconds / n:.2f} ms/frame, "
        f"{n / seconds:.3f} fps ({smi})")
    log(f"  iterations/frame {iters}, builds/frame {builds}, host reads/frame {reads}, "
        f"overflow/frame {[int(i.nl_overflow) for i in infos]}")
    log(f"  pose error |xi| max {max(errs):.6f} mean {sum(errs) / n:.6f}")
    if not max(errs) < f2f.POSE_ERROR_BOUND:
        raise SystemExit(f"pose error {max(errs)} is not below {f2f.POSE_ERROR_BOUND}")

    # ---- phase 4: the kernels went through the main path
    if not (launches["select"] >= sum(builds)
            and launches["flow_reduce_by_variant"]["geo"] == launches["flow_reduce"]
            == launches["step_cached"] == sum(iters)):
        raise SystemExit(f"launch counts {launches} do not match {sum(builds)} builds "
                         f"and {sum(iters)} iterations")
    for name in ("select", "flow_reduce", "step_cached"):
        results[name]["launches"] = launches[name]

    # ---- phase 3b: the dense path, colour sequence on backend 'pallas'
    t_dense = time.perf_counter()
    cframes = [make_pointcloud(f, features=feats, bucket=N_POINTS, device=dev)
               for f in frames_np[:DENSE_PAIRS + 2]]
    t0 = time.perf_counter()
    f2f.run_sequence(cframes[:2], guess, KITTI_COLOR_BENCH, device=dev,
                     backend="pallas", max_iter=MAX_ITER)
    torch.cuda.synchronize()
    log(f"dense warm-up pair: {time.perf_counter() - t0:.2f} s")
    reset_launch_counts()
    t0 = time.perf_counter()
    res, infos = f2f.run_sequence(cframes[1:], guess, KITTI_COLOR_BENCH, device=dev,
                                  backend="pallas", max_iter=MAX_ITER)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    dlaunches = launch_counts()
    errs = f2f.pose_errors(res, T_true[1:DENSE_PAIRS + 1])
    iters = [i.iterations for i in infos]
    n = len(res)
    log(f"dense path (KITTI_COLOR_BENCH, backend pallas): {n} frames, "
        f"{1e3 * seconds / n:.2f} ms/frame, {n / seconds:.3f} fps, "
        f"{1e3 * seconds / sum(iters):.3f} ms/iteration ({smi})")
    log(f"  iterations/frame {iters}, host reads/frame {[i.host_reads for i in infos]}, "
        f"nonzeros/frame {[int(i.nonzeros) for i in infos]}")
    log(f"  pose error |xi| max {max(errs):.6f} mean {sum(errs) / n:.6f}")
    if not max(errs) < f2f.POSE_ERROR_BOUND:
        raise SystemExit(f"dense path pose error {max(errs)} is not below "
                         f"{f2f.POSE_ERROR_BOUND}")

    # ---- phase 4b: the dense kernels went through the dense path
    if not (dlaunches["dense_flow"] == dlaunches["dense_step"] == sum(iters)):
        raise SystemExit(f"dense launch counts {dlaunches} do not match "
                         f"{sum(iters)} iterations")
    for name in ("dense_flow", "dense_step"):
        results[name]["launches"] = dlaunches[name]
    log(f"phases 3b-4b (dense path, warm-up included): {time.perf_counter() - t_dense:.2f} s")

    # ---- phase 3c: colour on the ELL path (the default backend)
    t_col = time.perf_counter()
    t0 = time.perf_counter()
    f2f.run_sequence(cframes[:2], guess, KITTI_COLOR_BENCH, device=dev, max_iter=MAX_ITER)
    torch.cuda.synchronize()
    log(f"colour ELL warm-up pair: {time.perf_counter() - t0:.2f} s")
    reset_launch_counts()
    t0 = time.perf_counter()
    res, infos = f2f.run_sequence(cframes[1:COLOUR_PAIRS + 2], guess, KITTI_COLOR_BENCH,
                                  device=dev, max_iter=MAX_ITER)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    claunches = launch_counts()
    errs = f2f.pose_errors(res, T_true[1:COLOUR_PAIRS + 1])
    iters = [i.iterations for i in infos]
    builds = [i.nl_rebuilds for i in infos]
    n = len(res)
    log(f"colour ELL path (KITTI_COLOR_BENCH, default backend -> "
        f"{sorted({(i.backend, i.nl_builder) for i in infos})}): {n} frames, "
        f"{1e3 * seconds / n:.2f} ms/frame, {n / seconds:.3f} fps, "
        f"{1e3 * seconds / sum(iters):.3f} ms/iteration ({smi})")
    log(f"  iterations/frame {iters}, builds/frame {builds}, host reads/frame "
        f"{[i.host_reads for i in infos]}, overflow/frame {[int(i.nl_overflow) for i in infos]}")
    log(f"  pose error |xi| max {max(errs):.6f} mean {sum(errs) / n:.6f}")
    log(f"  launches {claunches}")
    if not all((i.backend, i.nl_builder) == ("ell", "grid") for i in infos):
        raise SystemExit("the colour workload did not resolve to 'ell' with the grid builder")
    if not max(errs) < f2f.POSE_ERROR_BOUND:
        raise SystemExit(f"colour ELL pose error {max(errs)} is not below "
                         f"{f2f.POSE_ERROR_BOUND}")
    if not (claunches["select"] >= sum(builds)
            and claunches["flow_reduce_by_variant"]["geo_chan"] == claunches["flow_reduce"]
            == claunches["step_cached"] == sum(iters)):
        raise SystemExit(f"colour ELL launch counts {claunches} do not match {sum(builds)} "
                         f"builds and {sum(iters)} iterations")
    log(f"phase 3c (colour ELL path, warm-up included): {time.perf_counter() - t_col:.2f} s")

    # ---- phase 3d: channel only (no geometry): one scan build, short
    chan_only = KITTI_COLOR_BENCH.replace(is_using_geometry=0)
    reset_launch_counts()
    t0 = time.perf_counter()
    res, infos = f2f.run_sequence(cframes[:2], guess, chan_only, device=dev,
                                  max_iter=CHAN_ONLY_ITER)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    olaunches = launch_counts()
    info = infos[0]
    err = f2f.pose_errors(res, T_true[:1])[0]
    log(f"channel-only pair (KITTI_COLOR_BENCH, is_using_geometry=0): {info.backend} + "
        f"{info.nl_builder} builder, {info.iterations} iterations, {info.nl_rebuilds} "
        f"build(s), {info.host_reads} host reads, overflow {int(info.nl_overflow)}, "
        f"{1e3 * seconds:.2f} ms (first call included), pose error |xi| {err:.6f} (no bound)")
    log(f"  launches {olaunches}")
    if not ((info.backend, info.nl_builder, info.nl_rebuilds) == ("ell", "scan", 1)
            and olaunches["flow_reduce_by_variant"]["chan"] == olaunches["flow_reduce"]
            == olaunches["step_cached"] == info.iterations > 0
            and bool(torch.all(torch.isfinite(res[0])))):
        raise SystemExit(f"channel-only pair: {info}, launches {olaunches}")
    for name in ("select", "flow_reduce", "step_cached"):
        results[name]["launches_colour_ell"] = claunches[name]
    results["flow_reduce"]["launches_by_variant"] = {
        "geo": launches["flow_reduce_by_variant"]["geo"],
        "geo_chan": claunches["flow_reduce_by_variant"]["geo_chan"],
        "chan": olaunches["flow_reduce_by_variant"]["chan"]}

    # ---- phase 6: ACVO (adaptive ell) on the ELL path
    t0 = time.perf_counter()
    results["acvo"] = acvo_path(f2f, frames, T_true, guess, dev, smi, results)
    log(f"phase 6 (ACVO, warm-up included): {time.perf_counter() - t0:.2f} s")

    # ---- phase 7: the analysis entry points, card against CPU
    t0 = time.perf_counter()
    analysis_phase(frames_np[1], frames_np[2], main_pair, guess_np, dev, smi)
    log(f"phase 7 (analysis entry points, CPU twins included): {time.perf_counter() - t0:.2f} s")

    # ---- phase 8: multiframe IRLS bundle adjustment
    t0 = time.perf_counter()
    results["irls"] = irls_phase(f2f, dev, smi, results, floor)
    log(f"phase 8 (IRLS BA): {time.perf_counter() - t0:.2f} s")

    # ---- phases 9-10: images to trajectory (device frontends, odometry drivers)
    t0 = time.perf_counter()
    results["kitti_stereo"] = stereo_phase(dev, smi, results)
    log(f"phase 9 (KITTI stereo path, CPU checks included): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    results["tum_rgbd"] = rgbd_phase(dev, smi, results)
    log(f"phase 10 (TUM RGB-D path, CPU checks included): {time.perf_counter() - t0:.2f} s")

    # ---- phase 5: where an iteration's time goes (profiler, not counted)
    profile_main_path(f2f, frames, guess, params, dev, label=" ELL path")
    profile_main_path(f2f, cframes, guess, KITTI_COLOR_BENCH, dev, iters=100,
                      label=" dense path", backend="pallas")
    profile_main_path(f2f, cframes, guess, KITTI_COLOR_BENCH, dev, iters=100,
                      label=" colour ELL path")
    paths = {name: results.pop(name) for name in ("acvo", "irls", "kitti_stereo", "tum_rgbd")}
    log(json.dumps({"paths": paths}))
    log(json.dumps({"kernels": list(results.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
