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
                   select_plain at K = 128 and 192 with P = 32 there, on a
                   BA edge and on the IRLS-shape contract cases of
                   tests/test_torch_neighbors.py (rebuilt here);
  KITTI stereo     3 rendered frames at 1241 x 376 (KITTI seq-00's camera),
                   kitti_odometry.run_frames over the first pair with the
                   device frontend
                   (census-SGM, DSO selection, backprojection) and
                   KITTI_COLOR_BENCH on the colour ELL path, phase 9;
  TUM RGB-D        2 rendered frames at 640 x 480 with uint16 depth,
                   tum_odometry.run_frames with the device frontend and
                   NL-means, phase 10. Phases 9-10 hold each frontend stage
                   on the card against the same call on the CPU, hold
                   select, flow_reduce and step_cached against their plain
                   versions on the drivers' own clouds (frames 0 and 1, at
                   the drivers' capacities, most slots masked), time the
                   stages and count their launches, and bound each pair's
                   pose error against the rendered trajectory;
  TUM RGB-D host   phase 10's frames and three more through the host
                   frontend's port (FAST selection, frontend/pipeline.py),
                   card against CPU exact, and tum_odometry.run_frames with
                   it, phase 11;
  SLAM back end    local_mapping.run_frames online (6 frames at 640 x 480,
                   one of them still: keyframes, a sliding window with its
                   marginal, frames fused into keyframe maps) and offline,
                   the loop closure of test_e2e_accuracy.py (72 frames,
                   pose graph, BKI map), the BKI map at size and the pose
                   graph (200-keyframe CG loop, 250 incremental keyframes
                   over 400 m),
                   each card against CPU, phase 12. Phases 11 and 12a-b also
                   hold select, flow_reduce and step_cached against their
                   plain versions on their own clouds;
  lidar            4 rendered HDL-64 scans (64 x 1800 rays) written as
                   velodyne files: the LOAM and LeGO-LOAM frontends on the
                   card against the CPU (equal), the two lidar kernels
                   (connected components L1, the per-ring LOAM features L2)
                   against their plain versions, kernels 1-3 on the
                   driver's clouds, kitti_lidar_odometry.run_sequence over
                   3 pairs under test_e2e_accuracy.py's lidar bounds, one
                   LeGO-LOAM pair (L1 and L2 on the path), one semantic
                   pair, 2 Lyft pairs and the PCD demo (align_two_pcd),
                   phase 13; frame 0 rendered with each beam sweeping the
                   other way (velodyne order: 64 rings) card against CPU;
                   L2 on 16 sets of adversarial rings (dense candidates,
                   column gaps, sector edges, short rings, the mark
                   thresholds, a curvature ramp, ties, random; 64 x 1800
                   and 64 x 3400) against its plain version, 13a';
  BA apps          PNG input without OpenCV (a TUM sequence at 640 x 480
                   and a TartanAir one written and decoded, decode times),
                   cv2's NL-means exact on the card (colour and grey, card
                   against CPU), tartan_odometry.run_sequence at its
                   defaults over 1 pair of a TUM-like corridor and 2 of
                   test_e2e_accuracy.py's TartanAir corridor (pair 1
                   within JAX's spread), irls_tum.main on 5 PNG frames
                   on the 'ell' backend (select at K = 128), irls_tartan
                   --translation-only and covis_tartan, phase 14;
  KITTI stereo     phase 9's frames written as a KITTI sequence of PNGs:
  host             the SGM recurrence's kernel (sgm_scan, csrc/sgm.cu)
                   against its plain version on frame 0's four scans
                   (native / device horizontal and vertical, StereoSGBM
                   top and across) and on cases of other D, the cap, S 1
                   and L 1, with its bound and latency floor (15s);
                   the native census-SGM disparity on the card against the
                   C++ library of native/ (built here with g++, called by
                   ctypes: equal bit for bit), against the CPU and twice;
                   L1 on its speckle links; Canny and EDGES_ONLY card
                   against CPU, components8 against its plain version;
                   L1 and components8 on three fixed 1241 x 376 cases
                   (every link, no link, a serpentine) against their
                   plain versions and the known labels;
                   kitti_odometry.run_sequence at its defaults (NL-means,
                   FAST, native disparity) over 1 pair and one --semantic
                   pair; irls_kitti, depth_filtering and indicator_sweep,
                   phase 15;
  ORB, tools       cv2's ORB as an exact port on the card against the CPU
                   (phase 15's frame 0 from its PNG, phase 10's frame 0:
                   keypoints, octaves, responses equal, in order; per-stage
                   times); CANNY_EDGES selection card against CPU and one
                   stereo pair through pointcloud_from_stereo(method=
                   CANNY_EDGES) and align, within 5e-3 (or the CPU runs'
                   spread) of the port's CPU pose (CANNY_CPU); gicp_align,
                   evaluate_semantics and the prefetch loader card against
                   CPU, phase 16;
  batch, shards    the lane axis of flow_reduce, step_cached, select and
                   the dense pair (B = 4 x 16384 points, against their plain
                   versions and, lane by lane and at B = 1, bit-equal to the
                   unbatched launch; a call launches the device kernels one
                   unbatched call does), parallel.batch_align.
                   make_batch_align on 4 bench pairs on geometric ELL,
                   colour ELL and dense 'pallas' against align pair by pair
                   (iterations, builds, pose; the lane kernels launched once
                   a batched iteration or build step, the single-pair ones
                   never), and the sp, ring and sharded-IRLS paths on 2 gloo
                   ranks sharing the card against the same calls in one
                   process, phase 17.

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
`--compare-tree DIR [DIR ...]` checks and times select (at the bench list,
rows 1, and at phase 8's BA edge, K = 128 and 192 with P = 32, rows 1b and
1c; each row's bound on this tree's inputs), flow_rows, flow_reduce and
step_cached of the package in each DIR, e.g. an unpacked earlier commit,
and of this tree, L1 and components8 on the inputs of phases 13a, 15a, 15b
and 15e and on the fixed cases of phase 15a', L2 on phase 13a's frame and
on 13a's "dense" and "ramp" rings at 64 x 3400 (built once by this tree,
`cc_inputs`), the four SGM scans of phase 15's frame 0 and its native and
StereoSGBM disparity frames (ms, device kernels and busy ms a call), then (unless `--no-irls`) times phase 8's IRLS BA (ms per
outer iteration, device and host engines) and phase 14d's irls_tum, in
turns, DIRs, this, this, DIRs reversed, each in a process of its own
(`--kernel-times TREE`), on one card.
`--ell-ablation` stops after phase 1: it checks, counts and times
measurement builds of csrc/ell.cu (the runtime-K slot loop, two block
reductions), then runs the geometric ELL path three times with the step's
twist part built three ways (in the kernel, on the host by twist_scalars,
on the host in matrix form) to show which one moves the pose errors; it
prints no result line.

`--slam-only` builds, then runs phases 11-12 alone and prints their JSON
line, no result line. `--lidar-only` does the same for phase 13, and
`--ba-only` for phase 14, `--stereo-only` for phase 15, `--orb-only` for
phase 16, `--parallel-only` for phase 17. Phase 12d also
runs its CG loop three times on the card and fails unless they are
bit-equal. `--assembly-compare DIR` times that loop three times and phase
8's IRLS BA twice with the package in DIR and with this tree's, in turns
(DIR, this, this, DIR), each in a process of its own, and reports whether
each tree's runs are bit-equal.

`--posegraph-ablation` runs phase 12d's incremental run, card against CPU,
with each subgraph solved in its own frame and in the world frame.

Usage: python3 chip_smoke.py [--frames 4] [--dense-ablation | --ell-ablation |
                             --posegraph-ablation |
                             --compare-tree DIR [DIR ...] [--no-irls] |
                             --assembly-compare DIR |
                             --slam-only | --lidar-only | --ba-only |
                             --stereo-only | --orb-only | --parallel-only]
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
# Phases 3, 3b, 3c, 6, 9 and 10 run at a cut depth, and warm-up pairs stop
# at WARM_ITER iterations, to leave room for phases 11-12 in the time limit
# (PERF.md section 4 lists the cuts)
MAIN_FRAMES = 3             # timed frames of the main path (after one warm-up pair)
DENSE_PAIRS = 1             # timed pairs of the dense path (after one warm-up)
N_CLASSES = 19              # semantic classes of the all-channel kernel check
COLOUR_PAIRS = 1            # timed pairs of the colour ELL path (after one warm-up)
WARM_ITER = 50              # iteration cap of a warm-up pair
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


def select_work(sel, g, K, P, dims):
    """(bytes, operations) of select on the grid inputs g: the bytes the
    function needs (the P index slots of each cell some pool touches, the
    xyz of their filled slots, cbase, xr2 and the pose, then idx, y_xyz and
    kept) and its operations on the candidates this run's pools hold."""
    N = g.cbase.shape[0]
    cid = sel.pool_cells(g.cbase, dims)
    cells = torch.unique(cid[cid < dims[0] * dims[1] * dims[2]]).long()
    filled = int((g.tab[cells][:, 3 * P:] >= 0).sum())
    cands = int((g.tab[cid.long()][..., 3 * P:] >= 0).sum())
    nbytes = (cells.numel() * P * 4 + filled * 12 + N * (12 + 16) + 48
              + K * N * 4 + 3 * K * N * 4 + N * 4)
    return nbytes, SELECT_OPS_PER_CANDIDATE * cands


def select_bound(sel, g, K, P, dims):
    """bound() of select on the grid inputs g (select_work)."""
    return bound(*select_work(sel, g, K, P, dims))


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


# tests/test_torch_neighbors.py's select contract cases at the IRLS list's
# shape (K = 128, P = 32, pool 864), rebuilt from the same seeds: kept well
# over K on a full pool, kept just over K with an exact d2 tie across slot K,
# kept under K, masked rows
SELECT_IRLS_CASES = ("irls_kept_over_k", "irls_binding_tie", "irls_kept_under_k",
                     "irls_masked_rows")


def select_irls_case(name, dev):
    """(tab, cbase, xr2, pose, P, grid_dims) of one contract case on dev:
    256 source rows, the test's parameters (ell 0.4, skin 0.3, grid 16 x 8 x
    16) and pose, the table built by grid_inputs on dev."""
    from unified_cvo_tpu_torch.config import CvoParams
    from unified_cvo_tpu_torch.ops import lie
    from unified_cvo_tpu_torch.ops import neighbors as nbr
    from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud

    rng = np.random.default_rng(11)
    params = CvoParams(ell_init=0.4, ell_min=0.05, ell_decay_rate=0.9, ell_decay_start=5,
                       indicator_window_size=5, indicator_stable_threshold=0.2,
                       max_step=0.1, sp_thres=0.0006, is_using_geometry=1)
    xi = torch.tensor([0.004, -0.006, 0.003, 0.02, -0.01, 0.03])
    R, T = lie.se3_exp(xi, 1.0)
    r2 = None
    if name == "irls_kept_over_k":
        xyz = rng.uniform(-1.5, 1.5, (256, 3)).astype(np.float32) + np.float32([0, 0, 6])
        xyz2 = np.concatenate([
            rng.uniform(-1.5, 1.5, (20000, 3)).astype(np.float32) + np.float32([0, 0, 6]),
            np.float32([[0, 0, -4], [0, 0, 16]])])
        r2 = 4.0
    elif name == "irls_binding_tie":
        g = np.stack(np.meshgrid(*[np.arange(6.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
        xyz = (g + np.float32([0, 0, 5])).astype(np.float32)
        xyz2 = np.concatenate([xyz] * 5)
        R, T, r2 = torch.eye(3), torch.zeros(3), 3.1
    else:
        xyz = rng.uniform(-2.5, 2.5, (256, 3)).astype(np.float32) + np.float32([0, 0, 6])
        xyz2 = xyz + rng.normal(scale=0.05, size=xyz.shape).astype(np.float32)
        if name == "irls_masked_rows":
            xyz = xyz[:200]
    P, dims = 32, (16, 8, 16)
    g = nbr.grid_inputs(params, torch.tensor(0.4, device=dev),
                        make_pointcloud(xyz, bucket=256, device=dev),
                        make_pointcloud(xyz2, bucket=max(256, len(xyz2)), device=dev),
                        R.float().to(dev), T.float().to(dev), skin=0.3, per_cell_cap=P,
                        grid_dims=dims)
    xr2 = g.xr2
    if r2 is not None:
        xr2 = torch.where(xr2[:, 3:] >= 0, torch.tensor(r2, device=dev), -1.0)
        xr2 = torch.cat([g.xr2[:, :3], xr2], 1).contiguous()
    return g.tab, g.cbase, xr2, g.pose, P, dims


def select_irls_contract(sel, dev, ks):
    """The kernel held to select_plain (select_exact) on every
    SELECT_IRLS_CASES case at each K of ks; each case's kept distribution
    checked against what it is built to show. Returns {case: kept max}."""
    out = {}
    for name in SELECT_IRLS_CASES:
        tab, cbase, xr2, pose, P, dims = select_irls_case(name, dev)
        live_rows = xr2[:, 3] >= 0
        for K in ks:
            args = (tab, cbase, xr2, pose, K, P, dims)
            kept, live, binding = select_exact(sel, args, f"on contract case {name}, K = {K}")
            kr = sel.select_plain(*args)[2][live_rows]
            shown = {"irls_kept_over_k": bool((kr > K).all()),
                     "irls_binding_tie": bool((kr > K).any()) if K == 128 else True,
                     "irls_kept_under_k": bool((kr <= K).all() and kr.max() > 10),
                     "irls_masked_rows": int(live_rows.sum()) == 200}[name]
            if not shown:
                raise SystemExit(f"contract case {name} at K = {K}: kept {kr.tolist()} does "
                                 f"not show what the case is built for")
            log(f"select @ contract case {name}, K = {K}, P = {P}: equal to select_plain, "
                f"two launches bit-equal; kept min / max {int(kr.min())} / {int(kr.max())}, "
                f"live slots {live}, rows with kept > K {binding}")
            out[name] = int(kr.max())
    return out


def kept_stats(kept, rows):
    """mean, p50, p99, max of the kept counts of the live rows."""
    k = kept[rows].double()
    return {"mean": float(k.mean()), "p50": float(k.quantile(0.5)),
            "p99": float(k.quantile(0.99)), "max": int(k.max())}


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
        slot_bytes = 3 * K * N * 4 + 6 * N * 4 + 32 * 4
        build = build_timings(nbr, params, ell, src, tgt, Rinv, Tinv)
        timings = {
            "select": (lambda: sel.select(*args), lambda: sel.select_plain(*args),
                       select_bound(sel, g, K, P, dims), sel_err,
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
    out = dense_close(fk, fp, bk, bp, label)
    if not (all(torch.equal(a, b) for a, b in zip(fk, fk2)) and torch.equal(bk, bk2)):
        raise SystemExit(f"two launches on the same inputs differ ({label})")
    return out


def dense_close(fk, fp, bk, bp, label):
    """One pair's flow (fk) and step (bk) outputs against the plain
    versions' (fp, bp) at phase 2b's tolerances; raises SystemExit on a
    disagreement."""
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


def kernel_times(frames_np, feats, guess_np, dev, floor, irls=True, cc=None):
    """--kernel-times TREE: the select and flow_rows kernels of the
    unified_cvo_tpu_torch package found first on the path (TREE's), each
    held against its plain version, its device kernels a call counted and
    timed at the bench shapes: select (checked on phase 2's cases and the
    IRLS-shape contract cases) at the bench guess (row 1) and on
    phase 8's BA edge at K = 128 and 192 (rows 1b, 1c), flow_rows in its
    three variants (geometry and colour on grid lists, channel only on a
    scan list), flow_reduce geo and step_cached (the loop's form) beside
    them, dense_flow and dense_step on phase 2b's case a (`dense_times`);
    then, with `cc` (a file of cc_inputs), L1, components8 and L2 on the
    main paths' inputs and the fixed cases (`cc_times`); then, unless `irls`
    is false (--no-irls), phase 8's IRLS BA and phase 14d's irls_tum, ms per
    outer iteration (`irls_times`). Prints one JSON line."""
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
    g = select_cases(sel, nbr, params, ell, src, tgt, Rinv, Tinv, "bench guess")
    args = (g.tab, g.cbase, g.xr2, g.pose, nbr.DEFAULT_K, nbr.PER_CELL_CAP, nbr.GRID_DIMS)
    timed("select", lambda: sel.select(*args))
    from unified_cvo_tpu_torch.apps import f2f_sequence as f2f

    bounds = {"select": select_bound(sel, g, nbr.DEFAULT_K, nbr.PER_CELL_CAP, nbr.GRID_DIMS)[0]}
    select_irls_contract(sel, dev, BA_SELECT_K)
    g1b = ba_edge_grid(f2f, dev)
    for K in BA_SELECT_K:
        args_b = (g1b.tab, g1b.cbase, g1b.xr2, g1b.pose, K, 32, nbr.GRID_DIMS)
        select_exact(sel, args_b, f"at the BA edge, K = {K}")
        timed(f"select K={K} P=32", lambda: sel.select(*args_b))
        bounds[f"select K={K} P=32"] = select_bound(sel, g1b, K, 32, nbr.GRID_DIMS)[0]
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
    dense_times(frames_np, feats, guess_np, dev, times, nodes)
    if cc:
        cc_times(cc, dev, times, nodes, bounds)
    busy = stereo_times(dev, times, nodes, bounds)
    if irls:
        times.update(irls_times(f2f, dev))
    log(json.dumps({"tree": unified_cvo_tpu_torch.__file__, "launch_floor_ms": floor,
                    "ms": times, "graph_nodes": nodes, "bound_ms": bounds,
                    "device_busy_ms": busy}))


def stereo_times(dev, times, nodes, bounds):
    """--kernel-times: phase 15's frame 0 (1241 x 376, D 128) through the
    package found first on the path: its four SGM scans (`_sgm_scan`) on the
    arguments the native and StereoSGBM paths give them (frame_scans), and
    the two whole frames (compute_disparity(backend="native"), sgbm_3way at
    JAX's settings). ms: the least of three CUDA-event timings after a
    warm-up; `nodes` here: the device kernels and copies of a call
    (torch.profiler, taken again where it recorded no device activity, as
    it at times does for a call of one kernel). Returns each one's device
    busy ms a call."""
    from unified_cvo_tpu_torch.frontend.calibration import Calibration
    from unified_cvo_tpu_torch.ops import sgm
    from unified_cvo_tpu_torch.utils import synth

    calib = _camera(Calibration, **KITTI00)
    T0 = synth.corridor_trajectory(STEREO_FRAMES, step=0.35)[0]
    frame = synth.render_stereo(synth.corridor_scene(seed=3), calib, T0)[:2]
    calls, native, sgbm = frame_scans(frame, dev)
    busy = {}

    def timed(name, fn):
        times[name] = min(event_ms(fn)[0] for _ in range(3))
        for _ in range(3):
            nodes[name], busy[name] = profiled(fn)
            if nodes[name]:
                break

    for name, (a, kw) in zip(SCAN_ROWS, calls):
        timed(name, lambda a=a, kw=kw: sgm._sgm_scan(*a, **kw))
        bounds[name] = bound(2 * 4 * a[0].numel() + (0 if a[1] is None else a[1].numel()), 0)[0]
    timed("native disparity frame", native)
    timed("StereoSGBM frame", sgbm)
    return busy


def ba_edge_grid(f2f, dev):
    """grid_inputs of phase 8's BA edge (0, 1) at the initial poses, skin 0,
    P = 32: the IRLS list's select inputs (rows 1b, 1c)."""
    from unified_cvo_tpu_torch.config import KITTI_GEOMETRIC_BENCH as params
    from unified_cvo_tpu_torch.models import irls
    from unified_cvo_tpu_torch.ops import neighbors as nbr

    _, _, init, _, _, clouds = ba_inputs(f2f, dev)
    c1 = irls._frame(clouds, 0).transformed(torch.from_numpy(init[0][:, :3]).to(dev),
                                            torch.from_numpy(init[0][:, 3]).to(dev))
    c2 = irls._frame(clouds, 1)
    R2, t2 = (torch.from_numpy(init[1][:, :3]).to(dev), torch.from_numpy(init[1][:, 3]).to(dev))
    ell = torch.full((), params.multiframe_ell_init, dtype=torch.float32, device=dev)
    return nbr.grid_inputs(params, ell, c1, c2, R2, t2, skin=0.0, per_cell_cap=32)


def irls_times(f2f, dev):
    """ms per outer iteration of phase 8's IRLS BA (host clock, synchronised,
    the faster of two solves an engine after a warm-up solve; the host
    engine over the device engine's outer iterations: phase 8 holds both to
    the same select launches), the device engine's busy ms and device
    kernels an outer iteration (torch.profiler, device activity only), and
    of phase 14d's irls_tum solve on the 5 TUM frames written as PNGs."""
    import os
    import tempfile

    from unified_cvo_tpu_torch.config import KITTI_GEOMETRIC_BENCH as params
    from unified_cvo_tpu_torch.frontend.calibration import Calibration
    from unified_cvo_tpu_torch.models import irls
    from unified_cvo_tpu_torch.utils import synth

    _, _, init, edges, piv, clouds = ba_inputs(f2f, dev)
    out = {}

    def solve(engine):
        return irls.irls_solve(clouds, init, edges, piv, params, engine=engine, device=dev)[1]

    outer = solve("device")[0]["iter"]                  # warm-up
    for engine in ("device", "device", "host", "host"):
        t0 = time.perf_counter()
        solve(engine)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / outer
        key = f"irls {engine} ms/outer"
        out[key] = min(out.get(key, ms), ms)
    kernels, busy = profiled(lambda: solve("device"))
    out["irls device busy ms/outer"] = busy / outer
    out["irls device kernels/outer"] = kernels / outer
    with tempfile.TemporaryDirectory(prefix="chip_smoke_irls_") as root:
        calib = _camera(Calibration, **TUM_CAMERA)
        scene = synth.corridor_scene(5, half_width=2.5, floor_y=1.2, ceil_y=-1.2, length=30.0)
        gt = synth.corridor_trajectory(max(BA_TUM_POSES) + 1, step=0.08, yaw_rate=0.015,
                                       bob=0.005)[list(BA_TUM_POSES)]
        tdir = os.path.join(root, "tum")
        synth.write_tum_sequence(tdir, scene, gt, calib)
        row = irls_tum_phase(tdir, gt, root, dev, "", {"select (K=128, P=32)": {}})
    out["irls_tum ms/outer"] = row["ms_per_outer"]
    out["select K=128 P=32, 14d edge"] = row["select_ms"]
    return out


def compare_trees(others, frames, irls=True):
    """--compare-tree DIR [DIR ...]: kernel_times of the package in each DIR
    and of this tree's, each in a process of its own, in the order DIRs,
    this, this, DIRs reversed, on one card; then a table of the runs."""
    import os
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    named = [(d, os.path.basename(os.path.abspath(d))[:14]) for d in others]
    order = named + [(here, "this")] * 2 + named[::-1]
    runs = []
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_cc_")   # removed at exit
    cc = os.path.join(tmp.name, "cc_inputs.pt")
    torch.save(cc_inputs(torch.device("cuda")), cc)
    for tree, _ in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--frames", str(frames),
                              "--kernel-times", os.path.abspath(tree), "--cc-inputs", cc]
                             + ([] if irls else ["--no-irls"]),
                             capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise SystemExit(f"kernel times of {tree} failed ({out.returncode}):\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        for line in out.stdout.splitlines():    # its build's select / lidar / image report
            if line.lstrip().startswith(("select.cu:", "lidar.cu:", "image.cu:", "sgm.cu:")):
                log(f"tree {tree}: {line.strip()}")
        log(f"tree {tree}: " + out.stdout.strip().splitlines()[-1])
    mine = runs[len(others)]
    names = list(mine["ms"])
    log(f"{'ms (graph nodes)':20s}" + "  ".join(f"{label:>14s}" for _, label in order))
    for name in names:
        log(f"{name:20s}" + "  ".join(
            f"{r['ms'].get(name, float('nan')):9.4f} ({r['graph_nodes'].get(name, 0)})"
            for r in runs))
    log(f"bound ms (this tree's inputs): {json.dumps(mine['bound_ms'])}")


def assembly_times(tree):
    """--assembly-times TREE: with the package found first in TREE, phase
    12d's CG loop three times (CUDA events, each after a warm-up solve) and
    phase 8's IRLS BA twice on the device engine (host clock): the times,
    and whether the runs are bit-equal. One JSON line."""
    sys.path.insert(0, tree)
    import unified_cvo_tpu_torch
    from unified_cvo_tpu_torch.apps import f2f_sequence as f2f
    from unified_cvo_tpu_torch.config import KITTI_GEOMETRIC_BENCH as params
    from unified_cvo_tpu_torch.models import irls
    from unified_cvo_tpu_torch.models import posegraph as pgm

    dev = torch.device("cuda")
    args, _ = pg_loop_args()
    cg = [event_ms(lambda: pgm.optimize_pose_graph(*args, iters=15, solver="cg",
                                                   device=dev)[0]) for _ in range(3)]
    _, _, init, edges, piv, clouds = ba_inputs(f2f, dev)
    ba = []
    for _ in range(2):
        t0 = time.perf_counter()
        poses, _ = irls.irls_solve(clouds, init, edges, piv, params, engine="device", device=dev)
        torch.cuda.synchronize()
        ba.append((time.perf_counter() - t0, poses))
    print(json.dumps({
        "package": unified_cvo_tpu_torch.__file__, "cg_ms": [ms for ms, _ in cg],
        "cg_bit_equal": all(torch.equal(o, cg[0][1]) for _, o in cg),
        "cg_max_abs": max(float((o - cg[0][1]).abs().max()) for _, o in cg),
        "irls_s": [s for s, _ in ba], "irls_bit_equal": bool(np.array_equal(*[p for _, p in ba])),
        "irls_max_abs": float(np.abs(ba[0][1] - ba[1][1]).max())}), flush=True)


def compare_assembly(other):
    """--assembly-compare DIR: assembly_times of the package in DIR and of
    this tree's, each in a process of its own, in the order DIR, this, this,
    DIR, on one card."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    for tree in (other, here, here, other):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--assembly-times",
                              os.path.abspath(tree)], capture_output=True, text=True,
                             timeout=900)
        if out.returncode != 0:
            raise SystemExit(f"assembly times of {tree} failed ({out.returncode}):\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        log(f"tree {tree}: " + out.stdout.strip().splitlines()[-1])


def reset_launch_counts():
    from unified_cvo_tpu_torch.ops import dense
    from unified_cvo_tpu_torch.ops import ell as ell_ops
    from unified_cvo_tpu_torch.ops import select as sel
    from unified_cvo_tpu_torch.ops import sgm

    ell_ops.reset_launches()
    sgm.reset_launches()
    for fn in (sel.select, sel.select_lanes, dense.dense_flow, dense.dense_step,
               dense.dense_flow_lanes, dense.dense_step_lanes):
        fn.launches = 0


def launch_counts():
    from unified_cvo_tpu_torch.ops import dense
    from unified_cvo_tpu_torch.ops import ell as ell_ops
    from unified_cvo_tpu_torch.ops import select as sel
    from unified_cvo_tpu_torch.ops import sgm

    return {"sgm_scan": sgm._sgm_scan.launches, "select": sel.select.launches, "flow_reduce": ell_ops.flow_reduce.launches,
            "flow_reduce_by_variant": dict(ell_ops.flow_reduce.variant_launches),
            "step_cached": ell_ops.step_cached.launches,
            "flow_reduce_lanes": ell_ops.flow_reduce_lanes.launches,
            "step_cached_lanes": ell_ops.step_cached_lanes.launches,
            "dense_flow": dense.dense_flow.launches, "dense_step": dense.dense_step.launches,
            "select_lanes": sel.select_lanes.launches,
            "dense_flow_lanes": dense.dense_flow_lanes.launches,
            "dense_step_lanes": dense.dense_step_lanes.launches}


def profile_main_path(f2f, frames, guess, params, dev, iters=200, label="", **align_kw):
    """Where an iteration's time goes: one pair capped at `iters` iterations
    under torch.profiler, recording the device's activity alone (host events
    slowed the loop by ~40% and took tens of seconds to trace). Prints wall
    time, device kernels and device busy time per iteration, the device's
    idle share and the heaviest kernels."""
    from torch.profiler import ProfilerActivity, profile

    f2f.run_sequence(frames[:2], guess, params, device=dev, max_iter=iters, **align_kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


ACVO_PAIRS = 1               # timed scan-builder pairs of the ACVO path (after one
#                              warm-up pair)
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
    f2f.run_sequence(frames[:2], guess, acvo, device=dev, max_iter=WARM_ITER)
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


def ba_inputs(f2f, dev):
    """Phase 8's BA: BA_FRAMES frames of the bench scene at BA_POINTS points,
    their true poses, the initial poses (the true ones moved by seeded
    twists), the chain and skip-one edges, the pivot flags and the stacked
    clouds on dev."""
    from unified_cvo_tpu_torch.models import irls
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
    return frames_np, true, init, edges, piv, clouds


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

    frames_np, true, init, edges, piv, clouds = ba_inputs(f2f, dev)
    backend = irls.resolve_irls_backend(params, BA_POINTS)
    if backend != "ell":
        raise SystemExit(f"IRLS auto backend at {BA_POINTS} points resolved to {backend}")
    out, first = {}, None
    for engine in ("device", "host", "device"):     # the first device solve warms up
        reset_launch_counts()
        t0 = time.perf_counter()
        poses, hist = irls.irls_solve(clouds, init, edges, piv, params, engine=engine,
                                      device=dev)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        if engine == "device" and first is None:
            first = poses
        out[engine] = (poses, hist, sec, sel.select.launches)
    poses_d, hist_d, sec_d, sel_d = out["device"]
    rerun_gap = float(np.abs(poses_d - first).max())
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
        f"{ate_h:.6f} m; engines max abs {float(np.abs(poses_d - poses_h).max()):.3g}; two "
        f"device-engine runs {'bit-equal' if np.array_equal(first, poses_d) else 'apart by'} "
        f"{rerun_gap:.3g}")
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
          "ate_before": ate0, "ate_after": ate_d, "select_launches": sel_d,
          "device_runs_max_abs": rerun_gap}

    # select at the BA's list shape, on edge (0, 1) at the initial poses
    P, dims = 32, nbr.GRID_DIMS
    g = ba_edge_grid(f2f, dev)
    lists = kept_stats(sel.select_plain(g.tab, g.cbase, g.xr2, g.pose, 128, P, dims)[2],
                       g.xr2[:, 3] >= 0)
    lists["per_cell_dropped"] = int(g.per_cell_dropped)
    ba["edge_lists"] = lists
    log(f"BA edge (0, 1) at the initial poses, skin 0, P = {P}: kept a live row "
        f"{lists}")
    ba["contract_kept_max"] = select_irls_contract(sel, dev, BA_SELECT_K)
    for K in BA_SELECT_K:
        args = (g.tab, g.cbase, g.xr2, g.pose, K, P, dims)
        sel.select.launches = 0
        kept, live, binding = select_exact(sel, args, f"at the BA edge (0, 1), K = {K}, P = {P}")
        check_launches = sel.select.launches
        n_dev = kernels_per_call(lambda: sel.select(*args))
        if n_dev != 1:
            raise SystemExit(f"select at K = {K}: {n_dev} device kernels a call, not 1")
        ms, plain_ms = device_ms(lambda: sel.select(*args)), device_ms(lambda: sel.select_plain(*args))
        b_ms, b_by = select_bound(sel, g, K, P, dims)
        name = f"select (K={K}, P={P})"
        results[name] = {
            "name": name, "route": "cuda", "source": "unified_cvo_tpu_torch/csrc/select.cu",
            "replaces": "unified_cvo_tpu/ops/pallas_select.py:39 (_select_kernel)",
            "launches": sel_d if K == 128 else check_launches, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "launches_per_call": n_dev, "launch_floor_ms": floor,
            "launched_by": ("the IRLS BA path (phase 8, device engine)" if K == 128 else
                            "the phase 8 check only (JAX's ELL moments test runs K = 192)")}
        log(f"select @ BA edge (0, 1), K = {K}, P = {P} (pool 864, select_pool_kernel<32>): "
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
STEREO_FRAMES = 3            # rendered stereo frames (phase 15's PNGs, 15c's JAX records)
STEREO_DRIVER_FRAMES = 2     # frames phases 9 and 15c register (1 pair)
RGBD_FRAMES = 5              # phase 11: rendered RGB-D frames (the frontend checks)
# phase 10's driver and phase 11's: the first 2 of them, 1 pair each (2 pairs
# before the 14c corridor came, 4 in phase 11 before phase 17 came: cuts for the
# time limit)
TUM_DEVICE_FRAMES = 2
TUM_HOST_FRAMES = 2
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
# Phase 15c's first pair (the host frontend at its defaults, the same frames)
# misses too, in both its runs (with and without --semantic: the same clouds
# but for the labels); JAX on the installed cv2's grey (cv2.cvtColor, which the
# port's host frontend computes); from `JAX_PLATFORMS=cpu python
# tests/test_torch_stereo_apps.py --chip` and `... tests/test_torch_odometry.py
# stereo_host --spread --port`.
_MISS_15C = {0: (0.142748, (9.969413568e-04, 1.000921666e-02, -6.259948526e-04,
                            -1.342620725e-04, 7.343861691e-02, 2.240591642e-01),
                 {3: 2.01e-2, 4: 1.30e-2})}
# Phase 15e's pair (frames 0 -> 1 on the StereoSGBM backend) misses too, every
# CPU run with 2 builds (JAX's alone part by up to 2.01e-3, the port's by up to
# 2.69e-3 from JAX's); from `JAX_PLATFORMS=cpu python tests/test_torch_stereo_apps.py
# --chip --opencv` and `... tests/test_torch_odometry.py stereo_sgbm --spread --port`.
_MISS_15E = {0: (0.178720, (1.096056773e-03, 9.709683994e-03, 5.204357125e-05,
                            1.341154318e-02, 7.110345148e-02, 1.841614508e-01), {2: 2.69e-3})}
# Phase 14c's run of test_e2e_accuracy.py's TartanAir corridor: pair 1 misses
# too (1500 iterations, 1 build, every run); over 30 CPU runs, each package
# unmoved, with pair 1's guess moved by +-1e-6 and +-2e-6 m along x and z or
# its source by one ulp, and with pair 0's guess moved by +-1e-6 m (pair 1
# starts where pair 0 ends: JAX's own runs moved there part by up to 9.45e-4),
# the farthest from JAX's pose is 1.25e-3 (JAX's own: 9.45e-4); from
# `JAX_PLATFORMS=cpu python tests/test_torch_odometry.py tartan_corridor --port`.
_MISS_14C = {1: (0.086285, (8.080207044e-05, 1.461818069e-02, -4.901799839e-04,
                            6.267059129e-03, 8.675036952e-04, 1.400364656e-02), {1: 1.25e-3})}
JAX_MISSES = {
    "phase 9": {0: (0.074307, (-1.614563080e-04, 9.696566500e-03, -7.273391238e-04,
                               4.112411290e-03, 3.883998143e-03, 2.759748101e-01),
                    {2: 8.49e-4, 3: 0.0167})},
    "phase 15c": _MISS_15C, "phase 15c semantic": _MISS_15C, "phase 15e": _MISS_15E,
    "phase 14c corridor": _MISS_14C}
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


def rgbd_frames(poses=range(RGBD_FRAMES)):
    """The TUM camera in the TUM fixture's corridor (test_e2e_accuracy.py),
    at the given indices of its trajectory (an index repeated holds the
    camera still), depth quantised to uint16 at depth_scale; a depth past
    the uint16 range (13.1 m at depth_scale 5000) is 0, no measurement, as
    a TUM depth map marks it (clipped, it would be a false wall at 13.1 m):
    (calibration, [(BGR, depth, timestamp)], poses)."""
    from unified_cvo_tpu_torch.frontend.calibration import Calibration
    from unified_cvo_tpu_torch.utils import synth

    poses = list(poses)
    calib = _camera(Calibration, **TUM_CAMERA)
    scene = synth.corridor_scene(5, half_width=2.5, floor_y=1.2, ceil_y=-1.2, length=30.0)
    traj = synth.corridor_trajectory(max(poses) + 1, step=0.08, yaw_rate=0.015,
                                     bob=0.005)[poses]
    frames = []
    for i, T in enumerate(traj):
        bgr, depth = synth.render_frame(scene, calib, T)
        q = depth * calib.depth_scale
        d16 = np.where((q > 0) & (q <= 65535), q, 0).astype(np.uint16)
        frames.append((bgr, d16, f"{1000.0 + 0.1 * i:.4f}"))
    return calib, frames, traj


def profiled(fn):
    """(device kernels and copies, device busy ms) of one call of fn after a
    warm-up call, from torch.profiler recording the device's activity alone
    (host events are not read, and cost seconds to trace for calls of
    ~20000 launches)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def driver_kernel_checks(src, tgt, T_rel, params, dev, results, what, first=None):
    """select, flow_reduce (geometry x channel) and step_cached against their
    plain versions on a driver's own clouds: frames 0 and 1 from its
    frontend at its capacity, most slots masked, the list built as align
    builds it (grid builder, K = 32), at the first pair's start (the
    identity, the ell of the first pair's params `first`, by default the
    first-frame swap) and at the rendered relative pose (the preset's ell). select output for output (select_exact); flow_agree;
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
    first = params.first_frame() if first is None else first
    for label, p, T in (("identity, first pair's ell", first, np.eye(4)),
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
        if k not in JAX_MISSES.get(phase, {}):
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
    first pair (KITTI_COLOR_BENCH, bench.py's 1500-iteration cap, capacity
    32768, max_disp by the width rule: 128) and every pair must end below
    the bench bound with select, flow_reduce and step_cached launched (and
    sgm_scan twice a frame, phase 15s's kernel). Those
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
        frames[:STEREO_DRIVER_FRAMES], calib, KITTI_COLOR_BENCH, capacity=cap,
        max_iter=MAX_ITER, frontend="device", device=dev, log=lambda *a: None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    out = driver_report("phase 9", "phase 9 KITTI stereo driver (kitti_odometry.run_frames, "
                        "--device-frontend)", poses, traj, records, seconds, launches, smi)
    scan_launches("phase 9", launches["sgm_scan"], len(poses), (), results)
    out.update(valid_points=valid, frontend=stages, cpu_sgm_s=cpu_s,
               sgm_scan_launches=launches["sgm_scan"],
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
    them. Then tum_odometry.run_frames registers the TUM_DEVICE_FRAMES - 1 pairs
    (KITTI_COLOR_BENCH, the 1500-iteration cap, capacity 16384,
    denoise=True) under the same bound and launch checks as phase 9, after
    the same kernel checks on its clouds of frames 0 and 1."""
    from unified_cvo_tpu_torch.apps import tum_odometry
    from unified_cvo_tpu_torch.config import KITTI_COLOR_BENCH
    from unified_cvo_tpu_torch.frontend import device as fe
    from unified_cvo_tpu_torch.ops import nlm

    t0 = time.perf_counter()
    calib, frames, traj = rgbd_frames(range(TUM_DEVICE_FRAMES))
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
    if launches["sgm_scan"] != 0:        # depth comes from the sensor: no disparity
        raise SystemExit(f"phase 10: the RGB-D driver launched sgm_scan {launches['sgm_scan']} "
                         f"times")
    out.update(valid_points=valid, frontend=stages, cpu_nlm_s=cpu_s,
               frontend_checks={"nlm_max_abs": nlm_err, "selected_cells": n_sel,
                                "cloud_xyz_max_abs": xyz_err,
                                "whole_entry_point_slots_differing": differ})
    for name in ("select", "flow_reduce", "step_cached"):
        results[name]["launches_tum_rgbd"] = launches[name]
    return out


# ---- phases 11-12: the host RGB-D frontend (FAST) and the SLAM back end
# phase 12a: the corridor poses of its 6 frames at 640 x 480; the camera holds
# still at frame 3
LM_POSES = (0, 1, 2, 2, 3, 4)
LM_CAPACITY = 8192           # local_mapping.CAPACITY
LM_CLASSES = 19
# the keyframe threshold on the approximate function angle: a pair that
# moves 0.08 m scores about 0.04, a still pair more, so the 5 frames that
# moved become keyframes and the still one is fused into its keyframe's map
LM_KEYFRAME_ANGLE = 0.05
LM_WINDOW = 3                # the pose graph's window: 5 keyframes slide it twice
LM_ATE_BOUND = 0.05          # test_apps_drivers.py's bound on the online trajectory
LOOP_FRAMES = 72             # phase 12b: test_e2e_accuracy.py's loop through the room
LOOP_CAPACITY = 4096
LOOP_ITER = 300              # iterations a pair (500 for the closure)
LOOP_ATE_BOUND = 0.05        # test_e2e_accuracy.py's bound after the closure
# JAX's own pipeline, fed phase 12b's frames and settings on the CPU, also
# ends above LOOP_ATE_BOUND: every pair stops at the 300-iteration cap and
# the 71-pair chain drifts (keyframe ATE 0.371 m, 0.171 m after the closure).
# (JAX's closed ATE, the farthest any CPU run ended from it: JAX's 8 runs
# with the first guess moved by +-1e-6 or +-2e-6 m along x or z, 0.1652 to
# 0.1837, and the port's unmoved run, 0.1800), from `JAX_PLATFORMS=cpu
# python tests/test_torch_local_mapping.py [--spread DX,DZ ...]` (ROADMAP
# section 3). The card's closed ATE must lie within that spread of JAX's.
LOOP_JAX_MISS = (0.170947, 0.012796)
BKI_FRAMES = 4               # phase 12c: BKI inserts of 8192-point frames, 19 classes
BKI_RTOL = 1e-5
PG_LOOP = 200                # phase 12d: test_posegraph_bki.py's CG loop
PG_INCREMENTAL = 250         # keyframes of the incremental run
PG_STEP = 1.6                # m between them: 400 m of track, where float32 world-frame
                             # poses part card and CPU by 3.6e-3 m (so subgraphs solve in
                             # their own frame)
PG_TOL = 1e-4                # poses, card against the CPU


def colour_yaml_params():
    """The params YAML tests/test_torch_odometry.py writes (the reference's
    cvo_rgbd_params.yaml is not in the repo): the colour preset with ell
    0.5 (first frame 0.5), ell_min 0.05, ell_max 1.0."""
    from unified_cvo_tpu_torch.config import CvoParams

    return CvoParams().replace(ell_init=0.5, ell_init_first_frame=0.5, ell_min=0.05,
                               ell_max=1.0, is_using_intensity=1)


def check_path_launches(label, launches, iters, builds):
    """Every kernel of the align path went through the run: select at least
    once a build, flow_reduce (geometry x channel) and step_cached once an
    iteration."""
    if not (launches["select"] >= sum(builds) > 0
            and launches["flow_reduce_by_variant"].get("geo_chan") == launches["flow_reduce"]
            == launches["step_cached"] == sum(iters)):
        raise SystemExit(f"{label}: launch counts {launches} do not match {sum(builds)} "
                         f"builds and {sum(iters)} iterations")


def tum_host_phase(dev, smi, results):
    """Phase 11: the host frontend's port (FAST selection, frontend/
    pipeline.py) on 5 frames of the rendered 640 x 480 corridor (phase
    10's 3 and two more). Frame 0 on the
    card against the port's CPU call: grey level and gradients, FAST scores,
    the chosen threshold and uv (order included) exact; the cloud's masks
    equal, xyz rtol/atol 1e-5, features abs 1e-5. FAST and the whole
    pointcloud_from_rgbd are timed by CUDA events and their launches
    counted; select, flow_reduce and step_cached are held against their
    plain versions on the clouds of frames 0 and 1; then
    tum_odometry.run_frames with its default frontend (denoise=False)
    registers the first TUM_HOST_FRAMES - 1
    pairs under phase 10's bound and launch checks."""
    from unified_cvo_tpu_torch.apps import tum_odometry
    from unified_cvo_tpu_torch.config import KITTI_COLOR_BENCH
    from unified_cvo_tpu_torch.frontend import image as fimg
    from unified_cvo_tpu_torch.frontend import pipeline
    from unified_cvo_tpu_torch.frontend import selector as sel

    t0 = time.perf_counter()
    calib, frames, traj = rgbd_frames()
    cap = tum_odometry.CAPACITY
    cpu = torch.device("cpu")
    bgr, depth, _ = frames[0]
    raw_c = fimg.make_raw_image(bgr, denoise=False, device=cpu)
    raw_k = fimg.make_raw_image(bgr, denoise=False, device=dev)
    for name in ("intensity", "gradient", "gradient_square"):
        if not torch.equal(getattr(raw_k, name).cpu(), getattr(raw_c, name)):
            raise SystemExit(f"phase 11: make_raw_image's {name} on the card differs from the CPU's")
    score_c, score_k = sel.fast_scores(raw_c.intensity), sel.fast_scores(raw_k.intensity)
    uv_c, _, thr_c = sel.fast_select(raw_c.intensity, "rgbd", 0)
    uv_k, _, thr_k = sel.fast_select(raw_k.intensity, "rgbd", 0)
    if not (torch.equal(score_k.cpu(), score_c) and thr_k == thr_c
            and torch.equal(uv_k.cpu(), uv_c)):
        raise SystemExit(f"phase 11: FAST on the card differs from the CPU's (threshold "
                         f"{thr_k} / {thr_c}, {len(uv_k)} / {len(uv_c)} keypoints)")

    def cloud(d, frame=frames[0]):
        return pipeline.pointcloud_from_rgbd(frame[0], frame[1], calib, denoise=False,
                                             capacity=cap, device=d)

    xyz_err = clouds_agree(cloud(dev), cloud(cpu), "phase 11 cloud")
    clouds = [cloud(dev, f) for f in frames]
    valid = [int(c.mask.sum()) for c in clouds]
    driver_kernel_checks(clouds[0], clouds[1], np.linalg.inv(traj[0]) @ traj[1],
                         KITTI_COLOR_BENCH, dev, results, "phase 11 frames 0 -> 1")
    del clouds
    log(f"phase 11 frontend, card against CPU on frame 0: grey level, gradients and FAST "
        f"scores equal, threshold {thr_k} (both), {len(uv_k)} keypoints equal in raster "
        f"order; cloud masks equal, xyz max abs {xyz_err:.3g} ({time.perf_counter() - t0:.1f} s "
        f"with the CPU calls)")
    log(f"  valid points per frame {valid} of {cap}")
    gray_k = raw_k.intensity
    stages = stage_times({
        "frontend (pointcloud_from_rgbd: FAST, backprojection, upload included)":
            lambda: cloud(dev),
        "FAST scores (fast_scores)": lambda: sel.fast_scores(gray_k),
        "FAST selection (scores, histogram read, threshold search, raster compaction)":
            lambda: sel.fast_select(gray_k, "rgbd", 0),
    }, smi)

    reset_launch_counts()
    t0 = time.perf_counter()
    poses, _, records = tum_odometry.run_frames(
        frames[:TUM_HOST_FRAMES], calib, KITTI_COLOR_BENCH, capacity=cap, max_iter=MAX_ITER,
        denoise=False, device=dev, log=lambda *a: None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    out = driver_report("phase 11", "phase 11 TUM RGB-D driver (tum_odometry.run_frames, host "
                        "frontend: FAST)", poses, traj, records, seconds, launches, smi)
    out.update(valid_points=valid, frontend=stages, fast_threshold=thr_k,
               frontend_checks={"keypoints": len(uv_k), "cloud_xyz_max_abs": xyz_err})
    for name in ("select", "flow_reduce", "step_cached"):
        results[name]["launches_tum_host"] = launches[name]
    return out


def bki_gap(mk, mc):
    """(keys equal, alpha's largest relative gap, semantics equal, alpha
    bit-equal) of a BKI map on the card against one on the CPU."""
    keys_eq = torch.equal(mk.keys.cpu(), mc.keys)
    if not keys_eq:
        return False, float("nan"), False, False
    ak = mk.alpha.cpu()
    return (True, float(((ak - mc.alpha).abs() / mc.alpha.abs()).max()),
            torch.equal(ak.argmax(1), mc.alpha.argmax(1)), torch.equal(ak, mc.alpha))


def local_mapping_part(dev, smi, results):
    """Phase 12a: local_mapping.run_frames online (odometry, keyframing,
    the windowed pose graph with its marginal, per-keyframe BKI maps) and
    offline along the rendered trajectory, on the 6 frames of LM_POSES at
    640 x 480. select, flow_reduce and step_cached are first held against
    their plain versions on the clouds of frames 0 and 1. The frames that
    moved must become keyframes and the still ones must not; the window
    must slide. Then the back end runs again on the CPU from the card's
    tracking (run_frames' odometry replay) and offline: trajectories within
    PG_TOL, keyframes equal, each keyframe's map and the offline map with
    keys equal and alpha within BKI_RTOL."""
    from unified_cvo_tpu_torch.apps import local_mapping as lm
    from unified_cvo_tpu_torch.config import KITTI_COLOR_BENCH
    from unified_cvo_tpu_torch.frontend import pipeline
    from unified_cvo_tpu_torch.utils import metrics

    calib, frames, traj = rgbd_frames(LM_POSES)
    params = KITTI_COLOR_BENCH.replace(MAX_ITER=MAX_ITER)
    pair = [pipeline.pointcloud_from_rgbd(f[0], f[1], calib, denoise=False,
                                          capacity=LM_CAPACITY, device=dev) for f in frames[:2]]
    driver_kernel_checks(pair[0], pair[1], np.linalg.inv(traj[0]) @ traj[1], params, dev,
                         results, "phase 12a frames 0 -> 1", first=params)
    del pair
    kw = dict(num_classes=LM_CLASSES, capacity=LM_CAPACITY, denoise=False, log=lambda *a: None)
    online = dict(keyframe_function_angle=LM_KEYFRAME_ANGLE, window_size=LM_WINDOW, **kw)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = lm.run_frames(frames, calib, params, device=dev, **online)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    iters = [i.iterations for i in res.align_infos]
    builds = [i.nl_rebuilds for i in res.align_infos]
    check_path_launches("phase 12a", launches, iters, builds)
    est = np.stack([T for _, T in res.trajectory])
    ate = metrics.ate_rmse(traj[:len(est)], est)
    n, pairs = res.frames, res.frames - 1
    angles = [round(fa, 4) for _, fa in res.odometry]
    kf_frames = [kf.frame_id for kf in res.keyframes]
    moved = [0] + [k for k in range(1, n) if LM_POSES[k] != LM_POSES[k - 1]]
    pg = res.pose_graph
    t1 = time.perf_counter()
    off = lm.run_frames(frames, calib, params, trajectory=list(traj), device=dev, **kw)
    torch.cuda.synchronize()
    off_s = time.perf_counter() - t1

    t1 = time.perf_counter()
    cpu = lm.run_frames(frames, calib, params, odometry=res.odometry, device="cpu", **online)
    off_c = lm.run_frames(frames, calib, params, trajectory=list(traj), device="cpu", **kw)
    cpu_s = time.perf_counter() - t1
    traj_gap = max(float(np.abs(a - b).max())
                   for (_, a), (_, b) in zip(res.trajectory, cpu.trajectory))
    kf_gaps = [bki_gap(a.local_map, b.local_map) for a, b in zip(res.keyframes, cpu.keyframes)]
    off_gap = bki_gap(off.global_map, off_c.global_map)
    maps_ok = all(g[0] and g[1] <= BKI_RTOL and g[2] for g in kf_gaps + [off_gap])
    export_ok = (res.centers.shape == cpu.centers.shape
                 and np.allclose(res.centers, cpu.centers, rtol=0, atol=PG_TOL)
                 and np.array_equal(res.semantics, cpu.semantics))
    row = {"frames": n, "poses": list(LM_POSES), "keyframes": len(res.keyframes),
           "keyframe_frames": kf_frames, "window_lo": pg.window_lo,
           "voxels": len(res.centers), "ate_m": ate, "seconds": seconds, "iterations": iters,
           "builds": builds, "function_angles": angles,
           "align_ms_a_pair": 1e3 * res.seconds["align"] / pairs,
           "bki_insert_ms_a_frame": 1e3 * res.seconds["bki"] / n,
           "posegraph_ms_a_pair": 1e3 * res.seconds["posegraph"] / pairs,
           "frontend_ms_a_frame": 1e3 * res.seconds["frontend"] / n,
           "function_angle_ms_a_pair": 1e3 * res.seconds["function_angle"] / pairs,
           "offline": {"voxels": len(off.centers), "seconds": off_s,
                       "bki_insert_ms_a_frame": 1e3 * off.seconds["bki"] / off.frames},
           "cpu": {"seconds": cpu_s, "trajectory_max_abs": traj_gap,
                   "keyframe_maps": [g[:2] for g in kf_gaps], "offline_map": off_gap[:2],
                   "maps_bit_equal": all(g[3] for g in kf_gaps + [off_gap]),
                   "export_equal": export_ok},
           "launches": {k: launches[k] for k in ("select", "flow_reduce", "step_cached")}}
    log(f"phase 12a local mapping (local_mapping.run_frames, {n} frames at {calib.cols} x "
        f"{calib.rows}, capacity {LM_CAPACITY}, {LM_CLASSES} classes, window {LM_WINDOW}): "
        f"{seconds:.2f} s online, keyframes at frames {kf_frames} (function angles {angles}, "
        f"threshold {LM_KEYFRAME_ANGLE}), window from keyframe {pg.window_lo}, "
        f"{len(res.centers)} occupied voxels, ATE {ate:.6f} m ({smi})")
    log(f"  ms a pair: align {row['align_ms_a_pair']:.1f}, function angle "
        f"{row['function_angle_ms_a_pair']:.1f}, pose graph {row['posegraph_ms_a_pair']:.1f}; ms "
        f"a frame: BKI insert {row['bki_insert_ms_a_frame']:.1f}, frontend "
        f"{row['frontend_ms_a_frame']:.1f}; iterations {iters}, builds {builds}")
    log(f"  offline along the rendered trajectory: {len(off.centers)} occupied voxels, "
        f"{off_s:.2f} s, BKI insert {row['offline']['bki_insert_ms_a_frame']:.1f} ms a frame")
    log(f"  the back end on the CPU from the card's tracking, and offline ({cpu_s:.1f} s): "
        f"trajectory max abs {traj_gap:.3g}, keyframe maps (keys equal, alpha max rel) "
        f"{[g[:2] for g in kf_gaps]}, offline map {off_gap[:2]}, bit-equal "
        f"{row['cpu']['maps_bit_equal']}, export equal {export_ok}")
    log(f"  launches {launches}")
    if not (kf_frames == moved and pg.window_lo > 0 and ate < LM_ATE_BOUND
            and len(off.centers) > 1000 and np.isfinite(res.centers).all()
            and [kf.frame_id for kf in cpu.keyframes] == kf_frames and traj_gap <= PG_TOL
            and maps_ok and export_ok):
        raise SystemExit(f"phase 12a: keyframes {kf_frames} (want {moved}), window from "
                         f"{pg.window_lo}, ATE {ate}, {len(off.centers)} offline voxels, "
                         f"card against CPU {row['cpu']}")
    for name in ("select", "flow_reduce", "step_cached"):
        results[name]["launches_local_mapping"] = launches[name]
    return row


def loop_closure_part(dev, smi, results):
    """Phase 12b: test_e2e_accuracy.py::test_online_slam_loop_closure_e2e's
    scenario on the card: the room with 3 pillars, 72 frames on a loop of
    radius 2.5 m with depth noise 0.005 m at 320 x 240, host-frontend clouds
    of 4096 points (no NL-means),
    frame-to-frame align (300 iterations, the first pair at the coarse
    first-frame schedule), exact function-angle keyframing into the pose
    graph (window 0, 8 iterations, Huber 0.05), a first-to-last closure
    gated on the exact function angle, then a BKI map at the optimized
    poses. select, flow_reduce and step_cached are first held against their
    plain versions on the clouds of frames 0 and 1. The test's own bounds:
    ATE after the closure below the odometry's and below 0.05, surface
    occupancy above 0.5, no phantom surface at the loop's centre."""
    from unified_cvo_tpu_torch.frontend import pipeline
    from unified_cvo_tpu_torch.models.align import align, function_angle
    from unified_cvo_tpu_torch.models.bki import SemanticBKIMap
    from unified_cvo_tpu_torch.models.posegraph import PoseGraph, PoseGraphConfig, RelativePose
    from unified_cvo_tpu_torch.utils import metrics, synth
    from unified_cvo_tpu_torch.utils.pointcloud import to_numpy_valid

    t0 = time.perf_counter()
    calib = synth.tum_calibration()
    scene = synth.room_scene(7, half=6.0, n_pillars=3)
    traj = synth.loop_trajectory(LOOP_FRAMES, radius=2.5)
    frames = list(synth.tum_frames(scene, traj, calib, depth_noise=0.005))
    render_s = time.perf_counter() - t0
    params = colour_yaml_params()
    t0 = time.perf_counter()
    clouds = [pipeline.pointcloud_from_rgbd(rgb, d, calib, capacity=LOOP_CAPACITY,
                                            denoise=False, device=dev) for rgb, d, _ in frames]
    torch.cuda.synchronize()
    frontend_s = time.perf_counter() - t0
    first = params.replace(ell_init=0.5, ell_max=1.0)
    driver_kernel_checks(clouds[0], clouds[1], np.linalg.inv(traj[0]) @ traj[1], params, dev,
                         results, "phase 12b frames 0 -> 1", first=first)
    fa_ell = torch.tensor(max(params.ell_init * 0.5, params.ell_min), dtype=torch.float32,
                          device=dev)
    pg = PoseGraph(PoseGraphConfig(window_size=0, optimize_iters=8, robust_delta=0.05),
                   device=dev)
    pg.add_first_frame(0)
    kf_clouds, kf_frames = [clouds[0]], [0]
    odo_poses, world_T, kf_T, prev_rel = [np.eye(4)], np.eye(4), np.eye(4), np.eye(4)
    fa_track, iters, builds = [], [], []
    reset_launch_counts()
    t0 = time.perf_counter()
    t_align = t_pg = 0.0
    for k in range(1, len(clouds)):
        ig = torch.as_tensor(np.linalg.inv(prev_rel), dtype=torch.float32, device=dev)
        ta = time.perf_counter()
        T_rel, _, info = align(clouds[k - 1], clouds[k], ig, first if k == 1 else params,
                               max_iter=LOOP_ITER, chunk=2048, device=dev)
        t_align += time.perf_counter() - ta
        iters.append(info.iterations)
        builds.append(info.nl_rebuilds)
        rel = T_rel.cpu().numpy().astype(np.float64)
        prev_rel = rel
        kf_T = kf_T @ rel
        world_T = world_T @ rel
        odo_poses.append(world_T.copy())
        fa = float(function_angle(clouds[k - 1], clouds[k], T_rel, fa_ell, params,
                                  approximate=False, device=dev))
        fa_track.append(fa)
        tp = time.perf_counter()
        if pg.add_frame(k, kf_T, function_angle=fa):
            kf_T = np.eye(4)
            kf_clouds.append(clouds[k])
            kf_frames.append(k)
            world_T = pg.keyframe_poses[-1].copy()
        t_pg += time.perf_counter() - tp
    torch.cuda.synchronize()
    odo_s = time.perf_counter() - t0
    launches = launch_counts()
    check_path_launches("phase 12b", launches, iters, builds)
    gt_kf = traj[kf_frames]
    ate_odo = metrics.ate_rmse(gt_kf, np.stack([odo_poses[k] for k in kf_frames]))
    coarse = params.replace(ell_init=0.5, ell_max=1.0)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    T_lc, _, info_lc = align(kf_clouds[0], kf_clouds[-1], eye, coarse, max_iter=500,
                             chunk=2048, device=dev)
    fa_lc = float(function_angle(kf_clouds[0], kf_clouds[-1], T_lc, fa_ell, params,
                                 approximate=False, device=dev))
    fa_ref = float(np.median(fa_track))
    pg.factors.append(RelativePose(curr_id=len(pg.keyframe_poses) - 1, ref_id=0,
                                   transform=T_lc.cpu().numpy().astype(np.float64),
                                   inner_product=fa_lc))
    tp = time.perf_counter()
    pg.optimize()
    t_close = time.perf_counter() - tp
    ate_opt = metrics.ate_rmse(gt_kf, np.stack(pg.keyframe_poses))
    m = SemanticBKIMap(resolution=0.1, num_classes=4, ell=0.2, free_resolution=100.0,
                       device=dev)
    tb = time.perf_counter()
    for kc, T in zip(kf_clouds, pg.keyframe_poses):
        data = to_numpy_valid(kc)
        m.insert_pointcloud(data["xyz"] @ T[:3, :3].T + T[:3, 3], None, origin=T[:3, 3])
    torch.cuda.synchronize()
    bki_s = time.perf_counter() - tb
    surf = to_numpy_valid(kf_clouds[0])["xyz"][::7]
    occ_frac = float((m.query(surf)[0] == 1).mean())
    T0_inv = np.linalg.inv(traj[0])
    ctr = np.array([[0.0, -0.3, 0.0], [0.3, 0.0, 0.3], [-0.3, 0.1, -0.3]])
    states_f = m.query(ctr @ T0_inv[:3, :3].T + T0_inv[:3, 3])[0]
    row = {"frames": len(clouds), "keyframes": len(kf_frames), "keyframe_frames": kf_frames,
           "iterations": iters, "builds": builds, "closure_iterations": info_lc.iterations,
           "fa_closure": fa_lc, "fa_tracking_median": fa_ref, "ate_odometry_m": ate_odo,
           "ate_closed_m": ate_opt, "surface_occupancy": occ_frac,
           "centre_states": states_f.tolist(), "voxels": len(m),
           "seconds": {"render_host": render_s, "frontend": frontend_s, "odometry": odo_s,
                       "align": t_align, "posegraph": t_pg, "closure_optimize": t_close,
                       "bki": bki_s},
           "valid_points": [int(c.mask.sum()) for c in clouds[:3]],
           "launches": {k: launches[k] for k in ("select", "flow_reduce", "step_cached")}}
    log(f"phase 12b loop closure ({len(clouds)} frames at {calib.cols} x {calib.rows}, "
        f"capacity {LOOP_CAPACITY}, {LOOP_ITER} iterations a pair): {len(kf_frames)} keyframes; "
        f"odometry {odo_s:.2f} s (align {1e3 * t_align / len(iters):.1f} ms a pair, pose graph "
        f"{1e3 * t_pg / len(iters):.1f} ms a pair), frontend {1e3 * frontend_s / len(clouds):.1f} "
        f"ms a frame ({smi})")
    log(f"  closure: function angle {fa_lc:.4f} against the tracking median {fa_ref:.4f}, "
        f"{info_lc.iterations} iterations; keyframe ATE {ate_odo:.6f} m (odometry) -> "
        f"{ate_opt:.6f} m (closed); map {len(m)} voxels, surface occupancy {occ_frac:.3f}, "
        f"centre states {states_f.tolist()}; BKI {1e3 * bki_s / len(kf_clouds):.1f} ms an insert")
    log(f"  iterations: {sum(i >= LOOP_ITER for i in iters)} of {len(iters)} pairs at the cap; "
        f"launches {launches}")
    checks = {"keyframes >= 5": len(kf_frames) >= 5, "fa_closure > 0.1 fa_tracking":
              bool(fa_lc > 0.1 * fa_ref), "ATE closed < odometry": bool(ate_opt < ate_odo),
              f"ATE closed < {LOOP_ATE_BOUND}": bool(ate_opt < LOOP_ATE_BOUND),
              "surface occupancy > 0.5": occ_frac > 0.5,
              "no phantom surface": bool((states_f != 1).all())}
    row["checks"] = checks
    bound = f"ATE closed < {LOOP_ATE_BOUND}"
    if not checks[bound]:
        jax_ate, spread = LOOP_JAX_MISS
        gap = abs(ate_opt - jax_ate)
        row["jax_miss"] = {"jax_ate_closed_m": jax_ate, "gap": gap, "spread": spread}
        log(f"  the closed ATE {ate_opt:.6f} m is above {LOOP_ATE_BOUND} as JAX's ({jax_ate:.6f} "
            f"on the same frames, CPU); {gap:.4g} apart, within the CPU runs' spread "
            f"{spread:.4g}: {gap <= spread}")
        checks[bound] = gap <= spread
    missed = [k for k, ok in checks.items() if not ok]
    if missed:
        raise SystemExit(f"phase 12b: missed {missed}")
    for name in ("select", "flow_reduce", "step_cached"):
        results[name]["launches_loop_closure"] = launches[name]
    return row


def bki_part(dev, smi):
    """Phase 12c: SemanticBKIMap at size, card against the port's CPU call:
    the host frontend's 8192-point clouds of the first BKI_FRAMES corridor
    frames in the world frame, 19-class label distributions drawn from a
    seeded numpy generator, free-space rays at 0.5 m. Keys equal, semantics
    equal, alpha rtol 1e-5; a second card map fed the same inserts is
    bit-equal."""
    from unified_cvo_tpu_torch.frontend import pipeline
    from unified_cvo_tpu_torch.models.bki import SemanticBKIMap
    from unified_cvo_tpu_torch.utils.pointcloud import to_numpy_valid

    calib, frames, traj = rgbd_frames(range(BKI_FRAMES))
    rng = np.random.default_rng(0)
    inserts = []
    for (rgb, d, _), T in zip(frames, traj):
        xyz = to_numpy_valid(pipeline.pointcloud_from_rgbd(
            rgb, d, calib, denoise=False, capacity=LM_CAPACITY, device=dev))["xyz"]
        labels = rng.dirichlet(np.ones(LM_CLASSES), len(xyz))
        inserts.append((xyz @ T[:3, :3].T + T[:3, 3], labels, T[:3, 3]))

    def new_map(d):
        return SemanticBKIMap(resolution=0.1, num_classes=LM_CLASSES, ell=0.3,
                              free_resolution=0.5, device=d)

    maps, ms = [new_map(dev), new_map(dev)], []
    for xyz, labels, origin in inserts:
        for m in maps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.insert_pointcloud(xyz, labels, origin=origin)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
    mk, mk2 = maps
    mc = new_map(torch.device("cpu"))
    t0 = time.perf_counter()
    for xyz, labels, origin in inserts:
        mc.insert_pointcloud(xyz, labels, origin=origin)
    cpu_s = time.perf_counter() - t0
    keys_eq, a_rel, sem_eq, a_exact = bki_gap(mk, mc)
    bit_eq = torch.equal(mk.keys, mk2.keys) and torch.equal(mk.alpha, mk2.alpha)
    row = {"frames": BKI_FRAMES, "points": [len(i[0]) for i in inserts], "voxels": len(mk),
           "insert_ms": ms[::2], "insert_ms_second_map": ms[1::2], "cpu_seconds": cpu_s,
           "keys_equal": keys_eq, "alpha_max_rel": a_rel, "alpha_bit_equal": a_exact,
           "semantics_equal": sem_eq, "two_inserts_bit_equal": bit_eq}
    log(f"phase 12c BKI at size ({BKI_FRAMES} frames of {row['points']} points, "
        f"{LM_CLASSES} classes, free rays at 0.5 m): {len(mk)} voxels; insert "
        f"{[round(x, 1) for x in ms[::2]]} ms (wall, synchronized) ({smi}); CPU {cpu_s:.1f} s")
    log(f"  card against CPU: keys equal {keys_eq}, alpha max rel {a_rel:.3g} (bit-equal "
        f"{a_exact}), semantics equal {sem_eq}; two card maps bit-equal {bit_eq}")
    if not (keys_eq and a_rel <= BKI_RTOL and sem_eq and bit_eq):
        raise SystemExit(f"phase 12c: {row}")
    return row


def incremental_chain(d):
    """Phase 12d's incremental run on device d: PG_INCREMENTAL keyframes
    PG_STEP m apart with seeded step noise and a skip-2 factor every 25
    keyframes. Returns (the PoseGraph, active subgraph sizes, seconds)."""
    from unified_cvo_tpu_torch.models import posegraph as pgm

    r = np.random.default_rng(5)
    pg = pgm.PoseGraph(pgm.PoseGraphConfig(incremental=True,
                                           keyframe_function_angle_threshold=1.0,
                                           optimize_iters=4), device=d)
    pg.add_first_frame(0)
    step = np.eye(4)
    step[:3, 3] = [0.0, 0.0, PG_STEP]
    active, t0 = [], time.perf_counter()
    for k in range(1, PG_INCREMENTAL):
        noisy = step.copy()
        noisy[:3, 3] += r.normal(0, 0.01, 3)
        extra = None
        if k % 25 == 0:
            rel = np.eye(4)
            rel[:3, 3] = 2 * step[:3, 3]
            extra = [pgm.RelativePose(curr_id=k, ref_id=k - 2, transform=rel,
                                      inner_product=0.5)]
        pg.add_frame(k, noisy, function_angle=0.5, extra_factors=extra)
        active.append(pg.last_active)
    return pg, active, time.perf_counter() - t0


def chain_gap(pk, pc):
    """The largest entry gap of two pose graphs' keyframe poses."""
    return max(float(np.abs(a - b).max()) for a, b in zip(pk.keyframe_poses, pc.keyframe_poses))


def posegraph_ablation():
    """--posegraph-ablation: phase 12d's incremental run, card against CPU,
    as the package solves it (each subgraph in its own frame) and with each
    subgraph solved in the world frame (float64 poses between steps in
    both). Prints the two gaps."""
    from unified_cvo_tpu_torch.models import posegraph as pgm

    solve = pgm.PoseGraph._solve
    for label, patched in (("subgraph frame", solve),
                           ("world frame", lambda self, S, sub, fixed_mask, prior=None,
                            anchor=None: solve(self, S, sub, fixed_mask, prior))):
        pgm.PoseGraph._solve = patched
        try:
            gap = chain_gap(incremental_chain(torch.device("cuda"))[0],
                            incremental_chain(torch.device("cpu"))[0])
        finally:
            pgm.PoseGraph._solve = solve
        log(f"posegraph ablation, {label}: {PG_INCREMENTAL} incremental keyframes, card "
            f"against CPU {gap:.3g}")


def pg_loop_args():
    """Phase 12d's CG loop (test_posegraph_bki.py's): PG_LOOP keyframes of
    seeded SE(3) steps, odometry factors with noise and three loop factors,
    keyframe 0 fixed. Returns (optimize_pose_graph's first six arguments,
    the true poses)."""
    from unified_cvo_tpu_torch.ops import lie

    rng = np.random.default_rng(0)

    def rand_se3(scale):
        R, t = lie.se3_exp(torch.from_numpy(scale * rng.normal(size=6).astype(np.float32)), 1.0)
        return lie.rt_to_mat44(R, t).numpy().astype(np.float64)

    true = [np.eye(4)]
    for _ in range(PG_LOOP - 1):
        true.append(true[-1] @ rand_se3(0.2))
    Zs, fi, fj = [], [], []
    for k in range(PG_LOOP - 1):
        Zs.append(np.linalg.inv(true[k]) @ true[k + 1] @ rand_se3(0.01))
        fi.append(k)
        fj.append(k + 1)
    for a, b in ((0, PG_LOOP - 1), (0, PG_LOOP // 2), (PG_LOOP // 2, PG_LOOP - 1)):
        Zs.append(np.linalg.inv(true[a]) @ true[b])
        fi.append(a)
        fj.append(b)
    init = [np.eye(4)]
    for k in range(PG_LOOP - 1):
        init.append(init[-1] @ Zs[k])
    fixed = np.zeros(PG_LOOP, np.float32)
    fixed[0] = 1.0
    return (np.stack(init).astype(np.float32), np.asarray(fi), np.asarray(fj),
            np.stack(Zs).astype(np.float32), np.ones(len(Zs), np.float32), fixed), true


def posegraph_part(dev, smi):
    """Phase 12d: the pose graph, card against CPU (poses within 1e-4):
    test_posegraph_bki.py's 200-keyframe loop solved by block PCG (15
    iterations), and PG_INCREMENTAL keyframes in incremental mode (its
    odometry with a skip-2 factor every 25 keyframes)."""
    from unified_cvo_tpu_torch.models import posegraph as pgm

    cpu = torch.device("cpu")
    args, true = pg_loop_args()

    def solve(d):
        return pgm.optimize_pose_graph(*args, iters=15, solver="cg", device=d)[0]

    ms_cg, out_k = event_ms(lambda: solve(dev))
    out_c = solve(cpu)
    cg_err = float((out_k.cpu() - out_c).abs().max())
    # run to run: the same solve twice more on the card, bit for bit (the
    # assembly's segment sums run in a fixed order)
    reruns = [solve(dev) for _ in range(2)]
    rerun_gap = max(float((r - out_k).abs().max()) for r in reruns)
    rerun_equal = all(torch.equal(r, out_k) for r in reruns)
    drift = [float(np.linalg.norm(p[:3, 3] - true[-1][:3, 3])) for p in (args[0][-1],
                                                                          out_k.cpu().numpy()[-1])]

    pk, active, inc_s = incremental_chain(dev)
    pc, _, inc_cpu_s = incremental_chain(cpu)
    inc_err = chain_gap(pk, pc)
    row = {"cg_loop": {"keyframes": PG_LOOP, "ms": ms_cg, "max_abs_vs_cpu": cg_err,
                       "max_abs_run_to_run": rerun_gap, "bit_equal_runs": rerun_equal,
                       "drift_before_after_m": drift},
           "incremental": {"keyframes": PG_INCREMENTAL, "ms_a_keyframe": 1e3 * inc_s /
                           (PG_INCREMENTAL - 1), "cpu_ms_a_keyframe": 1e3 * inc_cpu_s /
                           (PG_INCREMENTAL - 1), "max_active": max(active),
                           "max_abs_vs_cpu": inc_err}}
    log(f"phase 12d pose graph: {PG_LOOP}-keyframe loop by CG, {ms_cg:.1f} ms a solve (CUDA "
        f"events), card against CPU {cg_err:.3g}, three card runs apart by {rerun_gap:.3g} "
        f"({'bit-equal' if rerun_equal else 'NOT bit-equal'}), "
        f"drift {drift[0]:.3f} -> {drift[1]:.4f} m; "
        f"{PG_INCREMENTAL} keyframes incremental: {row['incremental']['ms_a_keyframe']:.2f} ms "
        f"a keyframe (CPU {row['incremental']['cpu_ms_a_keyframe']:.2f}), active subgraph <= "
        f"{max(active)}, card against CPU {inc_err:.3g} ({smi})")
    if not (cg_err <= PG_TOL and inc_err <= PG_TOL and drift[1] < 0.2 * drift[0] + 1e-3
            and rerun_equal):
        raise SystemExit(f"phase 12d: {row}")
    return row


def slam_phase(dev, smi, results):
    """Phase 12: the SLAM back end (12a local mapping, 12b loop closure,
    12c BKI at size, 12d pose graph)."""
    out = {}
    for name, fn in (("local_mapping", lambda: local_mapping_part(dev, smi, results)),
                     ("loop_closure", lambda: loop_closure_part(dev, smi, results)),
                     ("bki", lambda: bki_part(dev, smi)),
                     ("posegraph", lambda: posegraph_part(dev, smi))):
        t0 = time.perf_counter()
        out[name] = fn()
        log(f"phase 12 {name}: {time.perf_counter() - t0:.2f} s")
    return out


# ---- phase 13: the lidar frontend (LOAM, LeGO-LOAM), the lidar drivers, the PCD demo
LIDAR_BEAMS, LIDAR_AZ = 64, 1800     # HDL-64E: 64 beams x 1800 azimuth steps (0.2 deg)
LIDAR_FOV = (-2.0, 24.9)             # its elevations (deg below level), LeGO-LOAM's geometry
LIDAR_FRAMES = 4                     # 13a: 3 pairs
LIDAR_ITER = 300                     # test_e2e_accuracy.py's lidar cap
LIDAR_YAML = ("ell_init: 0.5\nell_init_first_frame: 0.8\nell_min: 0.05\n"
              "ell_max: 1.2\nis_using_intensity: 1\n")   # test_e2e_accuracy.py's lidar YAML
LIDAR_SEMANTIC = "is_using_semantics: 1\ns_ell: 0.5\ns_sigma: 0.8\n"
LIDAR_ATE_BOUND, LIDAR_RPE_BOUND = 0.08, 0.12   # test_e2e_accuracy.py's lidar bounds
LYFT_BEAMS, LYFT_FRAMES = 40, 3      # 13c: 2 pairs in the Lyft room
LYFT_ATE_BOUND = 0.1                 # test_e2e_accuracy.py's Lyft bound
PCD_POINTS = 16384                   # 13d: points of each demo cloud


def lidar_sequences(root):
    """Phase 13's rendered sequences on disk: the KITTI lidar room (velodyne
    and height-band SemanticKITTI labels, LIDAR_FRAMES frames) and the Lyft
    room (LYFT_FRAMES sweeps). Returns (kitti_dir, traj, lyft_dir, lyft_traj)."""
    import os

    from unified_cvo_tpu_torch.utils import synth

    kdir, ldir = os.path.join(root, "kitti"), os.path.join(root, "lyft")
    traj = synth.corridor_trajectory(LIDAR_FRAMES, step=0.15, yaw_rate=0.02, bob=0.0)
    synth.write_kitti_lidar_sequence(
        kdir, synth.room_scene(11, half=8.0, floor_y=1.8, ceil_y=-3.0, n_pillars=4), traj,
        n_beams=LIDAR_BEAMS, n_az=LIDAR_AZ, noise=0.005, fov_deg=LIDAR_FOV, labels=True)
    ltraj = synth.corridor_trajectory(LYFT_FRAMES, step=0.2, yaw_rate=0.02, bob=0.0)
    synth.write_lyft_lidar_sequence(
        ldir, synth.room_scene(13, half=9.0, floor_y=1.8, ceil_y=-3.0, n_pillars=4), ltraj,
        n_beams=LYFT_BEAMS, n_az=LIDAR_AZ, noise=0.005, fov_deg=LIDAR_FOV)
    for name, text in (("lidar.yaml", LIDAR_YAML), ("semantic.yaml", LIDAR_YAML + LIDAR_SEMANTIC)):
        with open(os.path.join(root, name), "w") as f:
            f.write(text)
    return kdir, traj, ldir, ltraj


def equal_or_exit(a, b, what):
    if not torch.equal(a.cpu(), b.cpu()):
        raise SystemExit(f"phase 13: {what} on the card differs from the CPU's")


def lidar_frontend_checks(scan, dev, smi, results):
    """13a on frame 0: the LOAM stages and LeGO-LOAM stages on the card
    against the port's CPU calls (equal, bit for bit), L1 and L2 against
    their plain versions on the card (equal) and launched twice (equal),
    then the frontends' card ms (CUDA events) and launches a scan
    (torch.profiler), and L1 / L2 against their bounds and plain versions.
    Fills results' lidar_components and lidar_loam_features rows."""
    from unified_cvo_tpu_torch.apps import kitti_lidar_odometry as kl
    from unified_cvo_tpu_torch.frontend import lidar as fl
    from unified_cvo_tpu_torch.ops import lidar as lops

    cpu = torch.device("cpu")
    xyz_c = torch.from_numpy(np.ascontiguousarray(scan[:, :3], np.float32))
    int_c = torch.from_numpy(np.ascontiguousarray(scan[:, 3], np.float32))
    xyz_k, int_k = xyz_c.to(dev), int_c.to(dev)
    def lego_links(x):
        ri, ii = fl.project_range_image(x)
        return fl.segment_links(ri, fl.ground_mask_range_image(x, ii))

    st = []                                    # the CPU's stages, then the card's
    for x, i in ((xyz_c, int_c), (xyz_k, int_k)):
        r = fl.ring_ids(x)
        ri, ii = fl.project_range_image(x)
        g = fl.ground_mask_range_image(x, ii)
        lv, lh, valid = fl.segment_links(ri, g)
        labels = lops.components(lv, lh)
        seg = fl.feasible_clusters(labels, valid)
        keep = seg & (ii >= 0)
        kind, rest = lops.loam_features(ri, keep)
        e_idx, s_idx = fl.legoloam_select(x)
        st.append({
            "rings": r, "edges": fl.edge_detection(x, i, r), "curvature": fl.loam_curvature(x, r),
            "surfaces": fl.surface_selection(x, r, 10000), "range image": ri, "index image": ii,
            "ground": g, "vertical links": lv, "horizontal links": lh, "components": labels,
            "segmented": seg, "keep": keep, "LOAM feature kinds": kind,
            "rest counts": rest, "LeGO-LOAM edges": e_idx, "LeGO-LOAM surfaces": s_idx})
    for name in st[0]:
        equal_or_exit(st[1][name], st[0][name], name)
    for method in ("loam", "legoloam"):
        ck = fl.pointcloud_from_lidar(scan, capacity=kl.CAPACITY, method=method, device=dev)
        cc = fl.pointcloud_from_lidar(scan, capacity=kl.CAPACITY, method=method, device=cpu)
        for f in ("xyz", "mask", "features", "geometric_types"):
            equal_or_exit(getattr(ck, f), getattr(cc, f), f"the {method} cloud's {f}")
    k = st[1]
    lv, lh, keep, ri = k["vertical links"], k["horizontal links"], k["keep"], k["range image"]
    runs = [lops.components(lv, lh) for _ in range(2)]
    plain = lops.components_plain(lv, lh)
    if not (torch.equal(runs[0], runs[1]) and torch.equal(runs[0], plain)):
        raise SystemExit("phase 13: L1 (components) differs from its plain version or between "
                         "two launches")
    fruns = [lops.loam_features(ri, keep) for _ in range(2)]
    fplain = lops.loam_features_plain(ri, keep)
    if not all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(fruns[0], fruns[1], fplain)):
        raise SystemExit("phase 13: L2 (loam_features) differs from its plain version or "
                         "between two launches")
    torch.cuda.synchronize()
    n_cells = ri.numel()
    n_comp = int(torch.unique(plain[k["segmented"]]).numel())
    kind = fplain[0]
    log(f"phase 13 frontend, card against CPU on frame 0 ({len(scan)} rays): rings, edges "
        f"({int(k['edges'].sum())}), curvature, surfaces ({int(k['surfaces'].sum())}), the "
        f"clouds, range image ({int((k['index image'] >= 0).sum())} of {n_cells} cells filled), "
        f"ground ({int(k['ground'].sum())}), links, components, segmented "
        f"({int(k['segmented'].sum())} cells in {n_comp} kept clusters), LOAM features "
        f"({int((kind == lops.EDGE).sum())} edges, {int((kind == lops.REST).sum())} rest), "
        f"LeGO-LOAM picks ({len(k['LeGO-LOAM edges'])} edges, "
        f"{len(k['LeGO-LOAM surfaces'])} surfaces) all equal; L1 and L2 equal to their plain "
        f"versions on the card, two launches bit-equal")

    stages = stage_times({
        "LOAM frontend (pointcloud_from_lidar, upload included)":
            lambda: fl.pointcloud_from_lidar(scan, capacity=kl.CAPACITY, device=dev),
        "LeGO-LOAM frontend (pointcloud_from_lidar, method legoloam, upload included)":
            lambda: fl.pointcloud_from_lidar(scan, capacity=kl.CAPACITY, method="legoloam",
                                             device=dev),
        "range image, ground and links (torch)": lambda: lego_links(xyz_k),
    }, smi)
    rows, cols = ri.shape
    rows_of = {
        "lidar_components": (
            lambda: lops.components(lv, lh), lambda: lops.components_plain(lv, lh),
            bound(lv.numel() + lh.numel() + 4 * n_cells, 0),
            "unified_cvo_tpu/frontend/lidar.py:202 (segment_range_image: scipy "
            "connected_components on the host; no Pallas kernel)"),
        "lidar_loam_features": (
            lambda: lops.loam_features(ri, keep), lambda: lops.loam_features_plain(ri, keep),
            bound(5 * n_cells + n_cells + 4 * rows * lops.N_SECTORS, 0),
            "unified_cvo_tpu/frontend/lidar.py:266 (_loam_extract_features: a Python loop "
            "on the host; no Pallas kernel)")}
    for name, (kfn, pfn, (b_ms, b_by), replaces) in rows_of.items():
        ms = device_ms(kfn)
        plain_ms, _ = event_ms(pfn)
        n_dev = kernels_per_call(kfn)
        results[name] = {
            "name": name, "route": "cuda", "source": "unified_cvo_tpu_torch/csrc/lidar.cu",
            "replaces": replaces, "launches": None, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "launches_per_call": n_dev, "shape": [rows, cols]}
        log(f"time   {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events, one "
            f"call), bound {b_ms:.6f} ms ({b_by}), {n_dev} device kernels a call (graph "
            f"nodes) ({smi})")
    floor_ms, ring = loam_floor_ms(ri, keep)
    results["lidar_loam_features"].update(latency_floor_ms=floor_ms, latency_ring=ring)
    log(f"       lidar_loam_features: latency floor {floor_ms:.4f} ms (ring {ring} of {rows} "
        f"launched alone, {int(keep[ring].sum())} kept columns) ({smi})")
    return {"frontend": stages, "filled_cells": int((k["index image"] >= 0).sum()),
            "segmented_cells": int(k["segmented"].sum()), "clusters": n_comp,
            "edges_loam": int(k["edges"].sum()), "surfaces_loam": int(k["surfaces"].sum()),
            "edges_legoloam": len(k["LeGO-LOAM edges"]),
            "surfaces_legoloam": len(k["LeGO-LOAM surfaces"])}


def lidar_report(label, poses, traj, records, seconds, launches, smi, ate_bound=None,
                 rpe_bound=None):
    """A lidar driver run: pose errors against the rendered trajectory, ATE,
    RPE, align ms, iterations, builds and the builder of each pair, fps.
    Raises unless every pair ran 'ell' with ret 0, the flow and step
    launches equal the iterations (geometry x channel variant), select ran
    once per grid build, and the ATE / RPE are below their bounds."""
    from unified_cvo_tpu_torch.apps import f2f_sequence as f2f
    from unified_cvo_tpu_torch.utils import metrics

    n = len(records)
    rel = [np.linalg.inv(poses[k]) @ poses[k + 1] for k in range(n)]
    true = [np.linalg.inv(traj[k + 1]) @ traj[k] for k in range(n)]
    iters = [r.info.iterations for r in records]
    builds = [r.info.nl_rebuilds for r in records]
    builders = [r.info.nl_builder for r in records]
    grid_builds = sum(b for b, kind in zip(builds, builders) if kind == "grid")
    row = {"pairs": n, "seconds": seconds, "fps": n / seconds,
           "ms_a_pair": 1e3 * seconds / n,
           "align_ms": [1e3 * r.wait_seconds for r in records],
           "frontend_enqueue_ms": [1e3 * r.frontend_seconds for r in records],
           "iterations": iters, "builds": builds, "builders": builders,
           "final_ell": [float(r.info.final_ell) for r in records],
           "pose_errors": f2f.pose_errors(rel, true),
           "ate_m": metrics.ate_rmse(traj[:len(poses)], poses),
           "rpe_m": metrics.rpe_rmse(traj[:len(poses)], poses),
           "launches": {k: launches[k] for k in ("select", "flow_reduce", "step_cached")}}
    log(f"{label}: {n} pairs in {seconds:.3f} s, {row['ms_a_pair']:.1f} ms a pair, "
        f"{row['fps']:.4f} aligned frames/s (driver, reader and frontend included) ({smi})")
    log(f"  builders {builders}, iterations {iters}, builds {builds}, final ell "
        f"{[round(x, 6) for x in row['final_ell']]}, align ms "
        f"{[round(x, 1) for x in row['align_ms']]}")
    log(f"  pose error |xi| per pair {[round(e, 6) for e in row['pose_errors']]}; ATE "
        f"{row['ate_m']:.6f} m, RPE {row['rpe_m']:.6f} m; launches {launches}")
    if not all(r.ret == 0 and r.info.backend == "ell" for r in records):
        raise SystemExit(f"{label}: a pair did not run 'ell', or its flow was degenerate")
    if not (launches["flow_reduce_by_variant"].get("geo_chan") == launches["flow_reduce"]
            == launches["step_cached"] == sum(iters) > 0 and launches["select"] >= grid_builds):
        raise SystemExit(f"{label}: launch counts {launches} do not match {sum(iters)} "
                         f"iterations and {grid_builds} grid builds")
    if ate_bound is not None and not row["ate_m"] < ate_bound:
        raise SystemExit(f"{label}: ATE {row['ate_m']} is not below {ate_bound}")
    if rpe_bound is not None and not row["rpe_m"] < rpe_bound:
        raise SystemExit(f"{label}: RPE {row['rpe_m']} is not below {rpe_bound}")
    return row


def pcd_pair(scans, path_a, path_b):
    """13d's two XYZRGB PCDs: PCD_POINTS points of each of two lidar scans
    (every k-th ray), coloured by intensity."""
    from unified_cvo_tpu_torch.datasets import pcd

    for scan, path in zip(scans, (path_a, path_b)):
        pick = np.linspace(0, len(scan) - 1, PCD_POINTS).astype(np.int64)
        grey = np.clip(scan[pick, 3:4], 0.0, 1.0)
        pcd.write_pcd(path, scan[pick, :3], np.repeat(grey, 3, axis=1))


def lidar_phase(dev, smi, results):
    """Phase 13: the lidar path at full width on the card. 13a: 4 rendered
    HDL-64 frames (64 x 1800 rays, the lidar room of test_e2e_accuracy.py)
    written as velodyne files; frame 0's frontend on the card against the
    CPU (lidar_frontend_checks); kernels 1-3 against their plain versions on
    the driver's clouds of frames 0 and 1; kitti_lidar_odometry.run_sequence
    (capacity 16384, 300 iterations) under the lidar ATE / RPE bounds; one
    pair with method='legoloam' (L1 and L2 launched once a frame). 13b: one
    pair with --semantic (19 classes, height-band labels). 13c: 2 Lyft
    pairs (40 beams) with the driver's own ell override, under the Lyft ATE
    bound. 13d: align_two_pcd on two 16384-point XYZRGB PCDs; the function
    angle must grow."""
    import os
    import tempfile

    from unified_cvo_tpu_torch.apps import align_two_pcd
    from unified_cvo_tpu_torch.apps import kitti_lidar_odometry as kl
    from unified_cvo_tpu_torch.apps import lyft_lidar_odometry as ll
    from unified_cvo_tpu_torch.config import read_cvo_params_yaml
    from unified_cvo_tpu_torch.datasets.kitti import KittiHandler
    from unified_cvo_tpu_torch.frontend import lidar as fl
    from unified_cvo_tpu_torch.ops import lidar as lops

    out = {}
    quiet = lambda *a: None                                   # noqa: E731
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lidar_") as root:
        t0 = time.perf_counter()
        kdir, traj, ldir, ltraj = lidar_sequences(root)
        yaml, sem_yaml = os.path.join(root, "lidar.yaml"), os.path.join(root, "semantic.yaml")
        log(f"phase 13: {LIDAR_FRAMES} KITTI and {LYFT_FRAMES} Lyft scans rendered at "
            f"{LIDAR_BEAMS} / {LYFT_BEAMS} x {LIDAR_AZ} rays and written in "
            f"{time.perf_counter() - t0:.2f} s (host)")
        reader = KittiHandler(kdir, "lidar")
        scans = []
        for _ in range(2):
            scans.append(reader.read_next_lidar())
            reader.next()
        out["frontend_checks"] = lidar_frontend_checks(scans[0], dev, smi, results)
        out["velodyne_sweep"] = velodyne_sweep_checks(dev, smi)
        out["loam_cases"] = loam_case_checks(dev, smi, results)
        params = read_cvo_params_yaml(yaml)
        clouds = [fl.pointcloud_from_lidar(s, capacity=kl.CAPACITY, device=dev) for s in scans]
        valid = [int(c.mask.sum()) for c in clouds]
        driver_kernel_checks(clouds[0], clouds[1], np.linalg.inv(traj[0]) @ traj[1], params,
                             dev, results, "phase 13a frames 0 -> 1")
        del clouds

        # 13a: the KITTI lidar driver over the files
        reset_launch_counts()
        records = []
        t0 = time.perf_counter()
        poses = kl.run_sequence(kdir, yaml, os.path.join(root, "traj.txt"), max_iter=LIDAR_ITER,
                                log=quiet, device=dev, records=records)
        torch.cuda.synchronize()
        launches = launch_counts()
        out["kitti"] = lidar_report(
            "phase 13a KITTI lidar driver (kitti_lidar_odometry.run_sequence)", poses, traj,
            records, time.perf_counter() - t0, launches, smi, LIDAR_ATE_BOUND, LIDAR_RPE_BOUND)
        out["kitti"]["valid_points"] = valid
        for name in ("select", "flow_reduce", "step_cached"):
            results[name]["launches_lidar"] = launches[name]

        # 13a: one pair through the LeGO-LOAM frontend: L1 and L2 on the path
        reset_launch_counts()
        lops.reset_launches()
        t0 = time.perf_counter()
        lposes, records = kl.run_frames(scans, params, capacity=kl.CAPACITY, max_iter=LIDAR_ITER,
                                        method="legoloam", log=quiet, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        llaunch = {"lidar_components": lops.components.launches,
                   "lidar_loam_features": lops.loam_features.launches}
        out["legoloam"] = lidar_report(
            "phase 13a LeGO-LOAM pair (kitti_lidar_odometry.run_frames, method legoloam)",
            lposes, traj, records, seconds, launch_counts(), smi, rpe_bound=LIDAR_RPE_BOUND)
        log(f"  L1 / L2 launches in the pair: {llaunch} (2 frames)")
        if llaunch != {"lidar_components": 2, "lidar_loam_features": 2}:
            raise SystemExit(f"phase 13a: the LeGO-LOAM pair launched {llaunch}, not L1 and L2 "
                             f"once a frame")
        for name, n in llaunch.items():
            results[name]["launches"] = n

        # 13b: one semantic pair (19 classes)
        reset_launch_counts()
        records = []
        t0 = time.perf_counter()
        sposes = kl.run_sequence(kdir, sem_yaml, os.path.join(root, "sem.txt"), max_frames=2,
                                 max_iter=LIDAR_ITER, semantic=True, log=quiet, device=dev,
                                 records=records)
        torch.cuda.synchronize()
        out["semantic"] = lidar_report(
            "phase 13b semantic lidar pair (kitti_lidar_odometry.run_sequence, --semantic)",
            sposes, traj, records, time.perf_counter() - t0, launch_counts(), smi,
            rpe_bound=LIDAR_RPE_BOUND)

        # 13c: the Lyft driver, its own ell override
        reset_launch_counts()
        records = []
        t0 = time.perf_counter()
        lyft_poses = ll.run_sequence(ldir, yaml, os.path.join(root, "lyft.txt"),
                                     max_iter=LIDAR_ITER, log=quiet, device=dev,
                                     records=records)
        torch.cuda.synchronize()
        out["lyft"] = lidar_report(
            "phase 13c Lyft driver (lyft_lidar_odometry.run_sequence, ell_init 1.0, ell_max "
            "2.2)", lyft_poses, ltraj, records, time.perf_counter() - t0, launch_counts(), smi,
            LYFT_ATE_BOUND)

        # 13d: the PCD demo
        src, tgt = os.path.join(root, "source.pcd"), os.path.join(root, "target.pcd")
        pcd_pair(scans, src, tgt)
        t0 = time.perf_counter()
        demo = align_two_pcd.align_two(src, tgt, yaml, max_iter=LIDAR_ITER, out_dir=root,
                                       log=quiet, device=dev)
        info = demo["info"]
        out["pcd"] = {"seconds": time.perf_counter() - t0, "cold_s": demo["cold_s"],
                      "warm_s": demo["warm_s"], "iterations": info.iterations,
                      "builder": info.nl_builder, "backend": info.backend,
                      "cos_before": demo["cos_before"], "cos_after": demo["cos_after"]}
        log(f"phase 13d PCD demo (align_two_pcd, {PCD_POINTS} points a cloud): {info.backend} + "
            f"{info.nl_builder}, {info.iterations} iterations, warm align {demo['warm_s']:.3f} s "
            f"(cold {demo['cold_s']:.3f} s), function_angle {demo['cos_before']:.6f} -> "
            f"{demo['cos_after']:.6f} ({smi})")
        if not (demo["ret"] == 0 and demo["cos_after"] > demo["cos_before"]):
            raise SystemExit(f"phase 13d: the function angle did not grow ({out['pcd']})")
    return out


# ---- phase 14: PNG input without OpenCV, cv2's NL-means, the BA apps
BA_TUM_POSES = (0, 2, 4, 6, 8)       # 14a/14d: test_e2e_accuracy.py's BA frames of the
                                     # TUM corridor, at 640 x 480
BA_TUM_EDGES = ((0, 1), (1, 2), (2, 3), (3, 4), (0, 2), (1, 3), (2, 4))
# test_e2e_accuracy.py's IRLS YAML with a voxel of 0.05 m (about 50500 points a
# frame, edges at 0.0125): 32768 or more a frame, so the auto backend is 'ell'
IRLS_TUM_VOXEL = 0.05
IRLS_TUM_YAML = ("ell_init: 0.1\nell_min: 0.05\nsigma: 0.1\nsp_thres: 0.003\nc: 7.0\n"
                 "d: 7.0\nc_ell: 0.025\nc_sigma: 1.0\nis_using_intensity: 1\n"
                 "is_using_geometric_type: 1\nmultiframe_max_iters: 60\n"
                 "multiframe_ell_init: 0.4\nmultiframe_ell_min: 0.1\n"
                 "multiframe_ell_decay_rate: 0.85\nmultiframe_iterations_per_ell: 10\n"
                 f"multiframe_downsample_voxel_size: {IRLS_TUM_VOXEL}\n"
                 "multiframe_iterations_per_solve: 20\nmultiframe_min_nonzeros: 100\n")
# 14c: the TUM fixture's corridor and step through the TartanAir camera (640 x 480,
# fx 320), 1 pair (JAX on the CPU: 0.0406; 2 pairs before the e2e corridor below
# came, whose time this cut pays for)
TARTAN_FRAMES = 2
# then test_e2e_accuracy.py's TartanAir corridor itself (scene seed 9, half width
# 3 m, 0.1 m a step), 3 frames: its pair 1 ends 0.0859 from the rendered pose in
# JAX on the CPU as well, after 1500 iterations at ell 0.05, so it is held to JAX's
# spread (JAX_MISSES["phase 14c corridor"], ROADMAP section 3)
E2E_CORRIDOR_SCENE = dict(seed=9, half_width=3.0, floor_y=1.4, ceil_y=-1.6, length=30.0)
E2E_CORRIDOR_TRAJ = dict(n=3, step=0.1, yaw_rate=0.015, bob=0.004)
# the colour YAML of tests/test_torch_odometry.py (the reference's
# cvo_rgbd_params.yaml is not in the repo) with bench.py's iteration cap
TARTAN_YAML = ("ell_init: 0.5\nell_init_first_frame: 0.5\nell_min: 0.05\nell_max: 1.0\n"
               "is_using_intensity: 1\nMAX_ITER: 1500\n")
# test_apps_drivers.py's YAML for the TartanAir BA apps (voxel 0.3 and 1.2)
TARTAN_BA_YAML = ("ell_init: 0.5\nell_init_first_frame: 0.5\nell_min: 0.05\nell_max: 1.0\n"
                  "max_iter: 60\nis_using_intensity: 1\nmultiframe_ell_init: 0.5\n"
                  "multiframe_ell_min: 0.15\nmultiframe_ell_decay_rate: 0.7\n"
                  "multiframe_max_iters: 10\nmultiframe_iterations_per_solve: 4\n"
                  "multiframe_min_nonzeros: 10\nmultiframe_downsample_voxel_size: {}\n")


def write_e2e_corridor(root):
    """test_e2e_accuracy.py's TartanAir corridor (E2E_CORRIDOR_*) in the
    TartanAir layout under root/tartan_e2e. Returns (dir, trajectory)."""
    import os

    from unified_cvo_tpu_torch.utils import synth

    d = os.path.join(root, "tartan_e2e")
    scene = synth.corridor_scene(E2E_CORRIDOR_SCENE["seed"], **{
        k: v for k, v in E2E_CORRIDOR_SCENE.items() if k != "seed"})
    traj = synth.corridor_trajectory(E2E_CORRIDOR_TRAJ["n"], **{
        k: v for k, v in E2E_CORRIDOR_TRAJ.items() if k != "n"})
    synth.write_tartan_sequence(d, scene, traj)
    return d, traj


def perturbed(gt, rng, t_sigma=0.03, r_sigma=0.015):
    """test_e2e_accuracy.py's initial BA poses: each frame but the first
    moved by a seeded translation and rotation."""
    init = gt.copy()
    for k in range(1, len(init)):
        init[k, :3, 3] += rng.normal(0, t_sigma, 3)
        w = rng.normal(0, r_sigma, 3)
        th = np.linalg.norm(w)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        dR = np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th**2 * (K @ K)
        init[k, :3, :3] = init[k, :3, :3] @ dR
    return init


def png_phase(root, smi):
    """14a: a TUM sequence (BGR and 16-bit depth at 640 x 480) and a TartanAir
    one written with the port's PNG writer, decoded back exactly, decode
    times on the host with cv2's Sub rows and with Average and Paeth rows.
    Returns (tum_dir, tum calib, BA ground truth, tartan_dir, tartan
    trajectory, row)."""
    import os

    from unified_cvo_tpu_torch.datasets import png
    from unified_cvo_tpu_torch.datasets.tartanair import TARTANAIR_K
    from unified_cvo_tpu_torch.frontend.calibration import Calibration
    from unified_cvo_tpu_torch.utils import synth

    t0 = time.perf_counter()
    calib = _camera(Calibration, **TUM_CAMERA)
    scene = synth.corridor_scene(5, half_width=2.5, floor_y=1.2, ceil_y=-1.2, length=30.0)
    gt = synth.corridor_trajectory(max(BA_TUM_POSES) + 1, step=0.08, yaw_rate=0.015,
                                   bob=0.005)[list(BA_TUM_POSES)]
    tdir = os.path.join(root, "tum")
    synth.write_tum_sequence(tdir, scene, gt, calib)
    ttraj = synth.corridor_trajectory(TARTAN_FRAMES, step=0.08, yaw_rate=0.015, bob=0.005)
    adir = os.path.join(root, "tartan")
    synth.write_tartan_sequence(adir, scene, ttraj)
    write_s = time.perf_counter() - t0
    tcal = Calibration(TARTANAIR_K.copy(), depth_scale=1.0, cols=640, rows=480)
    checked = 0
    for (bgr, d16, ts), T in zip(synth.tum_frames(scene, gt, calib), gt):
        rgb_p, dep_p = (os.path.join(tdir, k, f"{ts}.png") for k in ("rgb", "depth"))
        if not (np.array_equal(png.imread(rgb_p), bgr)
                and np.array_equal(png.imread(dep_p, unchanged=True), d16)):
            raise SystemExit(f"phase 14a: {ts} does not decode to the frame written")
        checked += 2
    for i, T in enumerate(ttraj):
        bgr, _ = synth.render_frame(scene, tcal, T)
        if not np.array_equal(png.imread(os.path.join(adir, "image_left",
                                                      f"{i:06d}_left.png")), bgr):
            raise SystemExit(f"phase 14a: TartanAir frame {i} does not decode to the frame "
                             f"written")
        checked += 1
    ts0 = f"{1000.0:.4f}"
    # frame 0 again with Average and Paeth rows (filters 3, 4): files written
    # with adaptive filters take the decoder's anti-diagonal path
    bgr0, d160, _ = next(synth.tum_frames(scene, gt, calib))
    avg_paeth = {}
    for name, img in (("bgr", bgr0), ("depth16", d160)):
        avg_paeth[name] = os.path.join(root, f"{name}_avg_paeth.png")
        png.imwrite(avg_paeth[name], img, filters=(3, 4))
        if not np.array_equal(png.imread(avg_paeth[name], unchanged=name == "depth16"), img):
            raise SystemExit(f"phase 14a: the {name} frame written with Average and Paeth "
                             f"rows does not decode to the frame written")
        checked += 1
    times = {}
    for name, path, unchanged in (
            ("bgr_640x480", os.path.join(tdir, "rgb", f"{ts0}.png"), False),
            ("depth16_640x480", os.path.join(tdir, "depth", f"{ts0}.png"), True),
            ("bgr_640x480_avg_paeth", avg_paeth["bgr"], False),
            ("depth16_640x480_avg_paeth", avg_paeth["depth16"], True)):
        runs = []
        for _ in range(5):
            t = time.perf_counter()
            png.imread(path, unchanged)
            runs.append(1e3 * (time.perf_counter() - t))
        times[name] = statistics.median(runs)
    log(f"phase 14a: {len(gt)} TUM frames (BGR + 16-bit depth) and {len(ttraj)} TartanAir "
        f"frames rendered and written with datasets/png.py in {write_s:.2f} s; {checked} "
        f"PNGs decode to the frames written; decode (host, median of 5) BGR 640 x 480 "
        f"{times['bgr_640x480']:.2f} ms, 16-bit depth {times['depth16_640x480']:.2f} ms "
        f"(Sub rows); with Average and Paeth rows {times['bgr_640x480_avg_paeth']:.2f} / "
        f"{times['depth16_640x480_avg_paeth']:.2f} ms ({smi})")
    return tdir, calib, gt, adir, ttraj, {"decode_ms": times, "pngs_checked": checked,
                                         "write_s": write_s}


def nlm_opencv_phase(bgr, dev, smi):
    """14b: the exact NL-means on frame 0 with a white block, colour and
    grey, card against the port's CPU call (torch.equal), two card launches
    bit-equal, the block white; card ms (CUDA events) and device kernels a
    call (torch.profiler)."""
    from unified_cvo_tpu_torch.ops import nlm_opencv as nlmo

    # a 64 x 64 block of white: the estimate sums come within 2^31 of
    # overflowing there, and the block must come out white (cv2: 255 grey,
    # 254 colour after the Lab round trip)
    bgr = bgr.copy()
    bgr[100:164, 100:164] = 255
    b, g, r = (bgr[..., i].astype(np.int64) for i in range(3))
    grey = ((1868 * b + 9617 * g + 4899 * r + 8192) >> 14).astype(np.uint8)
    row = {}
    for name, img, fn in (("colour", bgr, nlmo.fast_nl_means_denoising_colored),
                          ("grey", grey, nlmo.nlm_opencv)):
        t_c = torch.from_numpy(np.ascontiguousarray(img))
        t0 = time.perf_counter()
        want = fn(t_c)
        cpu_s = time.perf_counter() - t0
        t_k = t_c.to(dev)
        runs = [fn(t_k) for _ in range(2)]
        torch.cuda.synchronize()
        if not (torch.equal(runs[0].cpu(), want) and torch.equal(runs[0], runs[1])):
            raise SystemExit(f"phase 14b: the {name} NL-means on the card differs from the "
                             f"CPU's or between two launches")
        if int(runs[0][120:144, 120:144].min()) < 254:
            raise SystemExit(f"phase 14b: the {name} NL-means darkens the white block "
                             f"(to {int(runs[0][120:144, 120:144].min())})")
        ms, _ = event_ms(lambda: fn(t_k))
        n, busy = profiled(lambda: fn(t_k))
        row[name] = {"ms": ms, "launches": n, "device_busy_ms": busy, "cpu_s": cpu_s,
                     "changed_pixels": int((want != t_c).any(-1).sum() if want.ndim == 3
                                           else (want != t_c).sum())}
        log(f"phase 14b exact NL-means ({name}, {img.shape[1]} x {img.shape[0]}, a 64 x 64 "
            f"white block): card equal to the CPU (torch.equal), two launches bit-equal, "
            f"the block white; {ms:.2f} ms (CUDA events), "
            f"{n} device kernels+copies a call, busy {busy:.2f} ms; CPU {cpu_s:.1f} s ({smi})")
    return row


def velodyne_sweep_checks(dev, smi):
    """13a's velodyne-order case: frame 0 of the lidar room with each beam
    sweeping azimuth the other way, so that ring_ids cuts a ring at every
    4 -> 1 quadrant wrap; the LOAM stages and cloud on the card against the
    CPU (torch.equal)."""
    from unified_cvo_tpu_torch.apps import kitti_lidar_odometry as kl
    from unified_cvo_tpu_torch.frontend import lidar as fl
    from unified_cvo_tpu_torch.utils import synth

    T = synth.corridor_trajectory(1, step=0.15, yaw_rate=0.02, bob=0.0)[0]
    scene = synth.room_scene(11, half=8.0, floor_y=1.8, ceil_y=-3.0, n_pillars=4)
    scan = synth.render_lidar_scan(scene, T, n_beams=LIDAR_BEAMS, n_az=LIDAR_AZ,
                                   fov_deg=LIDAR_FOV, noise=0.005, seed=0,
                                   velodyne_sweep=True)
    st = []
    for d in (torch.device("cpu"), dev):
        x = torch.from_numpy(np.ascontiguousarray(scan[:, :3])).to(d)
        i = torch.from_numpy(np.ascontiguousarray(scan[:, 3])).to(d)
        r = fl.ring_ids(x)
        st.append({"rings": r, "edges": fl.edge_detection(x, i, r),
                   "curvature": fl.loam_curvature(x, r),
                   "surfaces": fl.surface_selection(x, r, 10000)})
    for name in st[0]:
        equal_or_exit(st[1][name], st[0][name], f"the velodyne-sweep scan's {name}")
    ck = fl.pointcloud_from_lidar(scan, capacity=kl.CAPACITY, device=dev)
    cc = fl.pointcloud_from_lidar(scan, capacity=kl.CAPACITY, device=torch.device("cpu"))
    for f in ("xyz", "mask", "features", "geometric_types"):
        equal_or_exit(getattr(ck, f), getattr(cc, f), f"the velodyne-sweep LOAM cloud's {f}")
    rings = int(st[0]["rings"].max()) + 1
    if rings < 2:
        raise SystemExit(f"phase 13a: the velodyne-sweep scan holds {rings} ring")
    log(f"phase 13a velodyne sweep ({len(scan)} rays, {rings} rings by ring_ids): rings, "
        f"edges ({int(st[0]['edges'].sum())}), curvature, surfaces "
        f"({int(st[0]['surfaces'].sum())}) and the LOAM cloud on the card equal to the CPU "
        f"({smi})")
    return {"rays": len(scan), "rings": rings, "edges": int(st[0]["edges"].sum()),
            "surfaces": int(st[0]["surfaces"].sum())}


def tartan_phase(adir, ttraj, root, dev, smi, results):
    """14c: tartan_odometry.run_sequence at its defaults (FAST after the exact
    NL-means, capacity 32768) over TARTAN_FRAMES - 1 pairs, pose error < 0.05 and
    every align kernel on the path; select, flow_reduce and step_cached held
    against their plain versions on the driver's clouds of frames 0 and 1.
    Then the same driver over 2 pairs of test_e2e_accuracy.py's TartanAir
    corridor: pair 0 under 0.05, pair 1 within JAX's spread
    (JAX_MISSES)."""
    import os

    from unified_cvo_tpu_torch.apps import tartan_odometry as to
    from unified_cvo_tpu_torch.config import read_cvo_params_yaml
    from unified_cvo_tpu_torch.datasets.tartanair import TartanAirHandler
    from unified_cvo_tpu_torch.frontend.pipeline import pointcloud_from_rgbd

    yaml = os.path.join(root, "tartan.yaml")
    with open(yaml, "w") as f:
        f.write(TARTAN_YAML)
    params = read_cvo_params_yaml(yaml)
    h = TartanAirHandler(adir)
    calib = h.calibration()
    clouds = []
    for _ in range(2):
        rgb, depth = h.read_next_rgbd()
        clouds.append(pointcloud_from_rgbd(rgb, depth, calib, capacity=to.CAPACITY,
                                           device=dev))
        h.next()
    valid = [int(c.mask.sum()) for c in clouds]
    driver_kernel_checks(clouds[0], clouds[1], np.linalg.inv(ttraj[0]) @ ttraj[1], params,
                         dev, results, "phase 14c frames 0 -> 1")
    del clouds
    reset_launch_counts()
    records = []
    t0 = time.perf_counter()
    poses = to.run_sequence(adir, yaml, os.path.join(root, "tartan.txt"), log=lambda *a: None,
                            device=dev, records=records)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    row = driver_report("phase 14c", "phase 14c TartanAir driver (tartan_odometry.run_sequence "
                        "at its defaults: FAST after the exact NL-means, capacity 32768)",
                        poses, ttraj, records, seconds, launches, smi)
    row["valid_points"] = valid
    for name in ("select", "flow_reduce", "step_cached"):
        results[name]["launches_tartan"] = launches[name]

    # test_e2e_accuracy.py's TartanAir corridor: its pair 1 misses 0.05 in JAX
    # too (JAX_MISSES["phase 14c corridor"])
    edir, etraj = write_e2e_corridor(root)
    reset_launch_counts()
    records = []
    t0 = time.perf_counter()
    poses = to.run_sequence(edir, yaml, os.path.join(root, "tartan_e2e.txt"),
                            log=lambda *a: None, device=dev, records=records)
    torch.cuda.synchronize()
    row["e2e_corridor"] = driver_report(
        "phase 14c corridor", "phase 14c test_e2e_accuracy.py's TartanAir corridor "
        "(tartan_odometry.run_sequence at its defaults)", poses, etraj, records,
        time.perf_counter() - t0, launch_counts(), smi)
    return row


def irls_tum_phase(tdir, gt, root, dev, smi, results):
    """14d: irls_tum.main on the 5 TUM frames written as PNGs, the 7 edges and
    perturbed poses of test_e2e_accuracy.py, voxel 0.05 (the 'ell' backend:
    select at K = 128, P = 32 once per edge per outer iteration); ATE after
    < 0.6 x before. select held against select_plain at K = 128 on edge
    (0, 1) of the same clouds."""
    import os

    from unified_cvo_tpu_torch.apps import irls_tum
    from unified_cvo_tpu_torch.config import read_cvo_params_yaml
    from unified_cvo_tpu_torch.datasets.graph import write_graph_file
    from unified_cvo_tpu_torch.datasets.tum import TumHandler, read_tum_trajectory
    from unified_cvo_tpu_torch.models import irls
    from unified_cvo_tpu_torch.ops import neighbors as nbr
    from unified_cvo_tpu_torch.ops import select as sel
    from unified_cvo_tpu_torch.utils import metrics
    from unified_cvo_tpu_torch.utils.pointcloud import round_up

    init = perturbed(gt, np.random.default_rng(1))
    graph, yaml = os.path.join(root, "graph.txt"), os.path.join(root, "irls.yaml")
    write_graph_file(graph, list(range(len(gt))), list(BA_TUM_EDGES), init)
    with open(yaml, "w") as f:
        f.write(IRLS_TUM_YAML)
    params = read_cvo_params_yaml(yaml)
    stamps = []

    def keep(msg):
        stamps.append((time.perf_counter(), str(msg)))

    reset_launch_counts()
    prefix = os.path.join(root, "ba")
    t0 = time.perf_counter()
    if irls_tum.main([tdir, graph, yaml, prefix], device=dev, log=keep) != 0:
        raise SystemExit("phase 14d: irls_tum.main failed")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = sel.select.launches
    points = [int(m.split(": ")[1].split()[0]) for _, m in stamps if m.startswith("frame ")]
    solve = [(t, m) for t, m in stamps if m.startswith("device solve")]
    built = max(t for t, m in stamps if m.startswith("frame "))
    outer = int(re.search(r"'iter': (\d+)", solve[0][1]).group(1))
    solve_s = solve[0][0] - built
    _, before = read_tum_trajectory(prefix + "_before.txt")
    _, after = read_tum_trajectory(prefix + "_after.txt")
    ate0, ate1 = metrics.ate_rmse(gt, before), metrics.ate_rmse(gt, after)
    backend = irls.resolve_irls_backend(params, round_up(max(points), 1024))
    row = {"frames": len(gt), "edges": len(BA_TUM_EDGES), "points": points,
           "backend": backend, "outer": outer, "seconds": seconds, "solve_s": solve_s,
           "ms_per_outer": 1e3 * solve_s / outer, "ate_before": ate0, "ate_after": ate1,
           "select_launches": launches, "select_per_outer": launches / outer}
    log(f"phase 14d irls_tum.main ({len(gt)} frames at 640 x 480 read from PNGs, "
        f"{len(BA_TUM_EDGES)} edges, voxel {IRLS_TUM_VOXEL}: {points} points, backend "
        f"{backend}): {outer} outer iterations, solve {solve_s:.2f} s, "
        f"{row['ms_per_outer']:.2f} ms per outer iteration, {seconds:.2f} s with the "
        f"frontend and files; select launches {launches} ({launches / outer:.1f} per outer "
        f"iteration); ATE {ate0:.6f} -> {ate1:.6f} m ({smi})")
    if not (backend == "ell" and min(points) >= 32768):
        raise SystemExit(f"phase 14d: {min(points)} points a frame resolve to {backend}")
    if launches != len(BA_TUM_EDGES) * outer:
        raise SystemExit(f"phase 14d: {launches} select launches for {outer} outer "
                         f"iterations of {len(BA_TUM_EDGES)} edges")
    if not ate1 < 0.6 * ate0:
        raise SystemExit(f"phase 14d: ATE {ate0} -> {ate1}, not below 0.6 x before")

    # select at K = 128 on edge (0, 1), the clouds as irls_tum builds them
    h = TumHandler(tdir)
    calib = h.calibration()
    c = []
    for fid in (0, 1):
        h.set_start_index(fid)
        rgb, depth = h.read_next_rgbd()
        c.append(irls_tum.build_frame_cloud(rgb, depth, calib, IRLS_TUM_VOXEL / 4.0,
                                            IRLS_TUM_VOXEL, device=dev))
    T1 = torch.from_numpy(init[0, :3].astype(np.float32)).to(dev)
    T2 = torch.from_numpy(init[1, :3].astype(np.float32)).to(dev)
    c1 = c[0].transformed(T1[:, :3], T1[:, 3])
    ell = torch.full((), params.multiframe_ell_init, dtype=torch.float32, device=dev)
    P = 32
    g = nbr.grid_inputs(params, ell, c1, c[1], T2[:, :3], T2[:, 3], skin=0.0, per_cell_cap=P)
    args = (g.tab, g.cbase, g.xr2, g.pose, 128, P, nbr.GRID_DIMS)
    kept, live, binding = select_exact(sel, args, "phase 14d edge (0, 1), K = 128")
    lists = kept_stats(sel.select_plain(*args)[2], g.xr2[:, 3] >= 0)
    lists["per_cell_dropped"] = int(g.per_cell_dropped)
    row["edge_lists"] = lists
    row["select_ms"] = device_ms(lambda: sel.select(*args))
    log(f"  phase 14d edge (0, 1) at the initial poses: kept a live row {lists}; select "
        f"{row['select_ms']:.4f} ms (N {g.cbase.shape[0]})")
    results["select (K=128, P=32)"]["launches_irls_tum"] = launches
    log(f"  select @ phase 14d edge (0, 1), K = 128, P = {P}: equal to select_plain, two "
        f"launches bit-equal (kept {kept}, live slots {live}, rows with kept > K {binding})")
    row["select_check"] = {"kept": kept, "live": live, "binding": binding}
    return row


def tartan_ba_phase(root, dev, smi):
    """14e: irls_tartan --translation-only and covis_tartan on
    test_apps_drivers.py's TartanAir fixture (3 frames of a textured plane
    at 3 m, 5 px apart), written with the port's PNG writer, with the JAX
    tests' checks."""
    import os

    from unified_cvo_tpu_torch.apps import covis_tartan, irls_tartan
    from unified_cvo_tpu_torch.datasets import png
    from unified_cvo_tpu_torch.datasets.graph import write_graph_file

    d = os.path.join(root, "tartan_plane")
    for sub in ("image_left", "depth_left"):
        os.makedirs(os.path.join(d, sub))
    rng = np.random.default_rng(11)
    base = rng.integers(0, 255, (480 // 8, 640 // 8), np.uint8)
    img = np.stack([np.kron(base, np.ones((8, 8), np.uint8))] * 3, axis=-1)
    for i in range(3):
        png.imwrite(os.path.join(d, "image_left", f"{i:06d}_left.png"),
                    np.roll(img, -5 * i, axis=1))
        np.save(os.path.join(d, "depth_left", f"{i:06d}_left_depth.npy"),
                np.full((480, 640), 3.0, np.float32))
    ymls = {}
    for name, voxel in (("fast", 0.3), ("coarse", 1.2)):
        ymls[name] = os.path.join(root, f"{name}.yaml")
        with open(ymls[name], "w") as f:
            f.write(TARTAN_BA_YAML.format(voxel))
    quiet = lambda *a: None                                   # noqa: E731
    graph = os.path.join(root, "tartan_graph.txt")
    init = np.tile(np.eye(3, 4, dtype=np.float64), (3, 1, 1))
    init[1, 0, 3], init[2, 0, 3] = 0.03, 0.07
    write_graph_file(graph, [0, 1, 2], [(0, 1), (1, 2), (0, 2)],
                     np.concatenate([init, np.tile([[[0, 0, 0, 1.0]]], (3, 1, 1))], 1))
    prefix = os.path.join(root, "tartan_ba")
    t0 = time.perf_counter()
    rc = irls_tartan.main([d, ymls["fast"], graph, prefix, "--translation-only"], device=dev,
                          log=quiet)
    torch.cuda.synchronize()
    irls_s = time.perf_counter() - t0
    before, after = np.loadtxt(prefix + "_before.txt"), np.loadtxt(prefix + "_after.txt")
    if not (rc == 0 and before.shape == after.shape == (3, 7)
            and np.allclose(after[:, 3:6], 0.0, atol=1e-6)
            and np.allclose(after[:, 6], 1.0, atol=1e-6)
            and np.allclose(after[0, :3], 0.0, atol=1e-8)):
        raise SystemExit(f"phase 14e: irls_tartan --translation-only: rc {rc}, after {after}")
    cgraph = os.path.join(root, "covis_graph.txt")
    write_graph_file(cgraph, [0, 1, 2], [(0, 1), (1, 2)])
    out_dir = os.path.join(root, "covis")
    t0 = time.perf_counter()
    rc = covis_tartan.main([d, ymls["coarse"], cgraph, "1", out_dir], device=dev, log=quiet)
    torch.cuda.synchronize()
    covis_s = time.perf_counter() - t0
    missing = [f for f in ("before_BA.pcd", "after_BA.pcd", "traj_before.txt",
                           "traj_after.txt", "0.pcd", "1.pcd", "2.pcd")
               if not os.path.exists(os.path.join(out_dir, f))]
    if rc != 0 or missing:
        raise SystemExit(f"phase 14e: covis_tartan rc {rc}, missing {missing}")
    log(f"phase 14e: irls_tartan --translation-only {irls_s:.2f} s (rotations identity, "
        f"pivot fixed, x {[round(float(v), 6) for v in after[:, 0]]}); covis_tartan "
        f"{covis_s:.2f} s, its 7 files written ({smi})")
    return {"irls_tartan_s": irls_s, "after_x": after[:, 0].tolist(), "covis_s": covis_s}


def ba_phase(dev, smi, results):
    """Phase 14: PNG input without OpenCV (14a), cv2's NL-means exact on the
    card (14b), tartan_odometry at its defaults (14c), irls_tum on 'ell'
    (14d), and the TartanAir BA apps (14e)."""
    import os
    import tempfile

    from unified_cvo_tpu_torch.datasets import png

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ba_") as root:
        parts = {}
        t0 = time.perf_counter()
        tdir, _, gt, adir, ttraj, out["png"] = png_phase(root, smi)
        parts["14a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bgr = png.imread(os.path.join(tdir, "rgb", f"{1000.0:.4f}.png"))
        out["nlm_opencv"] = nlm_opencv_phase(bgr, dev, smi)
        parts["14b"] = time.perf_counter() - t0
        for key, name, fn in (
                ("14c", "tartan", lambda: tartan_phase(adir, ttraj, root, dev, smi, results)),
                ("14d", "irls_tum", lambda: irls_tum_phase(tdir, gt, root, dev, smi, results)),
                ("14e", "tartan_ba", lambda: tartan_ba_phase(root, dev, smi))):
            t0 = time.perf_counter()
            out[name] = fn()
            parts[key] = time.perf_counter() - t0
        out["seconds"] = parts
        log(f"phase 14 parts: " + ", ".join(f"{k} {v:.2f} s" for k, v in parts.items()))
    return out


# ---- phase 15: the KITTI stereo host frontend (native census-SGM, Canny), the stereo apps
# KITTI_COLOR_BENCH (CvoParams' defaults with the intensity channel) at bench.py's cap
STEREO_HOST_YAML = "is_using_intensity: 1\nMAX_ITER: 1500\n"
STEREO_CLASSES = 19                  # 15c's --semantic pair: 4 height bands of 19 classes
# 15d: irls_kitti on phase 14d's IRLS YAML at a voxel of 0.3 m (test_apps_drivers.py's
# short schedule, voxel 0.3, raised the error of these frames on the CPU at half size)
IRLS_KITTI_YAML = IRLS_TUM_YAML.replace(f"voxel_size: {IRLS_TUM_VOXEL}\n", "voxel_size: 0.3\n")
NATIVE_CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")
# 15e: SHA-256 of phase 15's frame 0 as rendered (left then right BGR bytes), and
# of cv2.StereoSGBM's int16 map (little-endian) of cv2's own grey of it
# (cv2.cvtColor BGR2GRAY, which frontend/image.py::opencv_gray computes) at JAX's
# settings (frontend/stereo.py::opencv_settings(128)), taken with cv2 5.0.0;
# tests/test_torch_sgbm_opencv.py recomputes both from cv2
SGBM_INPUT_SHA256 = "f79bc197424e033aea1b5b4b35e61fd2a64ed06025144f22632a644c6f97bff2"
SGBM_MAP_SHA256 = "a4d4a5717d5243ad0c5655f259982c11271174c6670678eb20bf040633114faf"


def native_cpp_build():
    """Start g++ on native/cvo_native.cpp and cvo_io.cpp into build/native/
    (never into native/), keyed by a hash of the sources and flags. Returns
    (the library's path, the compiler process or None if it is built)."""
    import hashlib
    import os
    from pathlib import Path

    root = Path(__file__).resolve().parent
    srcs = [root / "native" / "cvo_native.cpp", root / "native" / "cvo_io.cpp"]
    h = hashlib.sha256(" ".join(NATIVE_CXX_FLAGS).encode())
    for s in srcs:
        h.update(s.read_bytes())
    out = root / "build" / "native" / f"libcvo_native-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out, None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    return out, (subprocess.Popen(["g++", *NATIVE_CXX_FLAGS, "-o", str(tmp), *map(str, srcs)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                 tmp)


def native_cpp(build):
    """The C++ the port's native disparity is held to: the library of
    native_cpp_build (waited for), its cvo_sgm_disparity declared here as
    the JAX package declares it."""
    import ctypes
    import os

    out, pending = build
    if pending is not None:
        proc, tmp = pending
        log_, _ = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise SystemExit(f"phase 15a: g++ failed ({proc.returncode}):\n{log_}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    fn = lib.cvo_sgm_disparity
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.POINTER(ctypes.c_float)]

    def sgm(left, right, max_disp=128, p1=10, p2=120, uniqueness=0.1):
        left = np.ascontiguousarray(left, np.uint8)
        right = np.ascontiguousarray(right, np.uint8)
        h_, w_ = left.shape
        disp = np.empty((h_, w_), np.float32)
        rc = fn(left.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                right.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h_, w_, max_disp, p1, p2,
                ctypes.c_float(uniqueness), disp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise SystemExit(f"phase 15a: cvo_sgm_disparity returned {rc}")
        return disp
    return sgm


def write_stereo_host_inputs(root):
    """Phase 9's rendered frames (KITTI seq-00's camera at 1241 x 376) as a
    KITTI sequence in `root`: image_2 / image_3 PNGs written by the port's
    writer, cvo_calib.txt, semantic distributions for frames 0-1 (one-hot,
    4 height bands of STEREO_CLASSES classes) and the phase's YAML. Returns
    (the frames, {label: (sequence dir, YAML path, run_sequence keywords,
    trajectory)})."""
    import os

    from unified_cvo_tpu_torch.datasets import png

    calib, frames, traj = stereo_frames()
    seq = os.path.join(root, "kitti_stereo")
    for sub in ("image_2", "image_3", "image_semantic"):
        os.makedirs(os.path.join(seq, sub))
    c = KITTI00
    with open(os.path.join(seq, "cvo_calib.txt"), "w") as f:
        f.write(f"{c['fx']!r} {c['fx']!r} {c['cx']!r} {c['cy']!r} {c['baseline']!r} "
                f"{c['cols']} {c['rows']}\n")
    for i, (left, right) in enumerate(frames):
        png.imwrite(os.path.join(seq, "image_2", f"{i:06d}.png"), left)
        png.imwrite(os.path.join(seq, "image_3", f"{i:06d}.png"), right)
    band = np.minimum(np.arange(c["rows"]) * 4 // c["rows"], 3)
    sem = np.ascontiguousarray(np.broadcast_to(
        np.eye(STEREO_CLASSES, dtype=np.float32)[band][:, None, :],
        (c["rows"], c["cols"], STEREO_CLASSES)))
    for i in range(2):
        sem.tofile(os.path.join(seq, "image_semantic", f"{i:06d}.bin"))
    yaml = os.path.join(root, "kitti_stereo.yaml")
    with open(yaml, "w") as f:
        f.write(STEREO_HOST_YAML)
    return frames, {"phase 15c": (seq, yaml, {"max_frames": STEREO_DRIVER_FRAMES}, traj),
                    "phase 15c semantic": (seq, yaml, {"semantic": True, "max_frames": 2},
                                           traj[:2])}


def kernel_row(name, source, replaces, kfn, pfn, nbytes, launches):
    """A kernels-line row of a hand kernel with no Pallas counterpart: card ms
    (CUDA events, device_ms), plain ms on the card, the byte bound, one
    device kernel count a call (graph nodes)."""
    ms = device_ms(kfn)
    plain_ms, _ = event_ms(pfn)
    b_ms, b_by = bound(nbytes, 0)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "launches_per_call": kernels_per_call(kfn)}


def disparity_checks(frames, cxx, dev, smi, results):
    """15a: frame 0's native disparity at 1241 x 376, D 128 on the card
    against the C++ library (np.array_equal), the port's CPU call and a
    second card launch (both bit-equal); its ms, launches and the region
    speckle's share; L1 at this size against its plain version."""
    from unified_cvo_tpu_torch.frontend import image, stereo
    from unified_cvo_tpu_torch.ops import lidar as lops
    from unified_cvo_tpu_torch.ops import sgm

    left, right = frames[0]
    t0 = time.perf_counter()
    cpp = native_cpp(cxx)
    build_s = time.perf_counter() - t0             # the wait for g++, started earlier
    gl, gr = (image.opencv_gray(torch.from_numpy(im)).numpy().astype(np.uint8)
              for im in (left, right))
    t0 = time.perf_counter()
    want = cpp(gl, gr)
    cpp_s = time.perf_counter() - t0
    lk, rk = torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev)
    t0 = time.perf_counter()
    runs = [stereo.compute_disparity(lk, rk, backend="native").cpu() for _ in range(2)]
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = stereo.compute_disparity(left, right, backend="native", device="cpu")
    cpu_s = time.perf_counter() - t0
    if not np.array_equal(runs[0].numpy(), want):
        raise SystemExit(f"phase 15a: the card's native disparity differs from the C++ "
                         f"library's at {int((runs[0].numpy() != want).sum())} pixels")
    if not (torch.equal(runs[0], runs[1]) and torch.equal(runs[0], cpu)):
        raise SystemExit("phase 15a: the native disparity differs between two card launches "
                         "or from the port's CPU call")
    t0 = time.perf_counter()
    ms, _ = event_ms(lambda: stereo.compute_disparity(lk, rk, backend="native"))
    n_dev, busy = profiled(lambda: stereo.compute_disparity(lk, rk, backend="native"))
    timing_s = time.perf_counter() - t0
    sgm.reset_launches()
    stereo.compute_disparity(lk, rk, backend="native")
    n_scan = sgm._sgm_scan.launches
    if n_scan != 2:
        raise SystemExit(f"phase 15a: a native disparity launched sgm_scan {n_scan} times, not 2")
    glk, grk = torch.from_numpy(gl).to(dev), torch.from_numpy(gr).to(dev)
    med = sgm._sgm_until_median(glk, grk, 128, 10, 120, np.float32(1.0) + np.float32(0.1))
    speckle_ms, _ = event_ms(lambda: sgm.speckle_regions(med))
    removed = int(((med > 0) & (runs[0].to(dev) <= 0)).sum())
    lv, lh = sgm.speckle_links(med)
    labels = [lops.components(lv, lh) for _ in range(2)]
    if not (torch.equal(labels[0], labels[1])
            and torch.equal(labels[0], lops.components_plain(lv, lh))):
        raise SystemExit("phase 15a: L1 on the speckle's links differs from its plain version "
                         "or between two launches")
    n = med.numel()
    results["lidar_components (stereo speckle)"] = kernel_row(
        "lidar_components (stereo speckle)", "unified_cvo_tpu_torch/csrc/lidar.cu",
        "native/cvo_native.cpp:480-516 (cvo_sgm_disparity's speckle flood fill on the host; "
        "no Pallas kernel)", lambda: lops.components(lv, lh),
        lambda: lops.components_plain(lv, lh), lv.numel() + lh.numel() + 4 * n, None)
    results["lidar_components (stereo speckle)"]["shape"] = list(med.shape)
    row = {"valid": float((want > 0).mean()), "ms": ms, "launches": n_dev,
           "device_busy_ms": busy, "sgm_scan_launches": n_scan, "speckle_ms": speckle_ms, "speckle_share": speckle_ms / ms,
           "speckle_removed": removed, "cpp_build_wait_s": build_s, "cpp_s": cpp_s,
           "card_two_runs_s": card_s, "cpu_s": cpu_s, "timing_s": timing_s}
    k = results["lidar_components (stereo speckle)"]
    log(f"phase 15a native disparity ({left.shape[1]} x {left.shape[0]}, D 128): card equal "
        f"to the C++ library "
        f"(waited {build_s:.1f} s for g++, run {cpp_s:.2f} s host), to the port's CPU call "
        f"({cpu_s:.1f} s) and between two card launches ({card_s:.1f} s); timed and profiled "
        f"in {timing_s:.1f} s; {row['valid']:.4f} valid; "
        f"{ms:.2f} ms (CUDA events), {n_dev} device kernels+copies a call ({n_scan} of them "
        f"sgm_scan), busy {busy:.2f} ms; region speckle {speckle_ms:.2f} ms ({100 * speckle_ms / ms:.1f}%), {removed} pixels "
        f"removed; L1 at {tuple(med.shape)} equal to its plain version, two launches "
        f"bit-equal: {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, bound {k['bound_ms']:.6f} "
        f"ms ({k['bound_by']}), {k['launches_per_call']} device kernels a call ({smi})")
    return row


CC_SHAPE = (376, 1241)       # 15a': the union-find kernels' fixed cases, phase 15's frame size
# 15a': shapes of the random link sets and masks (single rows and columns,
# partial tiles, the lidar and stereo sizes)
CC_RANDOM_SHAPES = ((1, 1), (1, 45), (45, 1), (31, 33), (97, 130), (64, 1800), (376, 1241),
                    (512, 512))


def cc_cases(dev):
    """The three fixed cases of the union-find kernels (csrc/cc.cuh) at
    CC_SHAPE, with the labels they must give: every link set (one
    component), no link set (every cell its own), and a serpentine: L1's
    rows linked end to end (no wrap) and to the next row at alternate ends,
    one path through every cell, the longest chain; components8's every
    other row in, joined by one pixel at alternate ends. Returns {case:
    (link_v, link_h, L1 labels, mask, components8 labels)} on `dev`."""
    rows, cols = CC_SHAPE
    ids = torch.arange(rows * cols, dtype=torch.int32, device=dev).view(rows, cols)
    zero = torch.zeros_like(ids)
    full_v = torch.ones((rows - 1, cols), dtype=torch.bool, device=dev)
    full_h = torch.ones((rows, cols), dtype=torch.bool, device=dev)
    serp_h = full_h.clone()
    serp_h[:, -1] = False
    serp_v = torch.zeros_like(full_v)
    serp_v[0::2, -1] = True
    serp_v[1::2, 0] = True
    serp_m = torch.zeros_like(full_h)
    serp_m[0::2] = True
    serp_m[1::4, -1] = True
    serp_m[3::4, 0] = True
    return {"every link": (full_v, full_h, zero, full_h, zero),
            "no link": (~full_v, ~full_h, ids, ~full_h, ids),
            "serpentine": (serp_v, serp_h, zero, serp_m, torch.where(serp_m, zero, ids))}


def cc_case_checks(dev, smi, results):
    """15a': L1 and components8 on the three cc_cases: labels the known ones
    and torch.equal to the plain versions, two launches bit-equal; each
    kernel's ms on each (CUDA events), beside the rows of phases 15a and 15b
    (`cases_ms`); then on 192 random link sets and masks (CC_RANDOM_SHAPES,
    six densities, four draws), equal to the plain versions and twice
    bit-equal. Launches made here are not counted into the path's."""
    from unified_cvo_tpu_torch.ops import canny
    from unified_cvo_tpu_torch.ops import lidar as lops

    l1_ms, c8_ms = {}, {}
    for case, (lv, lh, l1_want, mask, c8_want) in cc_cases(dev).items():
        for name, kfn, pfn, want, ms in (
                ("L1", lambda: lops.components(lv, lh), lambda: lops.components_plain(lv, lh),
                 l1_want, l1_ms),
                ("components8", lambda: canny.components8(mask),
                 lambda: canny.components8_plain(mask), c8_want, c8_ms)):
            runs = [kfn() for _ in range(2)]
            plain = pfn()
            torch.cuda.synchronize()
            if not (torch.equal(runs[0], runs[1]) and torch.equal(runs[0], plain)
                    and torch.equal(runs[0], want)):
                raise SystemExit(f"phase 15a': {name} on the {case!r} case differs from its plain "
                                 f"version, from the known labels or between two launches")
            ms[case] = device_ms(kfn)
    # random link sets and masks around the percolation threshold, where
    # components are large and irregular and the hooks race the most
    g = torch.Generator(device=dev).manual_seed(0)
    trials = 0
    for rows, cols in CC_RANDOM_SHAPES:
        for p in (0.2, 0.45, 0.5, 0.55, 0.7, 0.95):
            for _ in range(4):
                lv = torch.rand((rows - 1, cols), generator=g, device=dev) < p
                lh = torch.rand((rows, cols), generator=g, device=dev) < p
                mask = torch.rand((rows, cols), generator=g, device=dev) < p
                for name, kfn, pfn in (("L1", lambda: lops.components(lv, lh),
                                        lambda: lops.components_plain(lv, lh)),
                                       ("components8", lambda: canny.components8(mask),
                                        lambda: canny.components8_plain(mask))):
                    a, b = kfn(), kfn()
                    if not (torch.equal(a, b) and torch.equal(a, pfn())):
                        raise SystemExit(f"phase 15a': {name} on a random set at {rows} x {cols}, "
                                         f"density {p}, differs from its plain version or "
                                         f"between two launches")
                trials += 1
    results["lidar_components (stereo speckle)"]["cases_ms"] = l1_ms
    results["components8"]["cases_ms"] = c8_ms
    log(f"phase 15a' union-find cases at {CC_SHAPE[1]} x {CC_SHAPE[0]}: L1 and components8 "
        f"equal to their plain versions and to the known labels, two launches bit-equal, also "
        f"on {trials} random link sets and masks; L1 ms "
        f"{ {k: round(v, 4) for k, v in l1_ms.items()} }, components8 ms "
        f"{ {k: round(v, 4) for k, v in c8_ms.items()} } ({smi})")
    return {"L1_ms": l1_ms, "components8_ms": c8_ms}


def cc_inputs(dev):
    """The lidar and union-find kernels' inputs on the main paths, as CPU
    tensors: L1's links of a LeGO-LOAM range image (phase 13's room, 64 x
    1800), of the native speckle (15a) and of StereoSGBM's filterSpeckles
    (15e) on phase 15's frame 0 (376 x 1241), components8's Canny
    candidates of that frame (15b), the fixed cases of 15a', and L2's range
    image and kept cells of the same lidar frame and of 13a's "dense" and
    "ramp" rings at 64 x 3400. {name: (kernel, input tensors)}: "L1" takes
    (link_v, link_h), "components8" (mask,), "L2" (range_img, keep)."""
    from unified_cvo_tpu_torch.frontend import image, stereo
    from unified_cvo_tpu_torch.frontend import lidar as fl
    from unified_cvo_tpu_torch.ops import canny, sgm
    from unified_cvo_tpu_torch.ops import sgbm_opencv as sg
    from unified_cvo_tpu_torch.utils import synth

    T = synth.corridor_trajectory(1, step=0.15, yaw_rate=0.02, bob=0.0)[0]
    scene = synth.room_scene(11, half=8.0, floor_y=1.8, ceil_y=-3.0, n_pillars=4)
    scan = synth.render_lidar_scan(scene, T, n_beams=LIDAR_BEAMS, n_az=LIDAR_AZ,
                                   fov_deg=LIDAR_FOV, noise=0.005, seed=0)
    x = torch.from_numpy(np.ascontiguousarray(scan[:, :3])).to(dev)
    ri, ii = fl.project_range_image(x)
    g = fl.ground_mask_range_image(x, ii)
    lidar = fl.segment_links(ri, g)[:2]
    keep = fl.segment_range_image(ri, g) & (ii >= 0)
    _, frames, _ = stereo_frames()
    gl, gr = (image.opencv_gray(torch.from_numpy(im).to(dev)).to(torch.uint8)
              for im in frames[0])
    med = sgm._sgm_until_median(gl, gr, 128, 10, 120, np.float32(1.0) + np.float32(0.1))
    kw = stereo.opencv_settings(128)
    new_val, max_diff = (kw["min_disparity"] - 1) * sg.DISP_SCALE, sg.DISP_SCALE * kw["speckle_range"]
    pre = sg.sgbm_3way(gl, gr, **dict(kw, speckle_window_size=0)).to(torch.int32)
    out = {"L1 64x1800 lidar": ("L1", lidar), "L2 64x1800 lidar": ("L2", (ri, keep)),
           "L1 376x1241 native speckle": ("L1", sgm.speckle_links(med)),
           "L1 376x1241 StereoSGBM speckle": ("L1", sg.speckle_links(pre, new_val, max_diff)),
           "components8 376x1241 Canny": ("components8", (canny.canny_candidates(gl)[0],))}
    for case, (lv, lh, _, mask, _) in cc_cases(dev).items():
        out[f"L1 {case}"] = ("L1", (lv, lh))
        out[f"components8 {case}"] = ("components8", (mask,))
    for case in ("dense", "ramp"):
        r, i, seg = loam_rings(case, LOAM_ROWS, max(LOAM_WIDTHS))
        out[f"L2 {LOAM_ROWS}x{max(LOAM_WIDTHS)} {case}"] = (
            "L2", (torch.from_numpy(r), torch.from_numpy(seg & (i >= 0))))
    return {k: (kind, tuple(t.cpu() for t in ts)) for k, (kind, ts) in out.items()}


def cc_times(path, dev, times, nodes, bounds):
    """kernel_times' rows of L1, components8 and L2 on cc_inputs saved at
    `path`: each checked against its plain version (torch.equal) and for
    two bit-equal launches, then timed; the bound is the bytes (inputs
    read once, outputs written once)."""
    from unified_cvo_tpu_torch.ops import canny
    from unified_cvo_tpu_torch.ops import lidar as lops

    fns = {"L1": (lops.components, lops.components_plain),
           "components8": (canny.components8, canny.components8_plain),
           "L2": (lops.loam_features, lops.loam_features_plain)}
    as_tuple = lambda o: o if isinstance(o, tuple) else (o,)           # noqa: E731
    for name, (kind, ts) in torch.load(path).items():
        ts = tuple(t.to(dev) for t in ts)
        kfn, pfn = fns[kind]
        runs = [as_tuple(kfn(*ts)) for _ in range(2)]
        plain = as_tuple(pfn(*ts))
        if not all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(*runs, plain)):
            raise SystemExit(f"{kind} on {name!r} differs from its plain version or between "
                             f"two launches")
        times[name] = device_ms(lambda: kfn(*ts))
        nodes[name] = kernels_per_call(lambda: kfn(*ts))
        bounds[name] = bound(sum(t.numel() * t.element_size() for t in ts + plain), 0)[0]


# 13a': L2's adversarial rings (loam_rings), each at both widths. "dense" at
# 64 x 3400 makes the serial walk visit the most candidates, "ramp" makes
# the kernel's rounds the longest (20 a sector, one corner a round)
LOAM_CASES = ("dense", "gaps", "sector edge", "short rings", "thresholds", "ramp", "ties",
              "random")
LOAM_WIDTHS = (1800, 3400)
LOAM_ROWS = 64


def loam_rings(case, rows, cols, seed=19):
    """A LeGO-LOAM range image made for one of L2's hard cases, from a numpy
    seed: (range_img float32, index_img int64 (-1 where no point), segmented
    bool), each [rows, cols]; L2 keeps the segmented cells with a point.

    dense        every column kept, 5-6 mm steps of noise at 20-30 m: most
                 positions are candidates with distinct curvatures, so the
                 20-corner cap binds in every sector
    gaps         runs of 3-25 kept columns, the column step between runs 9,
                 10, 11, 12 or 21 (occlusion needs < 10, a suppression run
                 stops at > 10); the gap cells unfilled or not segmented
    sector edge  a bump at one of each sector's last 5 positions, the
                 sector's largest curvature: its corner marks the next
                 sector's first candidates
    short rings  ring i keeps 11 + i % 19 columns (11 to 29) at column steps
                 of 1-12: sectors shorter than 5, suppression across several
    thresholds   ranges 8-12 m with steps 1e-5 either side of 0.3 m
                 (occlusion) and 1e-5 relative either side of 2% of the
                 range (parallel beams)
    ramp         r_k = R + a_k (-1)^k with a_k growing along the ring (every
                 other ring shrinking): curvature strictly monotone in each
                 sector, so each corner waits on the one before it
    ties         ranges on a 4 cm grid: curvatures tie within sectors
    random       a smooth wall 2-60 m with 1 m jumps, 75% of the cells kept

    Every case but "ties" is then made free of curvature ties among a
    sector's candidates (untie_ring), so JAX's unstable argsort walks it in
    the one order the port's tie rule gives.
    """
    rng = np.random.default_rng([seed, LOAM_CASES.index(case), rows, cols])
    base = rng.uniform(20.0, 30.0, (rows, 1))
    ranges = np.zeros((rows, cols), np.float64)
    filled = np.ones((rows, cols), bool)
    seg = np.ones((rows, cols), bool)
    k = np.arange(cols)
    if case in ("dense", "sector edge"):
        noise = 0.13 if case == "dense" else 0.05
        ranges = base + rng.uniform(-noise, noise, (rows, cols))
        if case == "sector edge":
            bounds = np.linspace(0, cols, 7).astype(int)
            for i in range(rows):
                for ep in bounds[1:-1]:
                    ranges[i, ep - 1 - (i + ep) % 5] += 0.15
    elif case == "gaps":
        ranges = base + rng.uniform(-0.13, 0.13, (rows, cols))
        for i in range(rows):
            keep = np.zeros(cols, bool)
            c = int(rng.integers(0, 12))
            while c < cols:
                n = int(rng.integers(3, 26))
                keep[c:c + n] = True
                c += n - 1 + int(rng.choice([9, 10, 11, 12, 21]))
            off = ~keep
            filled[i] = keep | (off & (rng.random(cols) < 0.5))
            seg[i] = keep
    elif case == "short rings":
        ranges = base + rng.uniform(-0.13, 0.13, (rows, cols))
        filled[:] = False
        for i in range(rows):
            m = 11 + i % 19
            cols_i = np.cumsum(rng.choice([1, 2, 5, 9, 10, 11, 12], m)) + int(rng.integers(0, 40))
            filled[i, cols_i[cols_i < cols]] = True
    elif case == "thresholds":
        base = rng.uniform(8.0, 12.0, (rows, 1))
        for i in range(rows):
            r = np.empty(cols, np.float32)
            r[0] = base[i, 0]
            for c in range(1, cols):
                u, prev = rng.random(), float(r[c - 1])
                away = prev - base[i, 0]                    # large steps lean back to the base
                side = -np.sign(away) if abs(away) > 1.0 else rng.choice([-1.0, 1.0])
                if u < 0.2:
                    step = side * (0.3 + rng.choice([-1e-5, 1e-5]))
                elif u < 0.5:
                    step = side * (0.02 * prev * (1 + rng.choice([-1e-5, 1e-5])))
                else:
                    step = rng.uniform(-0.03, 0.03)
                r[c] = np.float32(prev + step)
            ranges[i] = r
    elif case == "ramp":
        t = k / cols
        a = 0.03 + 0.11 * np.where(np.arange(rows)[:, None] % 2 == 0, t, 1.0 - t)
        ranges = base + a * np.where(k % 2 == 0, 1.0, -1.0)
    elif case == "ties":
        ranges = np.round(base) + 0.04 * rng.integers(-2, 3, (rows, cols))
        seg = rng.random((rows, cols)) < 0.9
    elif case == "random":
        base = rng.uniform(2.0, 55.0, (rows, 1))
        wall = base + 3.0 * np.sin(k / rng.uniform(20, 200, (rows, 1)))
        jumps = np.cumsum(np.where(rng.random((rows, cols)) < 0.02,
                                   rng.choice([-1.0, 1.0], (rows, cols)), 0.0), 1)
        ranges = np.clip(wall + jumps, 1.0, 80.0) + rng.normal(0.0, 0.05, (rows, cols))
        seg = rng.random((rows, cols)) < 0.75
        filled = rng.random((rows, cols)) < 0.95
    else:
        raise ValueError(f"unknown L2 case {case!r}")
    range_img = np.where(filled, ranges, 0.0).astype(np.float32)
    index = np.where(filled, np.cumsum(filled).reshape(rows, cols) - 1, -1).astype(np.int64)
    if case != "ties":
        for i in range(rows):
            untie_ring(range_img[i], seg[i] & filled[i])
    return range_img, index, seg & filled


def untie_ring(ranges, keep, edge_threshold=0.1):
    """Raises kept ranges of one ring (float32, in place) by one ulp at a
    time until no sector's candidates (curvature finite and above the
    threshold, numpy's float32 window sums) share a curvature."""
    from numpy.lib.stride_tricks import sliding_window_view

    cols = np.nonzero(keep)[0]
    m = len(cols)
    if m < 12:
        return
    sector = np.searchsorted(np.linspace(0, m, 7).astype(int), np.arange(m), side="right") - 1
    for _ in range(200):
        r = ranges[cols]
        w = sliding_window_view(r, 11).T
        s = ((w[0] + w[1]) + (w[2] + w[3])) + ((w[4] + w[5]) + (w[6] + w[7]))
        d = ((s + w[8]) + w[9]) + w[10] - np.float32(11) * r[5:m - 5]
        curv = np.full(m, np.nan, np.float32)
        curv[5:m - 5] = d * d
        k = np.nonzero(np.isfinite(curv) & (curv.astype(np.float64) > edge_threshold))[0]
        k = k[np.lexsort((curv[k], sector[k]))]
        tied = (sector[k[1:]] == sector[k[:-1]]) & (curv[k[1:]] == curv[k[:-1]])
        if not tied.any():
            return
        at = cols[k[1:][tied]]
        ranges[at] = np.nextafter(ranges[at], np.float32(np.inf))
    raise RuntimeError("untie_ring: curvature ties remain")


def loam_floor_ms(ri, keep):
    """L2's latency floor on a range image: its slowest ring launched alone
    (one block: the launch and that ring's chain of block barriers), which
    the launch of all rings cannot beat. Every ring is timed once (10
    calls), the three slowest again in full (device_ms). Returns (ms,
    ring)."""
    from unified_cvo_tpu_torch.ops import lidar as lops

    def one(i):
        return lambda: lops.loam_features(ri[i:i + 1], keep[i:i + 1])

    quick = [device_ms(one(i), reps=10, trials=1) for i in range(ri.shape[0])]
    slow = sorted(range(len(quick)), key=quick.__getitem__)[-3:]
    return max((device_ms(one(i)), i) for i in slow)


def loam_case_checks(dev, smi, results):
    """13a': L2 on each of LOAM_CASES (loam_rings) at LOAM_ROWS rings of each
    of LOAM_WIDTHS columns: torch.equal to loam_features_plain on the card,
    two launches bit-equal, then timed (CUDA events) beside the byte bound;
    the slowest one's latency floor (loam_floor_ms). Launches made here are
    not counted into the path's."""
    from unified_cvo_tpu_torch.ops import lidar as lops

    t0 = time.perf_counter()
    ms, edges, inputs = {}, {}, {}
    for cols in LOAM_WIDTHS:
        for case in LOAM_CASES:
            r, i, seg = loam_rings(case, LOAM_ROWS, cols)
            ri = torch.from_numpy(r).to(dev)
            keep = torch.from_numpy(seg & (i >= 0)).to(dev)
            runs = [lops.loam_features(ri, keep) for _ in range(2)]
            plain = lops.loam_features_plain(ri, keep)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) and torch.equal(a, c)
                       for a, b, c in zip(runs[0], runs[1], plain)):
                raise SystemExit(f"phase 13a': L2 on the {case!r} rings at {LOAM_ROWS} x {cols} "
                                 f"differs from its plain version or between two launches")
            name = f"{case} {LOAM_ROWS}x{cols}"
            ms[name] = device_ms(lambda: lops.loam_features(ri, keep))
            edges[name] = int((plain[0] == lops.EDGE).sum())
            inputs[name] = (ri, keep)
    worst = max(ms, key=ms.get)
    floor_ms, ring = loam_floor_ms(*inputs[worst])
    bounds = {cols: bound(6 * LOAM_ROWS * cols + 4 * LOAM_ROWS * lops.N_SECTORS, 0)[0]
              for cols in LOAM_WIDTHS}
    results["lidar_loam_features"]["cases_ms"] = ms
    seconds = time.perf_counter() - t0
    log(f"phase 13a' L2 cases ({', '.join(LOAM_CASES)}) at {LOAM_ROWS} x {LOAM_WIDTHS}: equal to "
        f"the plain version on the card, two launches bit-equal; ms "
        f"{ {k: round(v, 4) for k, v in ms.items()} }, edges {edges}; byte bound "
        f"{ {k: round(v, 6) for k, v in bounds.items()} } ms; slowest {worst!r}, latency "
        f"floor {floor_ms:.4f} ms (ring {ring} alone); {seconds:.1f} s ({smi})")
    return {"ms": ms, "edges": edges, "bound_ms": bounds, "worst": worst,
            "worst_latency_floor_ms": floor_ms, "seconds": seconds}


def canny_checks(frames, calib, dev, smi, results):
    """15b: components8 against components8_plain on the card (equal labels,
    two launches bit-equal), Canny card against CPU (equal), EDGES_ONLY uv
    and gtype card against CPU with one seed (equal), and one
    pointcloud_from_stereo(method=EDGES_ONLY) on the card: components8
    launched once."""
    from unified_cvo_tpu_torch.frontend import image, pipeline
    from unified_cvo_tpu_torch.frontend import selector as sel
    from unified_cvo_tpu_torch.ops import canny

    left, right = frames[0]
    gray = image.opencv_gray(torch.from_numpy(left))
    gk = gray.to(dev)
    cand, _ = canny.canny_candidates(gk)
    labels = [canny.components8(cand) for _ in range(2)]
    if not (torch.equal(labels[0], labels[1])
            and torch.equal(labels[0], canny.components8_plain(cand))):
        raise SystemExit("phase 15b: components8 differs from its plain version or between "
                         "two launches")
    edges = canny.canny(gk)
    if not torch.equal(edges.cpu(), canny.canny(gray)):
        raise SystemExit("phase 15b: Canny on the card differs from the CPU's")
    picks = [sel.select_points(image.make_raw_image(left, denoise=False, device=d), "stereo",
                               sel.EDGES_ONLY, seed=0) for d in (dev, "cpu")]
    if not all(torch.equal(a.cpu(), b) for a, b in zip(*picks)):
        raise SystemExit("phase 15b: the EDGES_ONLY selection on the card differs from the "
                         "CPU's")
    canny.reset_launches()
    cloud = pipeline.pointcloud_from_stereo(left, right, calib, method=sel.EDGES_ONLY,
                                            denoise=False, device=dev)
    launches = canny.components8.launches
    if launches != 1:
        raise SystemExit(f"phase 15b: an EDGES_ONLY cloud launched components8 {launches} "
                         f"times, not once")
    canny_ms, _ = event_ms(lambda: canny.canny(gk))
    n = cand.numel()
    results["components8"] = kernel_row(
        "components8", "unified_cvo_tpu_torch/csrc/image.cu",
        "unified_cvo_tpu/frontend/selector.py:188 (cv2.Canny's hysteresis on the host; no "
        "Pallas kernel)", lambda: canny.components8(cand),
        lambda: canny.components8_plain(cand), n + 4 * n, launches)
    results["components8"]["shape"] = list(cand.shape)
    k = results["components8"]
    row = {"candidates": int(cand.sum()), "edges": int(edges.sum()),
           "edges_only_points": len(picks[1][0]), "cloud_points": int(cloud.mask.sum()),
           "canny_ms": canny_ms}
    log(f"phase 15b Canny ({left.shape[1]} x {left.shape[0]}): {row['candidates']} "
        f"candidates, {row['edges']} edge "
        f"pixels, card equal to the CPU; EDGES_ONLY {row['edges_only_points']} picks, card "
        f"equal to the CPU; Canny {canny_ms:.2f} ms (CUDA events); components8 equal to its "
        f"plain version, two launches bit-equal, launched once by an EDGES_ONLY cloud "
        f"({row['cloud_points']} points): {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
        f"bound {k['bound_ms']:.6f} ms ({k['bound_by']}), {k['launches_per_call']} device "
        f"kernels a call ({smi})")
    return row


def irls_kitti_part(seq, gt, root, dev, smi):
    """15d: irls_kitti.main on the 3 frames (edges 0-1, 1-2, 0-2, the tracking
    trajectory the rendered one moved by seeded noise, IRLS_KITTI_YAML): the
    ATE and the largest pose error must fall."""
    import os

    from unified_cvo_tpu_torch.apps import irls_kitti
    from unified_cvo_tpu_torch.datasets.graph import write_graph_file
    from unified_cvo_tpu_torch.utils import metrics

    init = perturbed(gt, np.random.default_rng(15))
    yaml, graph = os.path.join(root, "irls_kitti.yaml"), os.path.join(root, "graph.txt")
    with open(yaml, "w") as f:
        f.write(IRLS_KITTI_YAML)
    write_graph_file(graph, [0, 1, 2], [(0, 1), (1, 2), (0, 2)])
    track = kitti_rows(os.path.join(root, "track.txt"), init)
    gt_path = kitti_rows(os.path.join(root, "gt.txt"), gt)
    prefix = os.path.join(root, "irls_kitti")
    msgs = []
    t0 = time.perf_counter()
    rc = irls_kitti.main([seq, yaml, graph, prefix, track, gt_path], device=dev,
                         log=msgs.append)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    after = np.loadtxt(prefix + "_after.txt").reshape(-1, 3, 4)
    after = np.concatenate([after, np.tile([[[0, 0, 0, 1.0]]], (len(after), 1, 1))], 1)
    ate0, ate1 = metrics.ate_rmse(gt, init), metrics.ate_rmse(gt, after)
    err0 = max(pose_gap(g, p) for g, p in zip(gt, init))
    err1 = max(pose_gap(g, p) for g, p in zip(gt, after))
    points = [int(m.split(": ")[1].split()[0]) for m in msgs if str(m).startswith("frame ")]
    row = {"s": seconds, "points": points, "ate_before": ate0, "ate_after": ate1,
           "pose_error_before": err0, "pose_error_after": err1,
           "solve": [m for m in msgs if str(m).startswith("device solve")]}
    log(f"phase 15d irls_kitti (3 frames from PNGs, 3 edges, voxel 0.3: {points} points) "
        f"{seconds:.2f} s, ATE {ate0:.6f} -> {ate1:.6f} m, largest pose error {err0:.6f} -> "
        f"{err1:.6f}; {row['solve']} ({smi})")
    if not (rc == 0 and ate1 < ate0 and err1 < err0):
        raise SystemExit(f"phase 15d: irls_kitti rc {rc}, {row}")
    return row


def depth_filtering_part(seq, gt, root, dev, smi):
    """15d: depth_filtering.run once on the 3 frames at the rendered poses
    (IRLS_KITTI_YAML's voxel, the app's default kernel and capacity): the
    fused cloud finite, not larger than the keyframe's."""
    import os

    from unified_cvo_tpu_torch.apps import depth_filtering
    from unified_cvo_tpu_torch.datasets.pcd import read_pcd

    yaml = os.path.join(root, "depth_filtering.yaml")
    with open(yaml, "w") as f:
        f.write(IRLS_KITTI_YAML)
    out_dir = os.path.join(root, "depth_filtering")
    t0 = time.perf_counter()
    rc = depth_filtering.run(seq, yaml, kitti_rows(os.path.join(root, "true.txt"), gt), 0,
                             len(gt), 1.0, 0.1, out_dir, device=dev, log=lambda *a: None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    before, _ = read_pcd(os.path.join(out_dir, "before_depth_filtering.pcd"))
    after, _ = read_pcd(os.path.join(out_dir, "after_depth_filtering.pcd"))
    row = {"s": seconds, "points_before": len(before), "points_after": len(after)}
    log(f"phase 15d depth_filtering {seconds:.2f} s, {len(before)} -> {len(after)} points "
        f"({smi})")
    if not (rc == 0 and 0 < len(after) <= len(before) and np.isfinite(after).all()):
        raise SystemExit(f"phase 15d: depth_filtering rc {rc}, {row}")
    return row


def sweep_part(seq, yaml, traj, root, dev, smi):
    """15d: indicator_sweep.main over frames 1-2 from frame 0 (ell 1.0): the
    function angle at the rendered relative pose must be above the one at
    the identity that the sweep writes."""
    import os

    from unified_cvo_tpu_torch.apps import indicator_sweep
    from unified_cvo_tpu_torch.config import read_cvo_params_yaml
    from unified_cvo_tpu_torch.datasets.kitti import KittiHandler
    from unified_cvo_tpu_torch.frontend.pipeline import pointcloud_from_stereo
    from unified_cvo_tpu_torch.models.align import function_angle

    csv = os.path.join(root, "sweep.csv")
    t0 = time.perf_counter()
    rc = indicator_sweep.main([seq, yaml, csv, "1.0", "0", "2", "1"], device=dev,
                              log=lambda *a: None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    at_eye = [float(r.split(",")[1]) for r in open(csv).read().split()[1:]]
    params = read_cvo_params_yaml(yaml)
    kitti = KittiHandler(seq, "stereo")
    calib = kitti.calibration()
    clouds = []
    for i in range(3):
        kitti.set_start_index(i)
        clouds.append(pointcloud_from_stereo(*kitti.read_next_stereo(), calib, capacity=32768,
                                             device=dev))
    # the analysis entry points move the target by the inverse of their
    # transform: the inverse of align's result (frame k in frame 0)
    at_true = [float(function_angle(clouds[0], clouds[k], torch.from_numpy(
        (np.linalg.inv(traj[k]) @ traj[0]).astype(np.float32)).to(dev), 1.0, params,
        device=dev)) for k in (1, 2)]
    row = {"s": seconds, "at_identity": at_eye, "at_true": at_true}
    log(f"phase 15d indicator_sweep {seconds:.2f} s, function angle at the identity "
        f"{[round(a, 6) for a in at_eye]}, at the rendered poses "
        f"{[round(a, 6) for a in at_true]} ({smi})")
    if not (rc == 0 and len(at_eye) == 2 and all(t > e for t, e in zip(at_true, at_eye))):
        raise SystemExit(f"phase 15d: indicator_sweep rc {rc}, {row}")
    return row


def kitti_rows(path, poses):
    """A KITTI trajectory file of 4x4 poses; returns the path."""
    np.savetxt(path, np.stack([np.asarray(P)[:3].reshape(12) for P in poses]))
    return path


def pose_gap(A, B):
    """|log(A^-1 B)| of two 4x4 transforms."""
    from unified_cvo_tpu_torch.ops import lie

    E = np.linalg.inv(np.asarray(A, np.float64)) @ np.asarray(B, np.float64)
    return float(torch.linalg.vector_norm(lie.se3_log(torch.from_numpy(E[:3, :3]),
                                                      torch.from_numpy(E[:3, 3]))))


def sgbm_part(frames, runs, root, dev, smi, results):
    """15e: compute_disparity(backend="opencv") (ops/sgbm_opencv.py, cv2's
    StereoSGBM 3WAY) on frame 0 at 1241 x 376, D 128: the input frames'
    digest first, then the card's int16 map equal to the port's CPU call,
    to itself over two launches and, by SHA-256, to cv2's bytes; the float
    map equal to it / 16; ms (CUDA events) beside the native backend's,
    device kernels and busy ms (torch.profiler); L1 on its speckle's links
    against its plain version. Then kitti_odometry.run_sequence over frames
    0 -> 1 on stereo_backend="opencv", launches counted from 0 (select,
    flow_reduce, step_cached, L1 once a frame, sgm_scan twice), pose error < 0.05 (or within
    JAX_MISSES' spread), kernels 1-3 on its clouds."""
    import hashlib
    import os

    from unified_cvo_tpu_torch.apps import kitti_odometry
    from unified_cvo_tpu_torch.config import read_cvo_params_yaml
    from unified_cvo_tpu_torch.frontend import image, pipeline, stereo
    from unified_cvo_tpu_torch.frontend.calibration import read_calibration
    from unified_cvo_tpu_torch.ops import lidar as lops
    from unified_cvo_tpu_torch.ops import sgbm_opencv as sg
    from unified_cvo_tpu_torch.ops import sgm

    left, right = frames[0]
    digest = hashlib.sha256(left.tobytes() + right.tobytes()).hexdigest()
    if digest != SGBM_INPUT_SHA256:
        raise SystemExit(f"phase 15e: the rendered frame 0 is not the one cv2's digest was "
                         f"taken of ({digest})")
    kw = stereo.opencv_settings(128)
    gl, gr = (image.opencv_gray(torch.from_numpy(im)).to(torch.uint8) for im in (left, right))
    glk, grk = gl.to(dev), gr.to(dev)
    t0 = time.perf_counter()
    maps = [sg.sgbm_3way(glk, grk, **kw).cpu() for _ in range(2)]
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = sg.sgbm_3way(gl, gr, **kw)
    cpu_s = time.perf_counter() - t0
    if not (torch.equal(maps[0], maps[1]) and torch.equal(maps[0], cpu)):
        raise SystemExit(f"phase 15e: the StereoSGBM map differs between two card launches "
                         f"or from the port's CPU call "
                         f"({int((maps[0] != cpu).sum())} pixels from the CPU's)")
    got = hashlib.sha256(maps[0].numpy().astype("<i2").tobytes()).hexdigest()
    if got != SGBM_MAP_SHA256:
        raise SystemExit(f"phase 15e: the card's StereoSGBM map is not cv2's ({got})")
    lk, rk = torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev)
    disp = stereo.compute_disparity(lk, rk, backend="opencv")
    if not torch.equal(disp.cpu(), maps[0].to(torch.float32) / 16.0):
        raise SystemExit("phase 15e: compute_disparity(backend='opencv') is not the map / 16")
    t0 = time.perf_counter()
    ms, _ = event_ms(lambda: sg.sgbm_3way(glk, grk, **kw))
    n_dev, busy = profiled(lambda: sg.sgbm_3way(glk, grk, **kw))
    sgm.reset_launches()
    sg.sgbm_3way(glk, grk, **kw)
    n_scan = sgm._sgm_scan.launches
    if n_scan != 2:
        raise SystemExit(f"phase 15e: a StereoSGBM map launched sgm_scan {n_scan} times, not 2")
    native_ms, _ = event_ms(lambda: stereo.compute_disparity(lk, rk, backend="native"))
    timing_s = time.perf_counter() - t0
    # the map filterSpeckles meets (speckle window 0: cv2 skips the filter) and its links
    new_val = (kw["min_disparity"] - 1) * sg.DISP_SCALE
    max_diff = sg.DISP_SCALE * kw["speckle_range"]
    pre = sg.sgbm_3way(glk, grk, **dict(kw, speckle_window_size=0)).to(torch.int32)
    kept = sg.filter_speckles(pre, new_val, kw["speckle_window_size"], max_diff)
    if not torch.equal(kept.cpu().to(torch.int16), maps[0]):
        raise SystemExit("phase 15e: filter_speckles of the unfiltered map is not the map")
    lv, lh = sg.speckle_links(pre, new_val, max_diff)
    labels = [lops.components(lv, lh) for _ in range(2)]
    if not (torch.equal(labels[0], labels[1])
            and torch.equal(labels[0], lops.components_plain(lv, lh))):
        raise SystemExit("phase 15e: L1 on the StereoSGBM speckle's links differs from its "
                         "plain version or between two launches")
    name = "lidar_components (StereoSGBM speckle)"
    results[name] = kernel_row(
        name, "unified_cvo_tpu_torch/csrc/lidar.cu",
        "cv2.filterSpeckles in StereoSGBM::compute (unified_cvo_tpu/frontend/stereo.py:61; "
        "OpenCV on the host, no Pallas kernel)", lambda: lops.components(lv, lh),
        lambda: lops.components_plain(lv, lh), lv.numel() + lh.numel() + 4 * lh.numel(), None)
    results[name]["shape"] = list(lh.shape)
    k = results[name]
    row = {"valid": float((maps[0] >= 0).float().mean()), "ms": ms, "launches": n_dev,
           "device_busy_ms": busy, "sgm_scan_launches": n_scan, "native_ms": native_ms, "card_two_runs_s": card_s,
           "cpu_s": cpu_s, "timing_s": timing_s}
    log(f"phase 15e StereoSGBM 3WAY ({left.shape[1]} x {left.shape[0]}, D 128, JAX's "
        f"settings): input digest checked; the card's int16 map equal to the port's CPU call "
        f"({cpu_s:.1f} s), between two card launches ({card_s:.1f} s) and to cv2's bytes "
        f"(SHA-256); {row['valid']:.4f} valid; {ms:.2f} ms (CUDA events), {n_dev} device "
        f"kernels+copies a call ({n_scan} of them sgm_scan), busy {busy:.2f} ms; the native backend {native_ms:.2f} ms in "
        f"this call; timed and profiled in {timing_s:.1f} s; L1 at {tuple(lh.shape)} equal to "
        f"its plain version, two launches bit-equal: {k['ms']:.4f} ms, plain "
        f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.6f} ms ({k['bound_by']}) ({smi})")

    seq, yaml, _, traj = runs["phase 15c"]
    calib = read_calibration(os.path.join(seq, "cvo_calib.txt"), "stereo")
    params = read_cvo_params_yaml(yaml)
    clouds = [pipeline.pointcloud_from_stereo(l, r, calib, device=dev, stereo_backend="opencv",
                                              capacity=kitti_odometry.CAPACITY)
              for l, r in frames[:2]]
    driver_kernel_checks(clouds[0], clouds[1], np.linalg.inv(traj[0]) @ traj[1], params, dev,
                         results, "phase 15e frames 0 -> 1")
    del clouds
    reset_launch_counts()
    lops.reset_launches()
    records = []
    t1 = time.perf_counter()
    poses = kitti_odometry.run_sequence(seq, yaml, os.path.join(root, "traj_sgbm.txt"),
                                        log=lambda *a: None, device=dev, records=records,
                                        max_frames=2, stereo_backend="opencv")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    l1 = lops.components.launches
    launches = launch_counts()
    row["driver"] = driver_report(
        "phase 15e", "phase 15e KITTI stereo driver (kitti_odometry.run_sequence, host "
        "frontend at its defaults, stereo_backend='opencv')", poses, traj[:2], records,
        seconds, launches, smi)
    row["driver"]["l1_launches"] = l1
    row["driver"]["sgm_scan_launches"] = launches["sgm_scan"]
    scan_launches("phase 15e", launches["sgm_scan"], len(poses), SCAN_ROWS[2:], results)
    if l1 != len(poses):
        raise SystemExit(f"phase 15e: L1 launched {l1} times for {len(poses)} frames")
    results[name]["launches"] = l1
    return row


# 15s: the SGM recurrence (csrc/sgm.cu) beyond the main paths' four shapes, on costs
# drawn from a seeded generator on the card: (label, [S, G, L, D], n_shift, has_prev
# ("xcols": the vertical scan's, the shifted members' line 0 without a predecessor;
# "random"; None), P1, P2, cap, largest cost, a 4-byte offset of the rows)
SCAN_CASES = (
    ("D 16, vertical four", (377, 4, 611, 16), 2, "xcols", 10, 120, None, 24, False),
    ("D 48, vertical four", (250, 4, 333, 48), 2, "xcols", 10, 120, None, 24, False),
    ("D 256, vertical four", (150, 4, 260, 256), 2, "xcols", 10, 120, None, 24, False),
    ("cap binding (P2 65000, cap 60000)", (300, 4, 200, 128), 2, "xcols", 10, 65000, 60000,
     30000, False),
    ("shifted members without a mask", (200, 3, 150, 128), 2, None, 10, 120, None, 24, False),
    ("S 1", (1, 4, 1241, 128), 2, "xcols", 10, 120, None, 24, False),
    ("L 1", (376, 4, 1, 128), 2, "xcols", 10, 120, None, 24, False),
    ("random mask, D 48", (100, 3, 200, 48), 1, "random", 10, 120, None, 24, False),
    ("D 99 (rows a value at a time)", (100, 2, 200, 99), 0, None, 10, 120, None, 24, False),
    ("D 1000 (32 values a lane)", (64, 2, 64, 1000), 1, "random", 10, 120, None, 24, False),
    ("rows off 16-byte alignment", (200, 2, 100, 128), 0, None, 200, 800, None, 4000, True),
)
SCAN_FLOOR_STEPS = 4096      # 15s: steps of the one-chain run that times a serial step
SCAN_ROWS = ("sgm_scan (horizontal pair, native / device SGM)",
             "sgm_scan (vertical four, native / device SGM)",
             "sgm_scan (StereoSGBM top)", "sgm_scan (StereoSGBM across)")
SCAN_REPLACES = ("unified_cvo_tpu/ops/sgm.py:154 (the lax.scan of _sgm_scan, :98; no Pallas "
                 "kernel)")


def record_scans(fn):
    """The arguments of every `_sgm_scan` call fn makes (ops/sgm.py's own and
    ops/sgbm_opencv.py's name for it), in order; each scan runs as usual."""
    from unified_cvo_tpu_torch.ops import sgbm_opencv as sg
    from unified_cvo_tpu_torch.ops import sgm

    real, calls = sgm._sgm_scan, []

    def recorder(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    recorder.launches = getattr(real, "launches", 0)   # the kernel counts into its global name
    sgm._sgm_scan = sg._sgm_scan = recorder
    try:
        fn()
    finally:
        sgm._sgm_scan = sg._sgm_scan = real
        if hasattr(real, "launches"):
            real.launches = recorder.launches
    return calls


def frame_scans(frame, dev):
    """The four scans of frame 0 (1241 x 376, D 128) on the card, as the
    paths call them: the native disparity's horizontal pair and vertical
    four (the device frontend's are the same shapes and settings), then
    StereoSGBM's top and across paths at JAX's settings; and the two frames'
    calls. Returns ([(args, kwargs)] x 4, native call, StereoSGBM call)."""
    from unified_cvo_tpu_torch.frontend import image, stereo
    from unified_cvo_tpu_torch.ops import sgbm_opencv as sg

    left, right = frame
    lk, rk = torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev)
    glk, grk = (image.opencv_gray(torch.from_numpy(im)).to(torch.uint8).to(dev)
                for im in (left, right))
    kw = stereo.opencv_settings(128)

    def native():
        return stereo.compute_disparity(lk, rk, backend="native")

    def sgbm():
        return sg.sgbm_3way(glk, grk, **kw)

    calls = record_scans(lambda: (native(), sgbm()))
    if len(calls) != 4:
        raise SystemExit(f"the native and StereoSGBM frames made {len(calls)} scans, not 4")
    return calls, native, sgbm


def scan_agree(args, kw, what):
    """The kernel against the plain version on the card, torch.equal, and
    two launches bit-equal. Returns the kernel's output."""
    from unified_cvo_tpu_torch.ops import sgm

    k1, k2 = sgm._sgm_scan(*args, **kw), sgm._sgm_scan(*args, **kw)
    plain = sgm.sgm_scan_plain(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(k1, plain):
        raise SystemExit(f"phase 15s: sgm_scan on {what} differs from its plain version at "
                         f"{int((k1 != plain).sum())} of {k1.numel()} cells")
    if not torch.equal(k1, k2):
        raise SystemExit(f"phase 15s: two sgm_scan launches on {what} differ")
    return k1


def scan_case(spec, dev, gen):
    """The arguments of a SCAN_CASES entry."""
    _, shape, n_shift, mask, p1, p2, cap, high, offset = spec
    n = int(np.prod(shape))
    flat = torch.randint(0, high + 1, (n + offset,), generator=gen, device=dev,
                         dtype=torch.int32)
    costs = flat[int(offset):].view(shape)
    G, L = shape[1], shape[2]
    hp = None
    if mask == "xcols":
        hp = torch.ones((G, L), dtype=torch.bool, device=dev)
        hp[G - n_shift:, 0] = False
    elif mask == "random":
        hp = torch.rand((G, L), generator=gen, device=dev) < 0.7
    return (costs, hp, n_shift, p1, p2), ({} if cap is None else {"cap": cap})


def sgm_scan_checks(frames, dev, smi, results):
    """15s: the SGM recurrence's kernel (csrc/sgm.cu, `_sgm_scan` on the card)
    against its plain version (`sgm_scan_plain`, torch ops on the card),
    torch.equal, and two launches bit-equal: on the four scans of frame 0
    as the native / device SGM and StereoSGBM paths call them, and on
    SCAN_CASES (D 16, 48, 99, 256, 1000, the cap binding, shifted members
    without a mask, S 1, L 1, a random mask, rows off alignment). Each of
    the four gets a kernels-line row: ms (CUDA events) beside the byte bound
    and the latency floor (its S serial steps times the time of one step,
    from one chain of SCAN_FLOOR_STEPS steps), plain ms, device kernels a
    call. Their launches are filled in from the drivers of 15c and 15e."""
    from unified_cvo_tpu_torch.ops import sgm

    t0 = time.perf_counter()
    calls, _, _ = frame_scans(frames[0], dev)
    gen = torch.Generator(device=dev).manual_seed(18)
    for spec in SCAN_CASES:
        args, kw = scan_case(spec, dev, gen)
        out = scan_agree(args, kw, spec[0])
        if kw and not bool((out == kw["cap"]).any()):
            raise SystemExit(f"phase 15s: the cap never binds on {spec[0]}")
        del args, out
    chain = torch.randint(0, 25, (SCAN_FLOOR_STEPS, 1, 1, 128), generator=gen, device=dev,
                          dtype=torch.int32)
    step_ms = device_ms(lambda: sgm._sgm_scan(chain, None, 0, 10, 120)) / SCAN_FLOOR_STEPS
    shapes = {}
    for name, (a, kw) in zip(SCAN_ROWS, calls):
        scan_agree(a, kw, name)
        costs, hp = a[0], a[1]
        nbytes = 2 * 4 * costs.numel() + (0 if hp is None else hp.numel())
        row = results[name] = kernel_row(
            name, "unified_cvo_tpu_torch/csrc/sgm.cu", SCAN_REPLACES,
            lambda a=a, kw=kw: sgm._sgm_scan(*a, **kw),
            lambda a=a, kw=kw: sgm.sgm_scan_plain(*a, **kw), nbytes, None)
        floor = costs.shape[0] * step_ms
        row.update(shape=list(costs.shape), n_shift=a[2], latency_floor_ms=floor,
                   step_us=1e3 * step_ms, binds="latency" if floor > row["bound_ms"] else "bytes")
        shapes[name] = tuple(costs.shape)
        log(f"  {name} {list(costs.shape)}: {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"(bytes: {nbytes / 1e6:.1f} MB), latency floor {floor:.4f} ms ({costs.shape[0]} "
            f"steps x {1e3 * step_ms:.4f} us), plain {row['plain_ms']:.2f} ms, "
            f"{row['launches_per_call']} device kernel(s) a call ({smi})")
    del calls
    seconds = time.perf_counter() - t0
    log(f"phase 15s sgm_scan: equal to its plain version and twice bit-equal on frame 0's four "
        f"scans {list(shapes.values())} and on {len(SCAN_CASES)} cases "
        f"({', '.join(c[0] for c in SCAN_CASES)}); one serial step of a chain "
        f"{1e3 * step_ms:.4f} us (D 128); {seconds:.1f} s ({smi})")
    return {"shapes": {k: list(v) for k, v in shapes.items()}, "step_us": 1e3 * step_ms,
            "cases": [c[0] for c in SCAN_CASES], "seconds": seconds}


def scan_launches(label, n, frames, rows, results):
    """The driver of `label` ran two scans a frame (one launch each); the
    rows' launches are its frames."""
    if n != 2 * frames:
        raise SystemExit(f"{label}: sgm_scan launched {n} times for {frames} frames, not 2 "
                         f"a frame")
    for name in rows:
        results[name]["launches"] = frames


def stereo_host_phase(dev, smi, results):
    """Phase 15: the KITTI stereo host frontend on the card. 15s: the SGM
    recurrence's kernel (sgm_scan_checks); 15a: the native
    census-SGM against the C++ library; 15b: Canny and EDGES_ONLY; 15a':
    the union-find kernels' fixed cases (cc_case_checks);
    15c: kitti_odometry.run_sequence at its defaults (NL-means, FAST,
    capacity 32768) on stereo_backend="native" (its JAX_MISSES were recorded
    there; "auto" is StereoSGBM where cv2 is importable, as on the card's
    machine) over 1 pair read from PNGs, pose error
    < 0.05 a pair, kernels 1-3 against their plain versions on its clouds of
    frames 0 and 1, L1 once a frame, sgm_scan twice a frame; one --semantic
    pair; 15d: irls_kitti,
    depth_filtering and indicator_sweep; 15e: the StereoSGBM backend
    (sgbm_part)."""
    import os
    import tempfile

    from unified_cvo_tpu_torch.apps import kitti_odometry
    from unified_cvo_tpu_torch.config import read_cvo_params_yaml
    from unified_cvo_tpu_torch.frontend import pipeline, stereo
    from unified_cvo_tpu_torch.frontend.calibration import read_calibration
    from unified_cvo_tpu_torch.ops import lidar as lops

    out, parts = {}, {}
    quiet = lambda *a: None                                   # noqa: E731
    cxx = native_cpp_build()                # g++ runs while the inputs are written
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_stereo_") as root:
            t0 = time.perf_counter()
            frames, runs = write_stereo_host_inputs(root)
            seq, yaml, _, traj = runs["phase 15c"]
            calib = read_calibration(os.path.join(seq, "cvo_calib.txt"), "stereo")
            parts["inputs"] = time.perf_counter() - t0
            log(f"phase 15: {len(frames)} stereo frames rendered and written as PNGs in "
                f"{parts['inputs']:.2f} s (host); compute_disparity's \"auto\" is "
                f"{stereo.auto_backend()!r} here (JAX's rule: cv2.StereoSGBM where cv2 is "
                f"importable): 15b and 15d take it, 15c runs 'native' (its JAX_MISSES), "
                f"15e 'opencv'")
            t0 = time.perf_counter()
            out["sgm_scan"] = sgm_scan_checks(frames, dev, smi, results)
            parts["15s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["disparity"] = disparity_checks(frames, cxx, dev, smi, results)
            parts["15a"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["canny"] = canny_checks(frames, calib, dev, smi, results)
            parts["15b"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["cc_cases"] = cc_case_checks(dev, smi, results)
            parts["15a'"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            params = read_cvo_params_yaml(yaml)
            clouds = [pipeline.pointcloud_from_stereo(l, r, calib, device=dev,
                                                      capacity=kitti_odometry.CAPACITY,
                                                      stereo_backend="native")
                      for l, r in frames[:2]]
            driver_kernel_checks(clouds[0], clouds[1], np.linalg.inv(traj[0]) @ traj[1], params,
                                 dev, results, "phase 15c frames 0 -> 1")
            del clouds
            for label, (seq_, yaml_, kw, traj_) in runs.items():
                reset_launch_counts()
                lops.reset_launches()
                records = []
                t1 = time.perf_counter()
                poses = kitti_odometry.run_sequence(seq_, yaml_, os.path.join(root, "traj.txt"),
                                                    log=quiet, device=dev, records=records,
                                                    stereo_backend="native", **kw)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t1
                l1 = lops.components.launches
                launches = launch_counts()
                key = "semantic" if "semantic" in label else "driver"
                out[key] = driver_report(
                    label, f"{label} KITTI stereo driver (kitti_odometry.run_sequence, host "
                    f"frontend at its defaults, stereo_backend='native'"
                    f"{', --semantic' if kw.get('semantic') else ''})", poses, traj_,
                    records, seconds, launches, smi)
                out[key]["l1_launches"] = l1
                out[key]["sgm_scan_launches"] = launches["sgm_scan"]
                scan_launches(label, launches["sgm_scan"], len(poses),
                              SCAN_ROWS[:2] if key == "driver" else (), results)
                if l1 != len(poses):
                    raise SystemExit(f"{label}: L1 launched {l1} times for {len(poses)} frames")
                if key == "driver":
                    results["lidar_components (stereo speckle)"]["launches"] = l1
            parts["15c"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            gt = np.stack([np.linalg.inv(traj[0]) @ T for T in traj])
            out["irls_kitti"] = irls_kitti_part(seq, gt, root, dev, smi)
            out["depth_filtering"] = depth_filtering_part(seq, gt, root, dev, smi)
            out["indicator_sweep"] = sweep_part(seq, yaml, traj, root, dev, smi)
            parts["15d"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["sgbm"] = sgbm_part(frames, runs, root, dev, smi, results)
            parts["15e"] = time.perf_counter() - t0
            idle = [n for n in SCAN_ROWS if not results[n]["launches"]]
            if idle:
                raise SystemExit(f"phase 15: no driver launched {idle}")
    finally:                                # no compiler left running on a failure
        if cxx[1] is not None and cxx[1][0].poll() is None:
            cxx[1][0].kill()
            cxx[1][0].wait()
    out["seconds"] = parts
    log("phase 15 parts: " + ", ".join(f"{k} {v:.2f} s" for k, v in parts.items()))
    return out


ORB_FEATURES = 3333                  # 16a: nfeatures, CANNY_EDGES' expected_points // 3
CANNY_EXPECTED = 10000               # 16b: pointcloud_from_stereo's expected_points
CANNY_CAPACITY = 32768               # 16b: kitti_odometry.CAPACITY
CANNY_ITER = 1500                    # 16b: the pair's iteration cap (the phase's YAML's)
CANNY_CHECK_ITER = 10                # 16b: the cap of a second run, before the pair parts
CANNY_POSE_TOL = 5e-3                # 16b: the North star's |log dT|, card against CPU
# 16b's pair: phase 15's frames 1 -> 2 through pointcloud_from_stereo(method=
# CANNY_EDGES) at its defaults, aligned from the identity at the phase YAML's
# schedule. The lists are rebuilt every few iterations, and CPU runs with the
# guess moved by +-1e-6 m part: by <= 1.3e-4 after 10 iterations (JAX's run
# 9.2e-5 from the port's), ~0.05 after 50, up to 0.078 at the 1500 cap, where
# the pair stops (frames 0 -> 1 at the first-frame schedule stop mid-descent,
# as phase 15c's pair 0 does). Per cap: the port's CPU run
# (its relative pose as an se(3) log, pose error, iterations, builds, the
# largest gap of four runs with the guess moved by +-1e-6 m along x and z),
# from `JAX_PLATFORMS=cpu python tests/test_torch_stereo_odometry.py
# --chip-canny --jax [--caps 10]`. The card must lie within CANNY_POSE_TOL of
# the CPU pose, or, where the pair stops at the cap, within twice the spread
# (two runs each within the spread of the CPU's may part by twice it).
CANNY_CPU = {
    CANNY_CHECK_ITER: ((-0.000939473, 0.009925253, 0.009902705, 0.00085994, 0.005214908,
                        0.010448275), 0.339706, 10, 3, 0.000126),
    CANNY_ITER: ((0.000818491, 0.009847128, -0.000735806, 0.000734271, 0.0214039,
                  0.158343724), 0.192530, 1500, 6, 0.078)}
GICP_TOL = 1e-9                      # 16c: T, card against CPU (float64)


def orb_checks(images, dev, smi):
    """16a: cv2.ORB's exact port (frontend/orb.py) on the card against the
    CPU on each (label, BGR) image's grey level: pt bit for bit, octave and
    response equal, in order; the whole call's ms (host clock, synchronised:
    its selection stages run on the host), its device kernels and busy time
    (torch.profiler), and each stage's ms (CUDA events; the host's
    retainBest by the host clock)."""
    from unified_cvo_tpu_torch.frontend import image, orb

    out = {}
    for label, bgr in images:
        gk, gc = (image.make_raw_image(bgr, denoise=False, device=d).intensity.to(torch.uint8)
                  for d in (dev, "cpu"))
        if not torch.equal(gk.cpu(), gc):
            raise SystemExit(f"phase 16a {label}: the grey level differs from the CPU's")
        kk = orb.detect(gk, ORB_FEATURES)
        t0 = time.perf_counter()
        kc = orb.detect(gc, ORB_FEATURES)
        cpu_s = time.perf_counter() - t0
        for f in ("pt", "octave", "response"):
            if not torch.equal(getattr(kk, f).cpu(), getattr(kc, f)):
                raise SystemExit(f"phase 16a {label}: ORB's {f} on the card differs from the "
                                 f"CPU's ({len(kk)} / {len(kc)} keypoints)")
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            orb.detect(gk, ORB_FEATURES)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        n_dev, busy = profiled(lambda: orb.detect(gk, ORB_FEATURES))
        levels = orb.pyramid(gk)
        budgets = orb.level_budgets(ORB_FEATURES)
        stages = {"pyramid": event_ms(lambda: orb.pyramid(gk))[0]}
        ms, corners = event_ms(lambda: [orb.fast_corners(im, orb.EDGE_THRESHOLD)
                                        for im in levels])
        stages["fast_nms_border"] = ms
        t0 = time.perf_counter()
        scores = [sc.tolist() for _, sc in corners]
        picks = [orb.retain_best(sc, 2 * b) for sc, b in zip(scores, budgets)]
        stages["retain_best_fast_host"] = 1e3 * (time.perf_counter() - t0)
        cand = [xy[torch.tensor(p, dtype=torch.int64, device=dev)]
                for (xy, _), p in zip(corners, picks)]
        ms, resp = event_ms(lambda: [orb.harris_responses(im, xy)
                                     for im, xy in zip(levels, cand)])
        stages["harris"] = ms
        t0 = time.perf_counter()
        for r, b in zip(resp, budgets):
            orb.retain_best(r.tolist(), b)
        stages["retain_best_harris_host"] = 1e3 * (time.perf_counter() - t0)
        row = {"shape": list(gk.shape), "keypoints": len(kk),
               "per_level": torch.bincount(kk.octave.long().cpu(), minlength=orb.N_LEVELS)
               .tolist(), "fast_corners": [len(sc) for sc in scores],
               "ms": statistics.median(walls), "device_kernels": n_dev, "device_busy_ms": busy,
               "stages_ms": stages, "cpu_s": cpu_s}
        out[label] = row
        log(f"phase 16a ORB ({gk.shape[1]} x {gk.shape[0]}, nfeatures {ORB_FEATURES}): "
            f"{len(kk)} keypoints {row['per_level']} from FAST corners "
            f"{row['fast_corners']}, card equal to the CPU (pt, octave, response, in order; "
            f"CPU {cpu_s:.2f} s); {row['ms']:.2f} ms a call (host clock, synchronised, median "
            f"of 5), {n_dev} device kernels+copies, busy {busy:.2f} ms; stages: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items()) + f" ({smi})")
    return out


def canny_pair(frames, calib, params, dev, guess=None, max_iter=CANNY_ITER, clouds=None):
    """16b's pair on `dev`: frames 1 and 2 through
    pointcloud_from_stereo(method=CANNY_EDGES) at its defaults on the native
    disparity, where CANNY_CPU was recorded (unless
    `clouds` are given), then align from `guess` (the identity) at `params`,
    `max_iter` iterations at most. Returns (clouds, T, ret, info)."""
    from unified_cvo_tpu_torch.frontend import pipeline
    from unified_cvo_tpu_torch.frontend import selector as sel
    from unified_cvo_tpu_torch.models.align import align

    if clouds is None:
        clouds = [pipeline.pointcloud_from_stereo(l, r, calib, method=sel.CANNY_EDGES,
                                                  capacity=CANNY_CAPACITY,
                                                  stereo_backend="native", device=dev)
                  for l, r in frames[1:3]]
    if guess is None:
        guess = torch.eye(4, dtype=torch.float32)
    T, ret, info = align(clouds[0], clouds[1], guess.to(dev), params, max_iter=max_iter,
                         device=dev)
    return clouds, T, ret, info


def canny_gap(T, info, cap, what):
    """The card's pose T of canny_pair at `cap` against the port's CPU run
    (CANNY_CPU[cap]): the gap, the tolerance and the CPU run's numbers; exits
    where the gap is not below the tolerance."""
    if cap not in CANNY_CPU:
        raise SystemExit(f"{what}: no CPU pose recorded at {cap} iterations (CANNY_CPU)")
    xi, cpu_err, cpu_iters, cpu_builds, spread = CANNY_CPU[cap]
    gap = jax_gap(xi, T)
    tol = max(CANNY_POSE_TOL, 2 * spread) if info.iterations == cap else CANNY_POSE_TOL
    log(f"  {what}, {cap} iterations at most: the card ran {info.iterations} iterations, "
        f"{info.nl_rebuilds} builds; the port's CPU run: pose error {cpu_err:.6f}, "
        f"{cpu_iters} iterations, {cpu_builds} builds, spread {spread:.3g} over +-1e-6 m "
        f"guesses; the card lies {gap:.3g} from its pose (tolerance {tol:.3g})")
    if not gap < tol:
        raise SystemExit(f"{what}: the card's pose lies {gap} from the CPU run's after {cap} "
                         f"iterations (tolerance {tol})")
    return {"gap_to_cpu": gap, "tolerance": tol, "cpu_pose_error": cpu_err,
            "cpu_iterations": cpu_iters, "cpu_builds": cpu_builds, "cpu_spread": spread}


def canny_orb_checks(frames, traj, calib, params, dev, smi, results):
    """16b: the CANNY_EDGES selection of frame 0 on the card against the CPU
    (uv and types equal); then canny_pair on the card (the exact NL-means,
    the native disparity, ORB, Canny, align), the launches of select,
    flow_reduce, step_cached, components8 and L1 counted from 0 around it;
    components8 against its plain version on frame 0's candidates, kernels
    1-3 against theirs on the pair's clouds; the pose against the port's
    CPU run (CANNY_CPU) within CANNY_POSE_TOL, or within twice the CPU runs'
    spread where the pair stops at the cap, at CANNY_ITER and again at
    CANNY_CHECK_ITER iterations (before the runs part)."""
    from unified_cvo_tpu_torch.apps import f2f_sequence as f2f
    from unified_cvo_tpu_torch.frontend import image
    from unified_cvo_tpu_torch.frontend import selector as sel
    from unified_cvo_tpu_torch.ops import canny
    from unified_cvo_tpu_torch.ops import lidar as lops

    left = frames[0][0]
    t0 = time.perf_counter()
    picks = [sel.select_points(image.make_raw_image(left, denoise=False, device=d), "stereo",
                               sel.CANNY_EDGES, CANNY_EXPECTED, seed=0) for d in (dev, "cpu")]
    select_s = time.perf_counter() - t0
    if not all(torch.equal(a.cpu(), b) for a, b in zip(*picks)):
        raise SystemExit("phase 16b: the CANNY_EDGES selection on the card differs from the "
                         "CPU's")
    n_surface = int(picks[1][1][:, 1].sum())
    reset_launch_counts()
    canny.reset_launches()
    lops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clouds, T, ret, info = canny_pair(frames, calib, params, dev)
    torch.cuda.synchronize()
    pair_s = time.perf_counter() - t0
    launches = launch_counts()
    c8, l1 = canny.components8.launches, lops.components.launches
    T = T.cpu().numpy().astype(np.float64)
    err = f2f.pose_errors([T], [np.linalg.inv(traj[2]) @ traj[1]])[0]
    row = {"select_card_and_cpu_s": select_s, "picks": len(picks[1][0]),
           "surface_picks": n_surface, "cloud_points": [int(c.mask.sum()) for c in clouds],
           "pair_s": pair_s, "iterations": info.iterations,
           "builds": info.nl_rebuilds, "final_ell": float(info.final_ell), "ret": int(ret),
           "pose_error": err, "launches": {"select": launches["select"],
                                            "flow_reduce": launches["flow_reduce"],
                                            "step_cached": launches["step_cached"],
                                            "components8": c8, "lidar_components": l1}}
    log(f"phase 16b CANNY_EDGES ({left.shape[1]} x {left.shape[0]}, expected "
        f"{CANNY_EXPECTED}): {row['picks']} picks ({n_surface} surface), card equal to the "
        f"CPU ({select_s:.2f} s both); frames 1 -> 2: clouds {row['cloud_points']} and "
        f"align in {pair_s:.2f} s (host clock), {info.iterations} iterations, "
        f"{info.nl_rebuilds} builds, final ell {row['final_ell']:.6f}, pose error {err:.6f}; "
        f"launches {row['launches']} ({smi})")
    if not (row["ret"] == 0 and launches["select"] >= info.nl_rebuilds > 0
            and launches["flow_reduce"] == launches["step_cached"] == info.iterations > 0
            and c8 == 2 and l1 == 2):
        raise SystemExit(f"phase 16b: launches {row['launches']} do not match 2 clouds, "
                         f"{info.nl_rebuilds} builds and {info.iterations} iterations")
    row["cpu"] = {CANNY_ITER: canny_gap(T, info, CANNY_ITER, "phase 16b")}
    _, Tc, _, ic = canny_pair(frames, calib, params, dev, max_iter=CANNY_CHECK_ITER,
                              clouds=clouds)
    row["cpu"][CANNY_CHECK_ITER] = canny_gap(Tc.cpu().numpy().astype(np.float64), ic,
                                             CANNY_CHECK_ITER, "phase 16b")
    gk = image.make_raw_image(left, device=dev).intensity
    cand, _ = canny.canny_candidates(gk)
    if not torch.equal(canny.components8(cand), canny.components8_plain(cand)):
        raise SystemExit("phase 16b: components8 differs from its plain version")
    driver_kernel_checks(clouds[0], clouds[1], np.linalg.inv(traj[1]) @ traj[2], params, dev,
                         results, "phase 16b frames 1 -> 2")
    for name in ("select", "flow_reduce", "step_cached"):
        results[name]["launches_canny_edges_pair"] = launches[name]
    if "components8" in results:
        results["components8"]["launches_canny_edges_pair"] = c8
    return row


def tools_checks(root, dev, smi):
    """16c: the tools on the card against the CPU: gicp_align on two PCDs
    of PCD_POINTS points cut from two rendered HDL-64 scans as phase 13d
    cuts them (T within GICP_TOL, iterations equal); evaluate_semantics on a
    19-class label PNG at 1241 x 376 (confusion and IoU equal); the
    PrefetchLoader on the scans' velodyne bins (equal to np.fromfile)."""
    import os

    from unified_cvo_tpu_torch.apps import evaluate_semantics as sem
    from unified_cvo_tpu_torch.apps import gicp_align_two as gicp
    from unified_cvo_tpu_torch.datasets import png
    from unified_cvo_tpu_torch.datasets.kitti import KittiHandler
    from unified_cvo_tpu_torch.datasets.pcd import read_pcd
    from unified_cvo_tpu_torch.datasets.prefetch import PrefetchLoader
    from unified_cvo_tpu_torch.utils import synth

    out = {}
    kdir = os.path.join(root, "kitti_lidar")
    traj = synth.corridor_trajectory(2, step=0.15, yaw_rate=0.02, bob=0.0)
    synth.write_kitti_lidar_sequence(
        kdir, synth.room_scene(11, half=8.0, floor_y=1.8, ceil_y=-3.0, n_pillars=4), traj,
        n_beams=LIDAR_BEAMS, n_az=LIDAR_AZ, noise=0.005, fov_deg=LIDAR_FOV)
    bins = [os.path.join(kdir, "velodyne", f"{i:06d}.bin") for i in range(2)]
    loader = PrefetchLoader(2)
    tickets = [loader.submit(p, PrefetchLoader.RAW_F32) for p in bins]
    for p, t in zip(bins, tickets):
        if not np.array_equal(loader.get(t), np.fromfile(p, np.float32)):
            raise SystemExit(f"phase 16c: the PrefetchLoader's {p} differs from np.fromfile")
    loader.close()
    reader = KittiHandler(kdir, "lidar")
    scans = []
    for _ in range(2):
        scans.append(reader.read_next_lidar())
        reader.next()
    src, tgt = os.path.join(root, "source.pcd"), os.path.join(root, "target.pcd")
    pcd_pair(scans, src, tgt)
    sx, tx = read_pcd(src)[0], read_pcd(tgt)[0]
    runs = {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        runs[str(d)] = gicp.gicp_align(sx, tx, device=d) + (time.perf_counter() - t0,)
    (Tk, ik, rk, sk), (Tc, ic, rc, sc) = runs[str(dev)], runs["cpu"]
    gap = float(np.abs(Tk - Tc).max())
    out["gicp"] = {"points": len(sx), "iterations": ik, "rmse": rk, "card_s": sk, "cpu_s": sc,
                   "max_abs_T_gap": gap}
    log(f"phase 16c gicp_align ({len(sx)} / {len(tx)} points): {ik} iterations, rmse {rk:.6f}, "
        f"card {sk:.2f} s, CPU {sc:.2f} s (host clocks; the kNN on the host), T max abs gap "
        f"{gap:.3g} (tolerance {GICP_TOL}) ({smi})")
    if not (ik == ic and gap <= GICP_TOL):
        raise SystemExit(f"phase 16c: gicp_align on the card ({ik} iterations) differs from "
                         f"the CPU's ({ic}) by {gap}")
    rng = np.random.default_rng(16)
    h, w = KITTI00["rows"], KITTI00["cols"]
    gt = rng.integers(0, STEREO_CLASSES, (h, w)).astype(np.uint8)
    pred = np.where(rng.random((h, w)) < 0.7, gt, rng.integers(0, 255, (h, w))).astype(np.uint8)
    paths = [os.path.join(root, f"{n}.png") for n in ("gt", "pred")]
    for path, a in zip(paths, (gt, pred)):
        png.imwrite(path, a)
    labels = [sem._load(p) for p in paths]
    ek, ec = (sem.evaluate(*labels, STEREO_CLASSES, (0,), device=d) for d in (dev, "cpu"))
    if not (torch.equal(ek["confusion"].cpu(), ec["confusion"])
            and np.array_equal(ek["iou"].cpu().numpy(), ec["iou"].numpy(), equal_nan=True)
            and (ek["mean_iou"], ek["accuracy"]) == (ec["mean_iou"], ec["accuracy"])):
        raise SystemExit("phase 16c: evaluate_semantics on the card differs from the CPU's")
    ms, _ = event_ms(lambda: sem.confusion_matrix(*labels, STEREO_CLASSES, (0,), device=dev))
    out["evaluate_semantics"] = {"mean_iou": ek["mean_iou"], "accuracy": ek["accuracy"],
                                 "confusion_ms": ms}
    log(f"phase 16c evaluate_semantics ({w} x {h}, {STEREO_CLASSES} classes): card equal to "
        f"the CPU, mean IoU {ek['mean_iou']:.6f}, accuracy {ek['accuracy']:.6f}, confusion "
        f"{ms:.3f} ms (CUDA events); PrefetchLoader equal to np.fromfile on 2 velodyne bins "
        f"({smi})")
    return out


def orb_phase(dev, smi, results):
    """Phase 16: cv2's ORB as an exact port, CANNY_EDGES on the card, and the
    remaining tools. 16a: ORB on phase 15's KITTI frame 0 read back from its
    PNG, on phase 10's 640 x 480 frame and on a 1241 x 376 block texture
    whose every level holds more corners than its budget, card against CPU; 16b: the
    CANNY_EDGES selection card against CPU and one stereo pair through
    pointcloud_from_stereo(method=CANNY_EDGES) and align on the card; 16c:
    gicp_align, evaluate_semantics and the PrefetchLoader card against CPU
    (the viewer needs matplotlib, which the card's machine lacks). 16c runs
    before 16b."""
    import os
    import tempfile

    from unified_cvo_tpu_torch.config import read_cvo_params_yaml
    from unified_cvo_tpu_torch.datasets import png

    out, parts = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_orb_") as root:
        t0 = time.perf_counter()
        calib, frames, traj = stereo_frames()
        path = os.path.join(root, "000000.png")
        png.imwrite(path, frames[0][0])
        kitti_left = png.imread(path)
        tum_bgr = rgbd_frames(poses=[0])[1][0][0]
        # 2 x 2 blocks of seeded grey: FAST finds more corners than every
        # level's budget, so retainBest selects (the rendered frames fill none)
        blocks = np.kron(np.random.default_rng(16).integers(0, 256, (188, 621), np.uint8),
                         np.ones((2, 2), np.uint8))[:KITTI00["rows"], :KITTI00["cols"]]
        yaml = os.path.join(root, "stereo.yaml")
        with open(yaml, "w") as f:
            f.write(STEREO_HOST_YAML)
        params = read_cvo_params_yaml(yaml)
        parts["inputs"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["orb"] = orb_checks([("KITTI frame 0 (PNG)", kitti_left), ("TUM frame 0", tum_bgr),
                                 ("block texture", np.repeat(blocks[..., None], 3, -1))],
                                dev, smi)
        parts["16a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["tools"] = tools_checks(root, dev, smi)
        parts["16c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["canny_edges"] = canny_orb_checks(frames, traj, calib, params, dev, smi, results)
        parts["16b"] = time.perf_counter() - t0
    out["seconds"] = parts
    log("phase 16 parts: " + ", ".join(f"{k} {v:.2f} s" for k, v in parts.items()))
    return out


# Phase 17: batched registration (the lane axis of the ELL consume kernels)
# and the sharded paths (parallel/) on the card.
LANES = 4                    # 17a-b: lanes of the lane-axis kernels, pairs of the batch
BATCH_ITER = 200             # 17b: iteration cap of the batch and of its sequential runs
BATCH_POSE_TOL = 2e-3        # 17b: a lane's transform against its sequential run's (abs)
BATCH_PROFILE_ITER = 50      # 17b: iterations of the profiled batch (idle share)
DENSE_BATCH_ITER = 100       # 17b: iteration cap of the dense batch and of its sequential
#                              runs (a dense iteration is ~13 ms a pair on the card)
SHARD_RANKS = 2              # 17c: gloo ranks sharing the one card (NCCL takes one a card)
SHARD_POINTS = 4096          # 17c: points of the sp / ring pair (bench frames 0 -> 1)
# 17c: iteration cap of the sp / ring loops. Dense 'jnp' pairs stop far from
# convergence at any cap the phase can afford, and reordered float32 sums
# spread their poses with the iterations: on 2048 bench points (CPU) two
# chunkings part by 1.3e-4 after 20 iterations, 2.1e-4 after 40 and 6.1e-3
# after 120, over the sp bound. 40 keeps the comparison a test of the
# sharding, not of that spread.
SHARD_ITER = 40
SHARD_TIMEOUT = 300.0        # 17c: seconds before every rank is killed


def irls_case():
    """test_sharding.py's sharded-IRLS setup (5 frames of 256 points, 10
    edges, the first frame the pivot), as numpy, and its params' fields."""
    from unified_cvo_tpu_torch.ops import lie

    rng = np.random.default_rng(0)
    F, n = 5, 256
    base = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(-1, 1, n)],
                    axis=1).astype(np.float32)
    frames = []
    for f in range(F):
        xi = 0.06 * rng.normal(size=6).astype(np.float32)
        R, t = (v.numpy() for v in lie.se3_exp(torch.from_numpy(xi), 1.0))
        if f == 0:
            R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        frames.append(((base - t) @ R).astype(np.float32))
    edges = [(i, j) for i in range(F) for j in range(i + 1, F)]
    fields = dict(ell_init=0.5, multiframe_ell_init=0.5, multiframe_ell_min=0.15,
                  multiframe_ell_decay_rate=0.8, multiframe_iterations_per_ell=3,
                  multiframe_iterations_per_solve=4, multiframe_min_nonzeros=10,
                  multiframe_max_iters=40)
    return frames, edges, [True] + [False] * (F - 1), fields


def lane_inputs(params, frames_np, guess, dev, feats=None):
    """[LANES, ...] inputs of the lane-axis passes: LANES bench pairs (frame
    b -> b + 1 at the bench guess, 16384 points, K = 32): x packs, the grid
    lists' slots (and channel factors, with feats), scalar blocks."""
    from unified_cvo_tpu_torch.ops import ell as ell_ops
    from unified_cvo_tpu_torch.ops import lie
    from unified_cvo_tpu_torch.ops import neighbors as nbr
    from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud

    ell = torch.full((), params.ell_init, dtype=torch.float32, device=dev)
    Rinv, Tinv = lie.invert_rt(guess[:3, :3], guess[:3, 3])
    xp, ys, chans = [], [], []
    for b in range(LANES):
        src, tgt = (make_pointcloud(frames_np[b + i], features=feats, bucket=N_POINTS, device=dev)
                    for i in (0, 1))
        nl = nbr.build_neighbor_list(params, ell, src, tgt, Rinv, Tinv)
        xp.append(ell_ops.pack_x(params, ell, src))
        ys.append(nl.y_xyz)
        chans.append(nl.chan)
    scal = ell_ops.pack_scalars(params, Rinv, Tinv).expand(LANES, -1).contiguous()
    return (torch.stack(xp), torch.stack(ys), scal,
            None if chans[0] is None else torch.stack(chans))


def lane_row(name, replaces, kfn, seqfn, pfn, b_ms, b_by, err, floor, n_dev, source):
    """Times of a lane-axis kernel (kfn(B) on the first B lanes) at B =
    LANES and B = 1 against LANES unbatched calls (seqfn) and its plain
    version; its kernels line row."""
    ms = device_ms(lambda: kfn(LANES))
    ms1 = device_ms(lambda: kfn(1))
    seq_ms = device_ms(seqfn)
    plain_ms = device_ms(pfn, reps=3, trials=3)
    log(f"time   {name} (B = {LANES}): kernel {ms:.4f} ms, B = 1 {ms1:.4f} ms, {LANES} "
        f"unbatched calls {seq_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}: the {LANES} lanes' work), launch floor {floor:.4f} ms, {n_dev} device "
        f"kernel(s) a call")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "lanes": LANES,
            "ms_b1": ms1, "ms_sequential": seq_ms, "launches_per_call": n_dev,
            "launch_floor_ms": floor}


def lane_kernel_checks(frames_np, feats, guess_np, dev, results, floor):
    """17a: flow_reduce_lanes and step_cached_lanes at B = 4 x N = 16384, K =
    32 (geometry, and geometry x channel), also at N = 16100 and 16099, held
    against their plain versions lane by lane (flow_agree, step_agree), each
    lane bit-equal to the unbatched launch on its inputs, at B = 4 and at B =
    1; two launches bit-equal; the step fed the flow's twist rows as they lie
    in its output; one device kernel a call; the finish counters back at 0.
    Times: one lane-axis launch against B unbatched launches, and at B = 1."""
    from unified_cvo_tpu_torch.config import KITTI_COLOR_BENCH
    from unified_cvo_tpu_torch.config import KITTI_GEOMETRIC_BENCH as params
    from unified_cvo_tpu_torch.ops import ell as ell_ops

    guess = torch.from_numpy(guess_np).to(dev)
    f_err = s_err = 0.0
    for label, p, ft in (("geo", params, None), ("geo x chan", KITTI_COLOR_BENCH, feats)):
        full = lane_inputs(p, frames_np, guess, dev, ft)
        for n in (None,) + N_ODD:
            xp, y, sc, ch = (None if t is None else t if n is None else t[..., :n].contiguous()
                             for t in full)
            what = f"({label}, B = {LANES}, N = {xp.shape[-1]})"
            fk = ell_ops.flow_reduce_lanes(xp, y, sc, p.c, p.d, chan=ch)
            fk2 = ell_ops.flow_reduce_lanes(xp, y, sc, p.c, p.d, chan=ch)
            fp = ell_ops.flow_reduce_plain(xp, y, sc, p.c, p.d, chan=ch)
            sk = ell_ops.step_cached_lanes(xp, y, fk[4], sc, twist=fk[0])
            sk2 = ell_ops.step_cached_lanes(xp, y, fk[4], sc, twist=fk[0])
            sp = ell_ops.step_cached_plain(xp, y, fk[4], sc, twist=fk[0].contiguous())
            torch.cuda.synchronize()
            if not (all(torch.equal(a, b) for a, b in zip(fk, fk2)) and torch.equal(sk, sk2)):
                raise SystemExit(f"two lane-axis launches on the same inputs differ {what}")
            for b in range(LANES):
                _, A_err, tw_err, _ = flow_agree([v[b] for v in fk], [v[b] for v in fp],
                                                 f"lane {b} {what}")
                f_err = max(f_err, A_err, tw_err)
                s_err = max(s_err, step_agree(sk[b], sp[b], f"lane {b} {what}"))
            # every lane equals the unbatched launch on its inputs, at B = 4 and B = 1
            f1b = ell_ops.flow_reduce_lanes(xp[:1], y[:1], sc[:1], p.c, p.d,
                                            chan=None if ch is None else ch[:1])
            s1b = ell_ops.step_cached_lanes(xp[:1], y[:1], f1b[4], sc[:1], twist=f1b[0])
            for b in range(LANES):
                f1 = ell_ops.flow_reduce(xp[b], y[b], sc[b], p.c, p.d,
                                         chan=None if ch is None else ch[b])
                s1 = ell_ops.step_cached(xp[b], y[b], f1[4], sc[b], twist=f1[0])
                if not (all(torch.equal(u[b], v) for u, v in zip(fk, f1))
                        and torch.equal(sk[b], s1)):
                    raise SystemExit(f"lane {b} differs from the unbatched launch {what}")
                if b == 0 and not (all(torch.equal(u[0], v) for u, v in zip(f1b, f1))
                                   and torch.equal(s1b[0], s1)):
                    raise SystemExit(f"B = 1 differs from the unbatched launch {what}")
            log(f"lanes  {what}: flow and step within tolerance of the plain versions lane by "
                f"lane, every lane bit-equal to the unbatched launch (B = 1 too), reruns "
                f"bit-equal; nonzeros per lane {fk[2].tolist()}")
    check_counters_zero(ell_ops, dev, "phase 17a")

    xp, y, sc, _ = lane_inputs(params, frames_np, guess, dev)
    K, N = y.shape[2], y.shape[3]
    fk = ell_ops.flow_reduce_lanes(xp, y, sc, params.c, params.d)
    A, tw = fk[4], fk[0]
    slot_bytes = 3 * K * N * 4 + 6 * N * 4 + 32 * 4
    rows = {
        "flow_reduce_lanes": (
            lambda B: ell_ops.flow_reduce_lanes(xp[:B], y[:B], sc[:B], params.c, params.d),
            lambda: [ell_ops.flow_reduce(xp[b], y[b], sc[b], params.c, params.d)
                     for b in range(LANES)],
            lambda: ell_ops.flow_reduce_plain(xp, y, sc, params.c, params.d),
            bound(LANES * (slot_bytes + K * N * 4 + 36), LANES * FLOW_OPS_PER_SLOT * K * N),
            f_err, "unified_cvo_tpu/ops/pallas_ell.py:184 (_flow_reduce_kernel, under jax.vmap "
                   "of align: parallel/batch_align.py:51-55)"),
        "step_cached_lanes": (
            lambda B: ell_ops.step_cached_lanes(xp[:B], y[:B], A[:B], sc[:B], twist=tw[:B]),
            lambda: [ell_ops.step_cached(xp[b], y[b], A[b], sc[b], twist=tw[b])
                     for b in range(LANES)],
            lambda: ell_ops.step_cached_plain(xp, y, A, sc, twist=tw.contiguous()),
            bound(LANES * (slot_bytes + K * N * 4 + 24 + 16), LANES * STEP_OPS_PER_SLOT * K * N),
            s_err, "unified_cvo_tpu/ops/pallas_ell.py:230 (_step_kernel_cached, under jax.vmap "
                   "of align: parallel/batch_align.py:51-55)"),
    }
    for kname, (kfn, seqfn, pfn, (b_ms, b_by), err, replaces) in rows.items():
        n_dev = kernels_per_call(lambda: kfn(LANES))
        if n_dev != 1:
            raise SystemExit(f"{kname}: one call launched {n_dev} device kernels, not 1")
        results[kname] = lane_row(kname, replaces, kfn, seqfn, pfn, b_ms, b_by, err, floor,
                                  n_dev, "unified_cvo_tpu_torch/csrc/ell.cu")
    check_counters_zero(ell_ops, dev, "phase 17a timings")


def lane_select_checks(frames_np, guess_np, dev, results, floor):
    """17a, select_lanes: the grid inputs of LANES bench pairs (frames b ->
    b + 1, 16384 points, KITTI_GEOMETRIC_BENCH at the bench guess and
    ell_init) in one launch, held against select_lanes_plain (torch.equal:
    the same slots in the same order), every lane and B = 1 bit-equal to
    the unbatched select on its inputs, two launches bit-equal, one device
    kernel a call. Bound: the lanes' select_work summed."""
    from unified_cvo_tpu_torch.config import KITTI_GEOMETRIC_BENCH as params
    from unified_cvo_tpu_torch.ops import lie
    from unified_cvo_tpu_torch.ops import neighbors as nbr
    from unified_cvo_tpu_torch.ops import select as sel
    from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud

    K, P, dims = nbr.DEFAULT_K, nbr.PER_CELL_CAP, nbr.GRID_DIMS
    guess = torch.from_numpy(guess_np).to(dev)
    Rinv, Tinv = lie.invert_rt(guess[:3, :3], guess[:3, 3])
    ell = torch.full((), params.ell_init, dtype=torch.float32, device=dev)
    gs = [nbr.grid_inputs(params, ell, *(make_pointcloud(frames_np[b + i], bucket=N_POINTS,
                                                         device=dev) for i in (0, 1)),
                          Rinv, Tinv) for b in range(LANES)]
    lanes = [torch.stack([getattr(g, f) for g in gs]) for f in ("tab", "cbase", "xr2", "pose")]

    def kfn(B):
        return sel.select_lanes(*(t[:B] for t in lanes), K, P, dims)

    def seqfn():
        return [sel.select(g.tab, g.cbase, g.xr2, g.pose, K, P, dims) for g in gs]

    got, again, one = kfn(LANES), kfn(LANES), kfn(1)
    want = sel.select_lanes_plain(*lanes, K, P, dims)
    single = seqfn()
    torch.cuda.synchronize()
    what = f"(B = {LANES}, N = {N_POINTS})"
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise SystemExit(f"select_lanes differs from select_lanes_plain {what}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise SystemExit(f"two select_lanes launches on the same inputs differ {what}")
    for b in range(LANES):
        if not all(torch.equal(u[b], v) for u, v in zip(got, single[b])):
            raise SystemExit(f"select_lanes lane {b} differs from the unbatched select {what}")
    if not all(torch.equal(u[0], v) for u, v in zip(one, single[0])):
        raise SystemExit(f"select_lanes at B = 1 differs from the unbatched select {what}")
    n_dev = kernels_per_call(lambda: kfn(LANES))
    if n_dev != 1:
        raise SystemExit(f"select_lanes: one call launched {n_dev} device kernels, not 1")
    log(f"lanes  select_lanes {what}: equal to select_lanes_plain, every lane and B = 1 "
        f"bit-equal to the unbatched select, reruns bit-equal; kept per lane "
        f"{got[2].sum(dim=1).tolist()}")
    work = [select_work(sel, g, K, P, dims) for g in gs]
    b_ms, b_by = bound(sum(w[0] for w in work), sum(w[1] for w in work))
    results["select_lanes"] = lane_row(
        "select_lanes", "unified_cvo_tpu/ops/pallas_select.py:39 (_select_kernel, under "
        "jax.vmap of align: parallel/batch_align.py:51-55)", kfn, seqfn,
        lambda: sel.select_lanes_plain(*lanes, K, P, dims), b_ms, b_by, 0.0, floor, n_dev,
        "unified_cvo_tpu_torch/csrc/select.cu")


def dense_case(params, frames_np, feats, b, Rinv, Tinv, dev):
    """Phase 2b's dense case on frames b -> b + 1 (16384 points with 5
    features, Morton-sorted, the target moved by (Rinv, Tinv), ell_init
    culling, tiles 128 x 512): (layout, xp, yp, the step's yp with the
    plain flow's twist, the [nI, nJ] cull mask, its compaction)."""
    from unified_cvo_tpu_torch.ops import dense, kernels, morton
    from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud

    ti, tj = dense.DEFAULT_TILE_I, dense.DEFAULT_TILE_J
    ell = torch.full((), params.ell_init, dtype=torch.float32, device=dev)
    src, tgt = (morton.sort_cloud(make_pointcloud(frames_np[b + i], features=feats,
                                                  bucket=N_POINTS, device=dev))[0]
                for i in (0, 1))
    y_t = tgt.transformed(Rinv, Tinv)
    x_lo, x_hi = morton.tile_aabbs(src.xyz, src.mask, ti)
    y_lo, y_hi = morton.tile_aabbs(y_t.xyz, y_t.mask, tj)
    mask = morton.tile_cull_mask(x_lo, x_hi, morton.tile_d2max(params, ell, src.xyz, src.mask,
                                                               ti), y_lo, y_hi)
    lo = dense.layout_for(params, src)
    c = dense.cloud_center(src)
    xp, yp = dense.pack_x(params, lo, src, ell, center=c), dense.pack_y(lo, y_t, center=c)
    comp = dense.compact_tile_mask(mask)
    fp = dense.dense_flow_plain(params, lo, xp, yp, comp, ti, tj)
    twist, _ = kernels.flow_from_stats(params, src, kernels.FlowStats(
        fp[0], fp[1] + fp[0][:, None] * c, fp[2], fp[3]))
    return lo, xp, yp, dense.pack_y(lo, y_t, twist=twist, center=c), mask, comp


def dense_times(frames_np, feats, guess_np, dev, times, nodes):
    """--kernel-times: dense_flow and dense_step (rows 6-7) on phase 2b's
    case (a), KITTI_COLOR_BENCH on frames 0 -> 1 at the bench guess
    (dense_case), held to their plain versions (dense_agree), then timed."""
    from unified_cvo_tpu_torch.config import KITTI_COLOR_BENCH as params
    from unified_cvo_tpu_torch.ops import dense, lie

    ti, tj = dense.DEFAULT_TILE_I, dense.DEFAULT_TILE_J
    guess = torch.from_numpy(guess_np).to(dev)
    lo, xp, yp, yt, _, comp = dense_case(params, frames_np, feats, 0,
                                         *lie.invert_rt(guess[:3, :3], guess[:3, 3]), dev)
    dense_agree(dense, params, lo, xp, yp, yt, comp, ti, tj, "case a, kernel times")
    for name, fn in (("dense_flow", lambda: dense.dense_flow(params, lo, xp, yp, comp, ti, tj)),
                     ("dense_step", lambda: dense.dense_step(params, lo, xp, yt, comp, ti, tj))):
        nodes[name] = kernels_per_call(fn)
        times[name] = device_ms(fn)


def lane_dense_checks(frames_np, feats, guess_np, dev, results, floor):
    """17a, dense_flow_lanes and dense_step_lanes: LANES bench pairs of
    KITTI_COLOR_BENCH (frames b -> b + 1, 16384 points with 5 features,
    Morton-sorted, the bench guess, ell_init culling, tiles 128 x 512:
    phase 2b's shapes) in one call each, every lane held against the plain
    versions at phase 2b's tolerances (dense_close), every lane and B = 1
    bit-equal to the unbatched call on its own compaction, two calls
    bit-equal, a frozen lane (count 0) zeros with the others unchanged; as
    many device kernels a call as one unbatched call. Bound: the lanes' work
    summed (phase 2b's bytes and dense_ops, lane by lane)."""
    from unified_cvo_tpu_torch.config import KITTI_COLOR_BENCH as params
    from unified_cvo_tpu_torch.ops import dense, lie

    ti, tj = dense.DEFAULT_TILE_I, dense.DEFAULT_TILE_J
    guess = torch.from_numpy(guess_np).to(dev)
    Rinv, Tinv = lie.invert_rt(guess[:3, :3], guess[:3, 3])
    cases = [dense_case(params, frames_np, feats, b, Rinv, Tinv, dev) for b in range(LANES)]
    lo = cases[0][0]
    comps = [c[5] for c in cases]
    xp, yp, yt, mask = (torch.stack([c[i] for c in cases]) for i in range(1, 5))
    comp = dense.compact_tile_mask_lanes(mask)
    comp1 = dense.compact_tile_mask_lanes(mask[:1])
    live = torch.tensor([b != 1 for b in range(LANES)], device=dev)
    frozen = dense.compact_tile_mask_lanes(mask, live)

    def lanes(B, c):
        return (comp if B == LANES else comp1) if c is None else c

    def flow(B, c=None):
        return dense.dense_flow_lanes(params, lo, xp[:B], yp[:B], lanes(B, c), ti, tj)

    def step(B, c=None):
        return dense.dense_step_lanes(params, lo, xp[:B], yt[:B], lanes(B, c), ti, tj)

    fk, fk2, f1, ff = flow(LANES), flow(LANES), flow(1), flow(LANES, frozen)
    sk, sk2, s1, sf = step(LANES), step(LANES), step(1), step(LANES, frozen)
    fp = dense.dense_flow_lanes_plain(params, lo, xp, yp, comp, ti, tj)
    sp = dense.dense_step_lanes_plain(params, lo, xp, yt, comp, ti, tj)
    single = [(dense.dense_flow(params, lo, xp[b], yp[b], comps[b], ti, tj),
               dense.dense_step(params, lo, xp[b], yt[b], comps[b], ti, tj))
              for b in range(LANES)]
    torch.cuda.synchronize()
    what = f"(B = {LANES}, N = M = {N_POINTS}, tiles {ti} x {tj})"
    if not (all(torch.equal(a, b) for a, b in zip(fk, fk2)) and torch.equal(sk, sk2)):
        raise SystemExit(f"two dense lane calls on the same inputs differ {what}")
    f_err = s_err = 0.0
    for b in range(LANES):
        got = dense_close([v[b] for v in fk], [v[b] for v in fp], sk[b], sp[b],
                          f"lane {b} {what}")
        f_err, s_err = max(f_err, got["f_err"]), max(s_err, got["s_err"])
        fb, sb = single[b]
        if not (all(torch.equal(u[b], v) for u, v in zip(fk, fb)) and torch.equal(sk[b], sb)):
            raise SystemExit(f"dense lane {b} differs from the unbatched call {what}")
        if b == 0 and not (all(torch.equal(u[0], v) for u, v in zip(f1, fb))
                           and torch.equal(s1[0], sb)):
            raise SystemExit(f"dense lanes at B = 1 differ from the unbatched call {what}")
        same = (all(torch.equal(u[b], v[b]) for u, v in zip(ff, fk))
                and torch.equal(sf[b], sk[b]))
        if b == 1:
            same = not (any(bool(u[b].any()) for u in ff) or bool(sf[b].any()))
        if not same:
            raise SystemExit(f"dense lanes with lane 1 frozen: lane {b} wrong {what}")
    n_flow = kernels_per_call(lambda: flow(LANES))
    n_step = kernels_per_call(lambda: step(LANES))
    n_flow1 = kernels_per_call(lambda: dense.dense_flow(params, lo, xp[0], yp[0], comps[0],
                                                        ti, tj))
    n_step1 = kernels_per_call(lambda: dense.dense_step(params, lo, xp[0], yt[0], comps[0],
                                                        ti, tj))
    if (n_flow, n_step) != (n_flow1, n_step1):
        raise SystemExit(f"dense lane calls launch {n_flow} / {n_step} device kernels, one "
                         f"unbatched call {n_flow1} / {n_step1}")
    log(f"lanes  dense_flow_lanes / dense_step_lanes {what}: within phase 2b's tolerances of "
        f"the plain versions lane by lane, every lane and B = 1 bit-equal to the unbatched "
        f"call, reruns bit-equal, a frozen lane zeros; active pairs per lane "
        f"{comp.n.tolist()}, nonzeros per lane {fk[2].tolist()}; {n_flow} / {n_step} device "
        f"kernels a call, as one unbatched call")
    fbytes = fops = sbytes = sops = 0
    for b in range(LANES):
        n_b = int(comp.n[b])
        comp_bytes = 4 * (3 * comps[b].pair_i.numel() + 1) + comps[b].row_has.numel()
        in_bytes = 4 * xp[b].numel() + comp_bytes
        gated = dense.geometric_gate_count(lo, xp[b], yp[b], comps[b], ti, tj)
        fbytes += in_bytes + 4 * yp[b].numel() + 4 * 5 * N_POINTS + 8
        sbytes += in_bytes + 4 * yt[b].numel() + 16
        fops += dense_ops(lo, n_b * ti * tj, gated, False)
        sops += dense_ops(lo, n_b * ti * tj, gated, True)
    for name, kfn, seqfn, pfn, (b_ms, b_by), err, n_dev, replaces in (
            ("dense_flow_lanes", flow, lambda: [
                dense.dense_flow(params, lo, xp[b], yp[b], comps[b], ti, tj)
                for b in range(LANES)],
             lambda: dense.dense_flow_lanes_plain(params, lo, xp, yp, comp, ti, tj),
             bound(fbytes, fops), f_err, n_flow,
             "unified_cvo_tpu/ops/pallas_kernels.py:398 (_flow_kernel via _compacted_call "
             ":490, under jax.vmap of align: parallel/batch_align.py:51-55)"),
            ("dense_step_lanes", step, lambda: [
                dense.dense_step(params, lo, xp[b], yt[b], comps[b], ti, tj)
                for b in range(LANES)],
             lambda: dense.dense_step_lanes_plain(params, lo, xp, yt, comp, ti, tj),
             bound(sbytes, sops), s_err, n_step,
             "unified_cvo_tpu/ops/pallas_kernels.py:429 (_step_kernel / _step_tile :445, "
             "under jax.vmap of align: parallel/batch_align.py:51-55)")):
        results[name] = lane_row(name, replaces, kfn, seqfn, pfn, b_ms, b_by, err, floor, n_dev,
                                 "unified_cvo_tpu_torch/csrc/dense.cu")


def batch_path(frames_np, feats, guess_np, dev, smi, results):
    """17b: make_batch_align on LANES pairs of the bench scene (frames b ->
    b + 1, 16384 points, the bench guess) against align on each pair, in
    three batches: KITTI_GEOMETRIC_BENCH and KITTI_COLOR_BENCH (5 features)
    on the default backend ('ell', grid builder; BATCH_ITER iterations), and
    KITTI_COLOR_BENCH on 'pallas' (DENSE_BATCH_ITER). Each is held by
    batch_run; the lane kernels' rows get their launches."""
    from unified_cvo_tpu_torch.config import KITTI_COLOR_BENCH, KITTI_GEOMETRIC_BENCH

    out = {}
    for label, params, ft, backend, max_iter in (
            ("geometric ELL", KITTI_GEOMETRIC_BENCH, None, "auto", BATCH_ITER),
            ("colour ELL", KITTI_COLOR_BENCH, feats, "auto", BATCH_ITER),
            ("dense", KITTI_COLOR_BENCH, feats, "pallas", DENSE_BATCH_ITER)):
        preset = "KITTI_COLOR_BENCH" if ft is not None else "KITTI_GEOMETRIC_BENCH"
        out[label] = batch_run(f"{label} ({preset})", params, frames_np, ft, guess_np, dev,
                               smi, backend, max_iter)
    for name in ("flow_reduce_lanes", "step_cached_lanes", "select_lanes"):
        results[name]["launches"] = out["geometric ELL"]["launches"][name]
        results[name]["launches_colour_batch"] = out["colour ELL"]["launches"][name]
    for name in ("dense_flow_lanes", "dense_step_lanes"):
        results[name]["launches"] = out["dense"]["launches"][name]
    return out


def batch_run(label, params, frames_np, feats, guess_np, dev, smi, backend, max_iter):
    """One 17b batch: every lane with its sequential run's iterations and
    builds and its transform within BATCH_POSE_TOL (bit-equality reported);
    one host read a batched iteration; on 'ell' flow_reduce_lanes and
    step_cached_lanes launched once a batched iteration, select_lanes once
    a batched build step (build_neighbor_list_lanes calls, counted here;
    their lanes sum to the builds), the single-pair select, flow_reduce and
    step_cached never; on 'pallas' dense_flow_lanes and dense_step_lanes
    once a batched iteration, dense_flow and dense_step never. pairs/s of
    both, and the card's device kernels a batched iteration and idle share
    under torch.profiler. Any failed check ends the run (SystemExit)."""
    from torch.profiler import ProfilerActivity, profile

    from unified_cvo_tpu_torch.models.align import align
    from unified_cvo_tpu_torch.ops import neighbors as nbr
    from unified_cvo_tpu_torch.parallel.batch_align import make_batch_align, stack_pairs
    from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud

    frames = [make_pointcloud(f, features=feats, bucket=N_POINTS, device=dev)
              for f in frames_np[:LANES + 1]]
    guess = torch.from_numpy(guess_np).to(dev)
    src_b, tgt_b = stack_pairs(frames[:LANES], frames[1:])
    init_b = guess.expand(LANES, 4, 4).contiguous()
    kw = dict(backend=backend, device=dev)
    batch = make_batch_align(params, max_iter=max_iter, **kw)
    make_batch_align(params, max_iter=10, **kw)(src_b, tgt_b, init_b)     # warm-up
    align(frames[0], frames[1], guess, params, max_iter=10, **kw)
    torch.cuda.synchronize()

    seq = []
    t0 = time.perf_counter()
    for b in range(LANES):
        seq.append(align(frames[b], frames[b + 1], guess, params, max_iter=max_iter, **kw))
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    steps = []                               # lanes of each batched build step
    real_build = nbr.build_neighbor_list_lanes

    def counted_build(*a, **k):
        lists = real_build(*a, **k)
        steps.append(len(lists))
        return lists

    nbr.build_neighbor_list_lanes = counted_build
    reset_launch_counts()
    try:
        t0 = time.perf_counter()
        Tb, rets, iters = batch(src_b, tgt_b, init_b)
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
    finally:
        nbr.build_neighbor_list_lanes = real_build
    launches = launch_counts()
    info = batch.last_info
    gaps = [float(torch.max(torch.abs(Tb[b] - seq[b][0]))) for b in range(LANES)]
    bit_equal = [bool(torch.equal(Tb[b], seq[b][0])) for b in range(LANES)]
    s_iters = [s[2].iterations for s in seq]
    s_builds = [s[2].nl_rebuilds for s in seq]
    builds = info.nl_rebuilds or [None] * LANES
    what = f"{label} batch ({LANES} pairs, {info.backend}"
    what += f" + {info.nl_builder} builder" if info.nl_builder else ""
    what += f", {max_iter}-iteration cap)"
    log(f"batch path, {what}: {batch_s:.3f} s, {LANES / batch_s:.3f} pairs/s; the pairs one "
        f"by one (align): {seq_s:.3f} s, {LANES / seq_s:.3f} pairs/s ({smi})")
    log(f"  iterations batch {info.iterations} sequential {s_iters}; builds batch "
        f"{info.nl_rebuilds} sequential {s_builds}; batched build steps {len(steps)} (lanes "
        f"{steps}); host reads batch {info.host_reads} ({info.host_reads / max(info.iterations):.3f} "
        f"a batched iteration), sequential {[s[2].host_reads for s in seq]}; transform gap per "
        f"lane {gaps}, bit-equal {bit_equal}")
    log(f"  launches {launches}")
    if not (info.iterations == s_iters and list(builds) == s_builds
            and max(gaps) <= BATCH_POSE_TOL and rets.tolist() == [int(s[1]) for s in seq]
            and iters.tolist() == s_iters and bool(torch.all(torch.isfinite(Tb)))):
        raise SystemExit(f"{label} batch: lanes do not match their sequential runs: iterations "
                         f"{info.iterations} vs {s_iters}, builds {info.nl_rebuilds} vs "
                         f"{s_builds}, gaps {gaps}")
    n_it = max(info.iterations)
    single = ("select", "flow_reduce", "step_cached", "dense_flow", "dense_step")
    if info.backend == "ell":
        ok = (info.nl_builder == "grid"
              and launches["flow_reduce_lanes"] == launches["step_cached_lanes"] == n_it
              and launches["select_lanes"] == len(steps) and sum(steps) == sum(builds)
              and launches["dense_flow_lanes"] == launches["dense_step_lanes"] == 0)
    else:
        ok = (info.backend == "pallas"
              and launches["dense_flow_lanes"] == launches["dense_step_lanes"] == n_it
              and launches["flow_reduce_lanes"] == launches["select_lanes"] == 0)
    if not (ok and info.host_reads == n_it and not any(launches[k] for k in single)):
        raise SystemExit(f"{label} batch: launches {launches}, host reads {info.host_reads}, "
                         f"{n_it} batched iterations, build steps {steps}, builds {builds}")

    short = make_batch_align(params, max_iter=BATCH_PROFILE_ITER, **kw)
    short(src_b, tgt_b, init_b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        short(src_b, tgt_b, init_b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    n = max(short.last_info.iterations)
    idle = None if not events else 1 - busy_us / wall_us
    if events:
        log(f"  profile ({n} batched iterations, profiler on): wall {wall_us / n:.1f} us a "
            f"batched iteration, {len(events) / n:.1f} device kernels+copies, busy "
            f"{busy_us / n:.1f} us, device idle share {idle:.4f}")
    else:
        log("  profile: the profiler recorded no device activity (idle share not measured)")
    return {"pairs": LANES, "max_iter": max_iter, "backend": info.backend,
            "nl_builder": info.nl_builder, "batch_s": batch_s, "sequential_s": seq_s,
            "pairs_per_s": LANES / batch_s, "sequential_pairs_per_s": LANES / seq_s,
            "iterations": info.iterations, "builds": info.nl_rebuilds, "build_steps": steps,
            "host_reads": info.host_reads, "transform_gaps": gaps, "bit_equal": bit_equal,
            "launches": launches, "idle_share": idle,
            "profile_us_per_iteration": None if not events else wall_us / n,
            "profile_events_per_iteration": len(events) / n}


def shard_pair(points, dev):
    """17c's pair: bench frames 0 -> 1 at `points` points, the bench guess."""
    from unified_cvo_tpu_torch.apps import f2f_sequence as f2f
    from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud

    frames, _ = f2f.make_sequence(points, 1)
    src, tgt = (make_pointcloud(f, bucket=points, device=dev) for f in frames)
    return src, tgt, torch.from_numpy(f2f.initial_guess()).to(dev)


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def shard_rank(rank, world, store, out_dir, dev_name, points, iters):
    """17c, one rank: the sp and ring loops (a `points`-point pair, `iters`
    iterations) and the sharded IRLS solver on device `dev_name`, in a gloo
    group of `world` ranks (file:// store). Writes its results to
    out_dir/rank<r>.pt."""
    import os

    import torch.distributed as dist

    from unified_cvo_tpu_torch.config import KITTI_GEOMETRIC_BENCH, CvoParams
    from unified_cvo_tpu_torch.models import irls
    from unified_cvo_tpu_torch.parallel import ring, sharded, sharded_irls
    from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud

    dev = torch.device(dev_name)
    torch.set_num_threads(1)        # the ranks share the host's cores
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        src, tgt, guess = shard_pair(points, dev)
        res, sec = {}, {}
        W = dist.group.WORLD
        for name, fn in (
                ("sp", sharded.make_sharded_full_align(KITTI_GEOMETRIC_BENCH, W, chunk=512,
                                                       max_iter=iters, device=dev)),
                ("ring", ring.make_ring_full_align(KITTI_GEOMETRIC_BENCH, W, chunk=512,
                                                   max_iter=iters, device=dev))):
            t0 = time.perf_counter()
            T, ret, info = fn(src, tgt, guess)
            sync(dev)
            sec[name] = time.perf_counter() - t0
            res[name] = (T.cpu(), int(info["iterations"]), float(info["final_ell"]))
        frames, edges, pivots, fields = irls_case()
        stacked = irls.stack_clouds([make_pointcloud(f, bucket=256, device=dev) for f in frames])
        solver = sharded_irls.make_sharded_irls_solver(CvoParams(**fields), W, chunk=256,
                                                       frame_sharded=True, device=dev)
        ei, ej, valid = sharded_irls.pad_edges(np.array([e[0] for e in edges], np.int32),
                                               np.array([e[1] for e in edges], np.int32), world)
        t0 = time.perf_counter()
        poses, info = solver(sharded_irls.pad_frames(stacked, world),
                             np.tile(np.eye(3, 4, dtype=np.float32), (len(frames), 1, 1)),
                             ei, ej, valid, np.asarray(pivots, np.float32))
        sync(dev)
        sec["irls"] = time.perf_counter() - t0
        res["irls"] = (poses.cpu(), int(info["it"]), float(info["ell"]))
        res["seconds"] = sec
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def shard_phase(dev, smi):
    """17c: sp, ring and the sharded IRLS solver on SHARD_RANKS gloo ranks
    sharing the one card (NCCL refuses two ranks on one GPU; NCCL across
    cards is untested), each held to the same call in this process on the
    card: iterations and final ell equal (rtol 1e-6), transforms within 5e-3
    (sp) and 1e-3 / 2e-2 rotation / translation (ring), IRLS it equal, ell
    rtol 1e-6, poses atol 5e-4; every rank's results bit-equal."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    from unified_cvo_tpu_torch.config import KITTI_GEOMETRIC_BENCH, CvoParams
    from unified_cvo_tpu_torch.models import irls
    from unified_cvo_tpu_torch.models.align import align
    from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud

    src, tgt, guess = shard_pair(SHARD_POINTS, dev)
    t0 = time.perf_counter()
    T1, _, info1 = align(src, tgt, guess, KITTI_GEOMETRIC_BENCH, device=dev, backend="jnp",
                         max_iter=SHARD_ITER, chunk=512)
    sync(dev)
    one_s = time.perf_counter() - t0
    frames, edges, pivots, fields = irls_case()
    stacked = irls.stack_clouds([make_pointcloud(f, bucket=256, device=dev) for f in frames])
    t0 = time.perf_counter()
    ref_poses, hist = irls.irls_solve(stacked, np.tile(np.eye(3, 4, dtype=np.float32),
                                                       (len(frames), 1, 1)),
                                      edges, pivots, CvoParams(**fields), chunk=256,
                                      engine="device", backend="dense", device=dev)
    irls_one_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shards_") as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(shard_rank, args=(SHARD_RANKS, os.path.join(tmp, "store"), tmp,
                                                   str(dev), SHARD_POINTS, SHARD_ITER),
                                 nprocs=SHARD_RANKS, join=False, start_method="spawn")
        deadline = time.monotonic() + SHARD_TIMEOUT
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise SystemExit(f"phase 17c: the ranks were not done after {SHARD_TIMEOUT} s")
        ranks_s = time.perf_counter() - t0
        got = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(SHARD_RANKS)]
    for r in range(1, SHARD_RANKS):
        for key in ("sp", "ring", "irls"):
            if not (torch.equal(got[r][key][0], got[0][key][0]) and got[r][key][1:] == got[0][key][1:]):
                raise SystemExit(f"phase 17c: rank {r}'s {key} result differs from rank 0's")
    T1c, out = T1.cpu(), {}
    for key, (rot_tol, tr_tol) in (("sp", (5e-3, 5e-3)), ("ring", (1e-3, 2e-2))):
        T, it, fell = got[0][key]
        rot, tr = (float(torch.max(torch.abs(T[:3, :3] - T1c[:3, :3]))),
                   float(torch.max(torch.abs(T[:3, 3] - T1c[:3, 3]))))
        ok = (it == info1.iterations and abs(fell - float(info1.final_ell))
              <= 1e-6 * abs(float(info1.final_ell)) and rot <= rot_tol and tr <= tr_tol)
        log(f"{key} align on {SHARD_RANKS} gloo ranks ({SHARD_POINTS} bench points, "
            f"KITTI_GEOMETRIC_BENCH, backend jnp, {SHARD_ITER} iterations): "
            f"{got[0]['seconds'][key]:.2f} s (one process {one_s:.2f} s), iterations {it} / "
            f"{info1.iterations}, final ell {fell} / {float(info1.final_ell)}, rotation gap "
            f"{rot:.3g}, translation gap {tr:.3g} ({smi})")
        if not ok:
            raise SystemExit(f"phase 17c: {key} does not match the one-process align")
        out[key] = {"seconds": got[0]["seconds"][key], "one_process_s": one_s,
                    "iterations": it, "rotation_gap": rot, "translation_gap": tr}
    poses, it, ell = got[0]["irls"]
    gap = float(np.max(np.abs(poses.numpy() - ref_poses)))
    log(f"sharded IRLS on {SHARD_RANKS} gloo ranks (frame-sharded, 5 frames, 10 edges): "
        f"{got[0]['seconds']['irls']:.2f} s (irls_solve on one process {irls_one_s:.2f} s), "
        f"it {it} / {hist[0]['iter']}, ell {ell} / {hist[0]['ell']}, pose gap {gap:.3g}")
    if not (it == hist[0]["iter"] and abs(ell - hist[0]["ell"]) <= 1e-6 * abs(hist[0]["ell"])
            and gap <= 5e-4):
        raise SystemExit("phase 17c: the sharded IRLS solve does not match irls_solve")
    out["irls"] = {"seconds": got[0]["seconds"]["irls"], "one_process_s": irls_one_s,
                   "it": it, "pose_gap": gap, "ranks_s": ranks_s}
    log(f"phase 17c: {SHARD_RANKS} gloo ranks on one card, {ranks_s:.2f} s with their start; "
        f"NCCL across cards is untested (no call here has more than one card)")
    return out


def parallel_phase(frames_np, feats, guess_np, dev, smi, results, floor):
    """Phase 17: 17a the lane-axis kernels (ELL consume pair, select, dense
    pair), 17b batched registration on the card (geometric ELL, colour ELL
    and dense batches), 17c the sharded paths on gloo ranks sharing the
    card."""
    parts, out = {}, {}
    t0 = time.perf_counter()
    lane_kernel_checks(frames_np, feats, guess_np, dev, results, floor)
    lane_select_checks(frames_np, guess_np, dev, results, floor)
    lane_dense_checks(frames_np, feats, guess_np, dev, results, floor)
    parts["17a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["batch"] = batch_path(frames_np, feats, guess_np, dev, smi, results)
    parts["17b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["shards"] = shard_phase(dev, smi)
    parts["17c"] = time.perf_counter() - t0
    out["seconds"] = parts
    log("phase 17 parts: " + ", ".join(f"{k} {v:.2f} s" for k, v in parts.items()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=MAIN_FRAMES,
                    help="timed frame pairs of the main path (after one warm-up pair)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--dense-ablation", action="store_true",
                      help="build, check and time the dense kernels and their measurement "
                           "builds (phases 1 and 2b only), then stop without a result line")
    mode.add_argument("--kernel-times", metavar="TREE",
                      help="check and time select (rows 1, 1b, 1c) and flow_rows of the "
                           "package in TREE, then phase 8's and 14d's IRLS ms per outer "
                           "iteration (after phase 1), print one JSON line, stop")
    mode.add_argument("--compare-tree", metavar="DIR", nargs="+",
                      help="--kernel-times of each DIR and of this tree in turns (DIRs, "
                           "this, this, DIRs reversed), each in a process of its own, then "
                           "stop")
    mode.add_argument("--slam-only", action="store_true",
                      help="build, then run phases 11-12 alone (the host RGB-D frontend and "
                           "the SLAM back end), print their JSON line, stop without a "
                           "result line")
    mode.add_argument("--lidar-only", action="store_true",
                      help="build, then run phase 13 alone (the lidar frontend, the lidar "
                           "drivers and the PCD demo), print its JSON lines, stop without a "
                           "result line")
    mode.add_argument("--ba-only", action="store_true",
                      help="build, then run phase 14 alone (PNG input, the exact NL-means, "
                           "tartan_odometry and the bundle-adjustment apps), print its JSON "
                           "line, stop without a result line")
    mode.add_argument("--stereo-only", action="store_true",
                      help="build, then run phase 15 alone (the KITTI stereo host frontend: "
                           "the native census-SGM against the C++ library, Canny, the driver "
                           "at its defaults and the stereo apps), print its JSON lines, stop "
                           "without a result line")
    mode.add_argument("--orb-only", action="store_true",
                      help="build, then run phase 16 alone (cv2's ORB exact, CANNY_EDGES "
                           "on the card, GICP, evaluate_semantics, the prefetch loader), "
                           "print its JSON line, stop without a result line")
    mode.add_argument("--parallel-only", action="store_true",
                      help="build, then run phase 17 alone (the lane-axis ELL kernels, "
                           "batched registration and the sp, ring and sharded-IRLS paths on "
                           "gloo ranks), print its JSON lines, stop without a result line")
    mode.add_argument("--assembly-compare", metavar="DIR",
                      help="--assembly-times of DIR and of this tree in turns (DIR, this, "
                           "this, DIR), each in a process of its own, then stop")
    mode.add_argument("--assembly-times", metavar="TREE",
                      help="phase 12d's CG loop three times and phase 8's IRLS solve twice "
                           "with the package in TREE: ms and run-to-run gaps, one JSON line")
    mode.add_argument("--posegraph-ablation", action="store_true",
                      help="phase 12d's incremental run, card against CPU, with each "
                           "subgraph solved in its own frame and in the world frame; no "
                           "build, no result line")
    mode.add_argument("--ell-ablation", action="store_true",
                      help="build, check and time the ELL consume kernels and their "
                           "measurement builds (after phase 1), then stop without a "
                           "result line")
    ap.add_argument("--cc-inputs", metavar="FILE",
                    help="with --kernel-times: also check and time L1 and components8 on "
                         "the inputs saved there (cc_inputs)")
    ap.add_argument("--no-irls", action="store_true",
                    help="with --kernel-times or --compare-tree: time the kernels alone, "
                         "not phase 8's and 14d's IRLS")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.compare_tree:
        compare_trees(args.compare_tree, args.frames, irls=not args.no_irls)
        return 0
    if args.posegraph_ablation:
        posegraph_ablation()
        return 0
    if args.assembly_compare:
        compare_assembly(args.assembly_compare)
        return 0
    if args.assembly_times:
        assembly_times(args.assembly_times)
        return 0
    if args.kernel_times:                    # this package: the one found first on the path
        sys.path.insert(0, args.kernel_times)
    if args.frames < MAIN_FRAMES:
        print(f"chip_smoke: the main path needs at least {MAIN_FRAMES} timed frames (phase 6 "
              f"runs pairs up to frame {MAIN_FRAMES})", file=sys.stderr)
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
    t0 = t_start = time.perf_counter()
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
        kernel_times(frames_np, feats, guess_np, dev, floor, irls=not args.no_irls,
                     cc=args.cc_inputs)
        return 0
    if args.ell_ablation:
        ell_ablation(frames_np, feats, guess_np, dev, floor)
        pose_error_witness(frames_np, T_true, guess_np, dev)
        return 0
    if args.slam_only:
        results = {n: {"max_abs_err": 0.0} for n in ("select", "flow_reduce", "step_cached")}
        t0 = time.perf_counter()
        paths = {"tum_host": tum_host_phase(dev, smi, results)}
        log(f"phase 11: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        paths["slam"] = slam_phase(dev, smi, results)
        log(f"phase 12: {time.perf_counter() - t0:.2f} s")
        log(json.dumps({"paths": paths, "kernel_checks": results}, default=str))
        return 0
    if args.lidar_only:
        results = {n: {"max_abs_err": 0.0} for n in ("select", "flow_reduce", "step_cached")}
        t0 = time.perf_counter()
        paths = {"lidar": lidar_phase(dev, smi, results)}
        log(f"phase 13: {time.perf_counter() - t0:.2f} s")
        log(json.dumps({"paths": paths, "kernel_checks": results}, default=str))
        return 0
    if args.ba_only:
        results = {n: {"max_abs_err": 0.0} for n in ("select", "flow_reduce", "step_cached",
                                                     "select (K=128, P=32)")}
        t0 = time.perf_counter()
        paths = {"ba": ba_phase(dev, smi, results)}
        log(f"phase 14: {time.perf_counter() - t0:.2f} s")
        log(json.dumps({"paths": paths, "kernel_checks": results}, default=str))
        return 0
    if args.stereo_only:
        results = {n: {"max_abs_err": 0.0} for n in ("select", "flow_reduce", "step_cached")}
        t0 = time.perf_counter()
        paths = {"stereo_host": stereo_host_phase(dev, smi, results)}
        log(f"phase 15: {time.perf_counter() - t0:.2f} s")
        log(json.dumps({"paths": paths}, default=str))
        log(json.dumps({"kernel_checks": results}, default=str))
        return 0
    if args.orb_only:
        results = {n: {"max_abs_err": 0.0} for n in ("select", "flow_reduce", "step_cached")}
        t0 = time.perf_counter()
        paths = {"orb": orb_phase(dev, smi, results)}
        log(f"phase 16: {time.perf_counter() - t0:.2f} s")
        log(json.dumps({"paths": paths, "kernel_checks": results}, default=str))
        return 0
    if args.parallel_only:
        t0 = time.perf_counter()
        paths = {"parallel": parallel_phase(frames_np, feats, guess_np, dev, smi, results,
                                            floor)}
        log(f"phase 17: {time.perf_counter() - t0:.2f} s")
        log(json.dumps({"paths": paths}, default=str))
        log(json.dumps({"kernels": list(results.values())}, default=str))
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
    f2f.run_sequence(frames[:2], guess, params, device=dev, max_iter=WARM_ITER)
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
    main_ms = 1e3 * seconds / n
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
                     backend="pallas", max_iter=WARM_ITER)
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
    f2f.run_sequence(cframes[:2], guess, KITTI_COLOR_BENCH, device=dev, max_iter=WARM_ITER)
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

    # ---- phases 11-12: the host RGB-D frontend and the SLAM back end
    t0 = time.perf_counter()
    results["tum_host"] = tum_host_phase(dev, smi, results)
    log(f"phase 11 (host RGB-D frontend and driver, CPU checks included): "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    results["slam"] = slam_phase(dev, smi, results)
    log(f"phase 12 (SLAM back end, CPU checks included): {time.perf_counter() - t0:.2f} s")

    # ---- phase 13: the lidar frontend, the lidar drivers and the PCD demo
    t0 = time.perf_counter()
    results["lidar"] = lidar_phase(dev, smi, results)
    log(f"phase 13 (lidar frontend, drivers and PCD demo, CPU checks included): "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- phase 14: PNG input, the exact NL-means, tartan_odometry, the BA apps
    t0 = time.perf_counter()
    results["ba"] = ba_phase(dev, smi, results)
    log(f"phase 14 (PNG input, exact NL-means, TartanAir driver and BA apps, CPU checks "
        f"included): {time.perf_counter() - t0:.2f} s")

    # ---- phase 15: the KITTI stereo host frontend, its driver and the stereo apps
    t0 = time.perf_counter()
    results["stereo_host"] = stereo_host_phase(dev, smi, results)
    log(f"phase 15 (KITTI stereo host frontend, driver and stereo apps, CPU and C++ checks "
        f"included): {time.perf_counter() - t0:.2f} s")

    # ---- phase 16: cv2's ORB exact, CANNY_EDGES on the card, the remaining tools
    t0 = time.perf_counter()
    results["orb"] = orb_phase(dev, smi, results)
    log(f"phase 16 (ORB, CANNY_EDGES pair and tools, CPU checks included): "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- phase 17: the lane-axis kernels, batched registration, the sharded paths
    t0 = time.perf_counter()
    results["parallel"] = parallel_phase(frames_np, feats, guess_np, dev, smi, results, floor)
    log(f"phase 17 (lane-axis kernels, batched registration, sp / ring / sharded IRLS on gloo "
        f"ranks): {time.perf_counter() - t0:.2f} s")

    # ---- phase 5: where an iteration's time goes (profiler, not counted)
    profile_main_path(f2f, frames, guess, params, dev, label=" ELL path")
    profile_main_path(f2f, cframes, guess, KITTI_COLOR_BENCH, dev, iters=100,
                      label=" dense path", backend="pallas")
    profile_main_path(f2f, cframes, guess, KITTI_COLOR_BENCH, dev, iters=100,
                      label=" colour ELL path")
    log(f"chip_smoke: every phase from the build on in {time.perf_counter() - t_start:.1f} s "
        f"(host clock; the main path {main_ms:.2f} ms a frame on this host)")
    paths = {name: results.pop(name) for name in ("acvo", "irls", "kitti_stereo", "tum_rgbd",
                                                   "tum_host", "slam", "lidar", "ba",
                                                   "stereo_host", "orb", "parallel")}
    log(json.dumps({"paths": paths}, default=str))
    log(json.dumps({"kernels": list(results.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
