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
                   the channel-only flow_reduce, phase 3d.

Phase 2c also holds flow_rows and step_uncached (the entry points of
pallas_ell.flow_stats_ell_fused and step_coeffs_ell_fused, which no align
path calls, as in JAX) against their plain versions in every variant.

Phase 2b launches each dense kernel twice for bit-equal outputs and checks
it on three compactions (culled, one source tile emptied, every pair
active). `--dense-ablation` stops after phases 1 and 2b and also times
measurement builds of csrc/dense.cu (no first look at the geometric gate,
no queue of survivors, no overlap of staging, nothing fused); it prints no result line.

Phases 2 and 2c launch flow_reduce (every variant) and step_cached twice
for bit-equal outputs, hold them against their plain versions at a point
count that fills no block evenly, hold the step fed the flow's twist on
the device against its plain version and against the host-built scalar
block, count the device kernels of one call as the nodes of a captured
CUDA graph, and check that the one-launch finish left its ticket counters
at 0; every time is printed beside the launch floor (back-to-back empty
kernels).
`--ell-ablation` stops after phase 1: it checks, counts and times
measurement builds of csrc/ell.cu (the two-launch finish, the runtime-K
slot loop, two block reductions), then runs the geometric ELL path three
times with the step's twist part built three ways (in the kernel, on the
host by twist_scalars, on the host in matrix form) to show which one moves
the pose errors; it prints no result line.

Usage: python3 chip_smoke.py [--frames 8] [--dense-ablation | --ell-ablation]
Exits non-zero, printing no result, without a CUDA device or when any
phase fails. The last line of stdout is the result object.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

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


def sorted_rows(idx, y_xyz):
    """Per-source-row slots ordered by target index: compares row SETS."""
    order = torch.argsort(idx, dim=0)
    return torch.gather(idx, 0, order), torch.gather(
        y_xyz, 1, order[None].expand_as(y_xyz))


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
    K, P, dims = nbr.DEFAULT_K, nbr.PER_CELL_CAP, nbr.GRID_DIMS
    ell = torch.full((), params.ell_init, dtype=torch.float32, device=dev)
    eye = torch.eye(4, device=dev)
    for name, guess in (("identity", eye), ("bench guess", torch.from_numpy(guess_np).to(dev))):
        Rinv, Tinv = lie.invert_rt(guess[:3, :3], guess[:3, 3])
        g = nbr.grid_inputs(params, ell, src, tgt, Rinv, Tinv)
        args = (g.tab, g.cbase, g.xr2, g.pose, K, P, dims)
        idx_k, y_k, kept_k = sel.select(*args)
        idx_p, y_p, kept_p = sel.select_plain(*args)
        torch.cuda.synchronize()
        ik, yk = sorted_rows(idx_k, y_k)
        ip, yp = sorted_rows(idx_p, y_p)
        ovf_k = int(kept_k.sum() - (idx_k >= 0).sum())
        ovf_p = int(kept_p.sum() - (idx_p >= 0).sum())
        sel_err = float(torch.max(torch.abs(yk - yp)))
        if not (torch.equal(ik, ip) and torch.equal(kept_k, kept_p)
                and ovf_k == ovf_p and sel_err == 0.0):
            raise SystemExit(f"select kernel disagrees with its plain version at {name}: "
                             f"sets equal={torch.equal(ik, ip)} kept equal="
                             f"{torch.equal(kept_k, kept_p)} overflow {ovf_k} vs {ovf_p}, "
                             f"max |dy| {sel_err}")
        log(f"select @ {name}: per-row sets equal, same slot order="
            f"{torch.equal(idx_k, idx_p)}, kept {int(kept_k.sum())}, "
            f"valid {int((idx_k >= 0).sum())}, overflow (K cap) {ovf_k}")

        y_xyz = y_k
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
            per_call = ""
            if kname != "select":
                n_dev = kernels_per_call(kfn)
                if n_dev != 1:
                    raise SystemExit(f"{kname}: one call launched {n_dev} device kernels, "
                                     f"not 1")
                results[kname].update(launches_per_call=n_dev, launch_floor_ms=floor)
                per_call = f", {n_dev} device kernel a call (graph nodes)"
            log(f"time   {kname}: kernel {ms:.4f} ms (launch floor {floor:.4f} ms), plain "
                f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}){per_call}")
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
    ("two launches per pass (-DELL_ONE_LAUNCH=0)", ("-DELL_ONE_LAUNCH=0",)),
    ("runtime-K slot loop (-DELL_UNROLL=0)", ("-DELL_UNROLL=0",)),
    ("two block reductions in the flow (-DELL_FUSED_SUM=0)", ("-DELL_FUSED_SUM=0",)),
)


def register_counts(report):
    """{kernel entry (mangled name): registers a thread} from a ptxas -v
    report."""
    out, entry = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line and entry is not None:
            out[entry] = int(line.split("Used")[1].split()[0])
            entry = None
    return out


def ell_ablation(frames_np, feats, guess_np, dev, floor, package_report):
    """--ell-ablation: the package's build of csrc/ell.cu and each
    measurement build in turn, each checked on the geometric and the colour
    bench list (ell_consume_checks, and flow_reduce against its plain
    version at full N), its device kernels a call counted (2 in a
    two-launch build, else 1), then timed: flow_reduce (geometry, geometry
    x chan) and step_cached in the loop's form (the flow's twist) at the
    bench shapes."""
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
        reports = list(pool.map(lambda v: cuda_lib.build_all(["ell"], v[1]).get("ell", ""),
                                ELL_VARIANTS))
    libs = [cuda_lib.load_variant("ell", flags) for _, flags in ELL_VARIANTS]
    builds = [("package build", (), None, package_report)] + [
        (label, flags, lib, rep) for (label, flags), lib, rep in zip(ELL_VARIANTS, libs, reports)]
    for label, flags, lib, report in builds + builds[:1]:
        ell_ops.use_build(lib)
        design = ell_ops.library_design()
        for flag in flags:
            key, value = flag[2:].split("=")
            if design[key] != int(value):
                raise SystemExit(f"ablation {label}: the build reports {design}")
        expect = 2 - design["ELL_ONE_LAUNCH"]
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
        if any(c != expect for c in per_call.values()):
            raise SystemExit(f"ablation {label}: device kernels a call {per_call}, "
                             f"expected {expect}")
        regs = register_counts(report)
        reg_txt = ", ".join(
            f"{kind} <= {max(r for k, r in regs.items() if kind in k)} registers"
            for kind in ("flow_reduce_kernel", "step_kernel") if any(kind in k for k in regs))
        log(f"ablation {label}: " + ", ".join(f"{k} {t:.4f} ms" for k, t in times)
            + f" (launch floor {floor:.4f} ms); {expect} device kernel(s) a call (graph nodes); "
            f"checks passed; {reg_txt or 'registers: built before this run'}; design {design}")
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
    import numpy as np

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
    import numpy as np

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
        rp = ell_ops.flow_rows_plain(xp, nl.y_xyz, scal, **ch)
        torch.cuda.synchronize()
        # rows at s rtol 1e-5 atol 1e-7 and wy rtol 1e-5 atol 1e-6; without
        # geometry every live slot carries an O(0.1) A, so wy sums 32 terms
        # of |A y| up to ~20 and takes the JAX test's own wy tolerance
        # (rtol 1e-4 atol 1e-5, test_neighbors.py:293)
        wy_tol = dict(rtol=1e-5, atol=1e-6) if use_geo else dict(rtol=1e-4, atol=1e-5)
        s_ok = torch.allclose(rk[0], rp[0], rtol=1e-5, atol=1e-7)
        wy_ok = torch.allclose(rk[1], rp[1], **wy_tol)
        r_rel = abs(float(rk[4]) - float(rp[4])) / abs(float(rp[4]))
        if not (s_ok and wy_ok and torch.equal(rk[2], rp[2]) and int(rk[3]) == int(rp[3])
                == nz_p and r_rel <= 1e-5):
            raise SystemExit(f"flow_rows ({v}) disagrees on the {label} list: s ok {s_ok}, "
                             f"wy ok {wy_ok} (max abs "
                             f"{float(torch.max(torch.abs(rk[1] - rp[1])))}), cnt equal {torch.equal(rk[2], rp[2])}, "
                             f"nonzeros {int(rk[3])} vs {int(rp[3])}, a_sum rel {r_rel}")
        errs["flow_rows"] = max(errs["flow_rows"], float(torch.max(torch.abs(rk[0] - rp[0]))),
                                float(torch.max(torch.abs(rk[1] - rp[1]))))

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
            f"within tolerance, a_sum rel {r_rel:.3g}; step_uncached B..E {bk.tolist()} "
            f"(plain {bp.tolist()}, equal to step_cached on the kernel's A); reruns "
            f"bit-equal, device-twist step within rtol 1e-4, N = "
            f"{' and '.join(map(str, N_ODD))} within tolerance")
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
            "launched_by": "phase 2c checks (no align path calls it, as in JAX)"}


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=8,
                    help="timed frame pairs of the main path (after one warm-up pair)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--dense-ablation", action="store_true",
                      help="build, check and time the dense kernels and their measurement "
                           "builds (phases 1 and 2b only), then stop without a result line")
    mode.add_argument("--ell-ablation", action="store_true",
                      help="build, check and time the ELL consume kernels and their "
                           "measurement builds (after phase 1), then stop without a "
                           "result line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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
            elif name in ("dense", "ell") and "Compiling entry function" in line:
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
    if args.ell_ablation:
        ell_ablation(frames_np, feats, guess_np, dev, floor, reports.get("ell", ""))
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

    # ---- phase 5: where an iteration's time goes (profiler, not counted)
    profile_main_path(f2f, frames, guess, params, dev, label=" ELL path")
    profile_main_path(f2f, cframes, guess, KITTI_COLOR_BENCH, dev, iters=100,
                      label=" dense path", backend="pallas")
    profile_main_path(f2f, cframes, guess, KITTI_COLOR_BENCH, dev, iters=100,
                      label=" colour ELL path")
    log(json.dumps({"kernels": list(results.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
