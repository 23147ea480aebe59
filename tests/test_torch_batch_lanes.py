"""The lane axis of select and of the dense passes (ops/select.py::
select_lanes, ops/dense.py::dense_flow_lanes / dense_step_lanes, the
counterparts of the Pallas kernels under JAX's jax.vmap of align) and the
batched paths that run them, on the CPU:

* the plain versions with a lane axis give every lane the unbatched plain
  version's bits, at B = 1 and B = 3: select on a masked lane and lanes at
  other poses, a sub-list of lanes (the lanes left off are never read);
  the dense pair on a culled compaction, on a lane with no active tile pair
  and on a frozen lane (count 0: zeros);
* compact_tile_mask_lanes gives each lane compact_tile_mask's list, and the
  Morton tile functions with a lane axis each lane's values;
* the lane wrappers take the plain path on the CPU without loading a kernel;
* align_batch builds its grid lists through select_lanes (one call a
  batched build step, three under ACVO, only the lanes that need a list)
  and runs 'pallas' through one dense_flow_lanes and one dense_step_lanes
  call a batched iteration;
* make_batch_align(backend="pallas") against JAX's make_batch_align(backend=
  "pallas_interpret") on 2 lanes of 1024-point colour clouds: iterations
  equal, transforms within 5e-3 (ROADMAP.md's North star).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unified_cvo_tpu.config import CvoParams as JaxParams
from unified_cvo_tpu.parallel.batch_align import make_batch_align as j_make_batch_align
from unified_cvo_tpu.parallel.batch_align import stack_pairs as j_stack_pairs
from unified_cvo_tpu.utils.pointcloud import make_pointcloud as j_make
from unified_cvo_tpu_torch.apps import f2f_sequence as f2f
from unified_cvo_tpu_torch.config import KITTI_COLOR_BENCH, KITTI_GEOMETRIC_BENCH
from unified_cvo_tpu_torch.models.align import align_batch
from unified_cvo_tpu_torch.ops import cuda_lib, dense, lie, morton
from unified_cvo_tpu_torch.ops import neighbors as nbr
from unified_cvo_tpu_torch.ops import select as sel
from unified_cvo_tpu_torch.parallel.batch_align import make_batch_align, stack_pairs
from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud

torch.set_num_threads(1)

N = 2048
TI, TJ = 64, 128


@pytest.fixture(scope="module")
def scene():
    frames, _, feats = f2f.make_sequence(N, 4, features=True)
    return frames, feats, torch.from_numpy(f2f.initial_guess())


def _pose(guess, b):
    """Lane b's pose: the bench guess moved by a small twist of its own."""
    xi = 0.01 * b * torch.tensor([0.2, -0.1, 0.3, 1.0, -0.5, 0.4])
    dR, dT = lie.se3_exp(xi, 1.0)
    R, T = guess[:3, :3] @ dR, guess[:3, :3] @ dT + guess[:3, 3]
    return lie.invert_rt(R, T)


def _grid_lanes(scene, B):
    """B lanes of grid inputs: frames b -> b + 1 at lane b's pose; lane 1's
    source keeps 1500 of its points (the rest masked rows)."""
    frames, _, guess = scene
    gs = []
    for b in range(B):
        src = frames[b][:1500] if b == 1 else frames[b]
        x = make_pointcloud(src, bucket=N, device="cpu")
        y = make_pointcloud(frames[b + 1], bucket=N, device="cpu")
        Rinv, Tinv = _pose(guess, b)
        gs.append(nbr.grid_inputs(KITTI_GEOMETRIC_BENCH, torch.tensor(0.5), x, y, Rinv, Tinv))
    return gs


def _stack(gs):
    return [torch.stack([getattr(g, f) for g in gs]) for f in ("tab", "cbase", "xr2", "pose")]


@pytest.mark.parametrize("B", [1, 3])
def test_select_lanes_plain_equals_the_unbatched_select(scene, B):
    gs = _grid_lanes(scene, B)
    got = sel.select_lanes(*_stack(gs), nbr.DEFAULT_K, nbr.PER_CELL_CAP, nbr.GRID_DIMS)
    assert [tuple(t.shape) for t in got] == [(B, 32, N), (B, 3, 32, N), (B, N)]
    for b, g in enumerate(gs):
        want = sel.select(g.tab, g.cbase, g.xr2, g.pose, nbr.DEFAULT_K, nbr.PER_CELL_CAP,
                          nbr.GRID_DIMS)
        assert all(torch.equal(u[b], v) for u, v in zip(got, want)), b
        assert int(want[2].sum()) > 0
    if B == 3:
        # a sub-list: lanes 0 and 2 alone give their bits; lane 1 is not read
        sub = sel.select_lanes(*_stack([gs[0], gs[2]]), nbr.DEFAULT_K, nbr.PER_CELL_CAP,
                               nbr.GRID_DIMS)
        assert all(torch.equal(s[0], g[0]) and torch.equal(s[1], g[2])
                   for s, g in zip(sub, got))
        assert bool((got[0][1][:, 1500:] == -1).all())       # masked rows: dead slots


def test_build_neighbor_list_lanes_equals_the_unbatched_build(scene):
    frames, feats, guess = scene
    xs = [make_pointcloud(frames[b], features=feats, bucket=N, device="cpu") for b in range(3)]
    ys = [make_pointcloud(frames[b + 1], features=feats, bucket=N, device="cpu")
          for b in range(3)]
    poses = [_pose(guess, b) for b in range(3)]
    ells = [torch.tensor(e) for e in (0.5, 0.45, 0.6)]
    got = nbr.build_neighbor_list_lanes(KITTI_COLOR_BENCH, ells, xs, ys, [p[0] for p in poses],
                                        [p[1] for p in poses])
    for b in range(3):
        want = nbr.build_neighbor_list(KITTI_COLOR_BENCH, ells[b], xs[b], ys[b], *poses[b])
        for name in nbr.NeighborList._fields:
            u, v = getattr(got[b], name), getattr(want, name)
            assert (u is None) == (v is None) and (u is None or torch.equal(u, v)), name


def _masks(B, nI, nJ, seed=0):
    m = (np.random.default_rng(seed).random((B, nI, nJ)) < 0.4).astype(np.float32)
    if B > 1:
        m[1] = 0.0              # a lane with no active tile pair
    if B > 2:
        m[2] = 1.0              # every pair active
    m[0, 3] = 0.0               # an empty source tile
    return torch.from_numpy(m)


@pytest.mark.parametrize("B", [1, 3])
def test_compact_tile_mask_lanes_gives_each_lane_its_list(B):
    mask = _masks(B, 12, 9)
    live = torch.tensor([True, True, False][:B])
    comp = dense.compact_tile_mask_lanes(mask, live)
    for b in range(B):
        want = dense.compact_tile_mask(mask[b])
        for name in ("pair_i", "pair_j", "first", "row_has"):
            assert torch.equal(getattr(comp, name)[b], getattr(want, name)), name
        assert int(comp.n[b]) == (int(want.n) if live[b] else 0)
    assert comp.n.dtype == comp.offset.dtype == comp.total.dtype == torch.int32
    assert comp.offset.tolist() == [int(comp.n[:b].sum()) for b in range(B)]
    assert int(comp.total) == int(comp.n.sum())


def test_tile_functions_take_a_lane_axis(scene):
    frames = scene[0]
    clouds = [morton.sort_cloud(make_pointcloud(frames[b], bucket=N, device="cpu"))[0]
              for b in range(3)]
    xyz = torch.stack([c.xyz for c in clouds])
    mask = torch.stack([c.mask for c in clouds])
    ell = torch.tensor([0.5, 0.3, 0.8])
    lo, hi = morton.tile_aabbs(xyz, mask, TI)
    d2 = morton.tile_d2max(KITTI_GEOMETRIC_BENCH, ell, xyz, mask, TI)
    m = morton.tile_cull_mask(lo, hi, d2, lo.flip(0), hi.flip(0))
    for b in range(3):
        lo1, hi1 = morton.tile_aabbs(xyz[b], mask[b], TI)
        d21 = morton.tile_d2max(KITTI_GEOMETRIC_BENCH, ell[b], xyz[b], mask[b], TI)
        assert torch.equal(lo[b], lo1) and torch.equal(hi[b], hi1) and torch.equal(d2[b], d21)
        assert torch.equal(m[b], morton.tile_cull_mask(lo1, hi1, d21, lo[2 - b], hi[2 - b]))


def _dense_lanes(scene, B):
    """B lanes of the dense passes' inputs (KITTI_COLOR_BENCH, frames b ->
    b + 1 at lane b's pose, Morton-sorted): packs, step packs and the
    culled masks (lane 1: no active tile pair)."""
    frames, feats, guess = scene
    params = KITTI_COLOR_BENCH
    xps, yps, yts, masks = [], [], [], []
    for b in range(B):
        x = morton.sort_cloud(make_pointcloud(frames[b], features=feats, bucket=N,
                                              device="cpu"))[0]
        y = morton.sort_cloud(make_pointcloud(frames[b + 1], features=feats, bucket=N,
                                              device="cpu"))[0]
        y = y.transformed(*_pose(guess, b))
        ell = torch.tensor(params.ell_init)
        x_lo, x_hi = morton.tile_aabbs(x.xyz, x.mask, TI)
        y_lo, y_hi = morton.tile_aabbs(y.xyz, y.mask, TJ)
        mask = morton.tile_cull_mask(x_lo, x_hi, morton.tile_d2max(params, ell, x.xyz, x.mask, TI),
                                     y_lo, y_hi)
        masks.append(torch.zeros_like(mask) if b == 1 else mask)
        lo = dense.layout_for(params, x)
        c = dense.cloud_center(x)
        xps.append(dense.pack_x(params, lo, x, ell, center=c))
        yps.append(dense.pack_y(lo, y, center=c))
        twist = torch.tensor([0.1, -0.2, 0.3, 0.5, 0.1, -0.7]) * (1.0 + 0.1 * b)
        yts.append(dense.pack_y(lo, y, twist=twist / torch.linalg.vector_norm(twist), center=c))
    return params, lo, torch.stack(xps), torch.stack(yps), torch.stack(yts), torch.stack(masks)


@pytest.mark.parametrize("B", [1, 3])
def test_dense_lanes_plain_equal_the_unbatched_passes(scene, B):
    params, lo, xp, yp, yt, masks = _dense_lanes(scene, B)
    live = torch.tensor([True, True, False][:B])
    comp = dense.compact_tile_mask_lanes(masks, live)
    flow = dense.dense_flow_lanes(params, lo, xp, yp, comp, TI, TJ)
    step = dense.dense_step_lanes(params, lo, xp, yt, comp, TI, TJ)
    assert [tuple(t.shape) for t in flow] == [(B, N), (B, N, 3), (B,), (B,)]
    assert tuple(step.shape) == (B, 4)
    for b in range(B):
        one = dense.compact_tile_mask(masks[b])
        f1 = dense.dense_flow_plain(params, lo, xp[b], yp[b], one, TI, TJ)
        s1 = dense.dense_step_plain(params, lo, xp[b], yt[b], one, TI, TJ)
        if b == 2:                               # frozen: count 0, zeros
            assert all(not bool(t[b].any()) for t in flow) and not bool(step[b].any())
            assert int(f1[2]) > 0
            continue
        assert all(torch.equal(u[b], v) for u, v in zip(flow, f1)), b
        assert torch.equal(step[b], s1), b
        assert (int(f1[2]) > 0) == (b != 1)      # lane 1 has no active pair


def test_lane_wrappers_take_the_plain_path_on_cpu(scene, monkeypatch):
    def no_build(name):
        raise AssertionError(f"a CPU call tried to load the {name} kernel")

    monkeypatch.setattr(cuda_lib, "load", no_build)
    fns = (sel.select_lanes, dense.dense_flow_lanes, dense.dense_step_lanes)
    before = [f.launches for f in fns]
    sel.select_lanes(*_stack(_grid_lanes(scene, 1)), nbr.DEFAULT_K, nbr.PER_CELL_CAP,
                     nbr.GRID_DIMS)
    params, lo, xp, yp, yt, masks = _dense_lanes(scene, 1)
    comp = dense.compact_tile_mask_lanes(masks)
    dense.dense_flow_lanes(params, lo, xp, yp, comp, TI, TJ)
    dense.dense_step_lanes(params, lo, xp, yt, comp, TI, TJ)
    assert [f.launches for f in fns] == before


def _spy(monkeypatch, module, name, calls, raise_on=()):
    real = getattr(module, name)

    def spy(*a, **kw):
        calls.append((name, a))
        return real(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    for other in raise_on:
        def refuse(*a, _n=other, **kw):
            raise AssertionError(f"the batch called the unbatched {_n}")
        monkeypatch.setattr(module, other, refuse)


@pytest.mark.parametrize("case", ["forced_rebuilds", "frozen_lane", "acvo"])
def test_batched_ell_builds_go_through_select_lanes(scene, monkeypatch, case):
    """One select_lanes call a batched build step (three under ACVO: the
    xy, xx and yy lists) over exactly the lanes that need a list; the
    unbatched select is never called."""
    frames, _, guess = scene
    n = 1024 if case == "acvo" else 4096
    seq, _ = f2f.make_sequence(n, 3)
    pcs = [make_pointcloud(f, bucket=n, device="cpu") for f in seq]
    tgts = [pcs[1], pcs[2]]
    if case == "frozen_lane":          # lane 1: an empty target, degenerate at once
        tgts[1] = dataclasses.replace(pcs[2], mask=torch.zeros_like(pcs[2].mask))
    params = KITTI_GEOMETRIC_BENCH.replace(is_ell_adaptive=1) if case == "acvo" \
        else KITTI_GEOMETRIC_BENCH
    calls = []
    _spy(monkeypatch, sel, "select_lanes", calls, raise_on=("select",))
    src_b, tgt_b = stack_pairs(pcs[:2], tgts)
    _, _, info = align_batch(src_b, tgt_b, guess.expand(2, 4, 4), params, device="cpu",
                             backend="ell", nl_builder="grid", max_iter=8 if case == "acvo" else 40,
                             nl_skin=0.3 if case == "acvo" else 0.02)
    lanes = [a[0].shape[0] for _, a in calls]
    per_step = 3 if case == "acvo" else 1
    assert len(lanes) % per_step == 0
    steps = [lanes[i] for i in range(0, len(lanes), per_step)]
    assert all(lanes[i:i + per_step] == [lanes[i]] * per_step
               for i in range(0, len(lanes), per_step))
    assert sum(steps) == sum(info.nl_rebuilds) and steps[0] == 2
    if case == "forced_rebuilds":
        assert min(info.nl_rebuilds) > 1 and len(steps) < sum(info.nl_rebuilds)
    if case == "frozen_lane":
        assert info.nl_rebuilds[1] == 1 and all(s == 1 for s in steps[1:])


@pytest.fixture(scope="module")
def colour_pairs():
    frames, _, feats = f2f.make_sequence(1024, 2, features=True)
    return frames, feats, f2f.initial_guess()


def test_batched_pallas_runs_one_call_a_pass_and_matches_jax(colour_pairs, monkeypatch):
    """make_batch_align(backend="pallas") on 2 lanes against JAX's
    make_batch_align(backend="pallas_interpret") (its vmapped Pallas
    kernels in interpret mode): iterations equal, transforms within 5e-3;
    one dense_flow_lanes and one dense_step_lanes call a batched
    iteration, the unbatched passes never."""
    frames, feats, guess = colour_pairs
    jp = JaxParams(**dataclasses.asdict(KITTI_COLOR_BENCH))
    jpcs = [j_make(f, features=feats, bucket=1024) for f in frames]
    js, jt = j_stack_pairs(jpcs[:2], jpcs[1:])
    T_j, _, it_j = j_make_batch_align(jp, max_iter=6, backend="pallas_interpret")(
        js, jt, jnp.asarray(np.stack([guess] * 2)))
    calls = []
    _spy(monkeypatch, dense, "dense_flow_lanes", calls, raise_on=("dense_flow",))
    _spy(monkeypatch, dense, "dense_step_lanes", calls, raise_on=("dense_step",))
    pcs = [make_pointcloud(f, features=feats, bucket=1024, device="cpu") for f in frames]
    src_b, tgt_b = stack_pairs(pcs[:2], pcs[1:])
    fn = make_batch_align(KITTI_COLOR_BENCH, max_iter=6, backend="pallas", device="cpu")
    T_t, _, it_t = fn(src_b, tgt_b, torch.from_numpy(guess).expand(2, 4, 4))
    n_it = max(fn.last_info.iterations)
    assert it_t.tolist() == np.asarray(it_j).tolist()
    assert [c[0] for c in calls] == ["dense_flow_lanes", "dense_step_lanes"] * n_it
    assert fn.last_info.host_reads == n_it
    gap = float(np.max(np.abs(T_t.numpy() - np.asarray(T_j))))
    assert gap <= 5e-3, gap
