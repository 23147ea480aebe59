"""Batched registration of the port (models/align.py::align_batch,
parallel/batch_align.py) and the lane axis of the ELL consume kernels
(ops/ell.py::flow_reduce_lanes, step_cached_lanes) on the CPU:

* make_batch_align against JAX's sequential align, lane by lane
  (test_parallel.py::test_batch_align_matches_sequential: B = 4, n = 192,
  max_iter 25, atol 2e-3, iterations equal);
* the batched ELL loop on 4096-point geometric clouds against the port's
  sequential align, lane by lane: iterations, builds, ret, final ell and
  pose equal bit for bit, at the list's default skin and with rebuilds
  forced (a small skin: each lane rebuilds on its own drift), and with
  one lane frozen early (an empty target: a degenerate flow ends it at
  the first iteration while the other lane runs on);
* align_batch on ACVO ('ell' and dense), the colour and channel-only
  lists and 'pallas' against align lane by lane;
* the plain versions with a lane axis against the unbatched ones, bit for
  bit, at B = 1 and B = 3, in the three variants of the flow pass.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unified_cvo_tpu.config import CvoParams as JaxParams
from unified_cvo_tpu.models.align import align as j_align
from unified_cvo_tpu.parallel.batch_align import stack_pairs as j_stack_pairs
from unified_cvo_tpu_torch import convert
from unified_cvo_tpu_torch.apps import f2f_sequence as f2f
from unified_cvo_tpu_torch.config import KITTI_GEOMETRIC_BENCH
from unified_cvo_tpu_torch.models.align import align, align_batch
from unified_cvo_tpu_torch.ops import cuda_lib
from unified_cvo_tpu_torch.ops import ell as t_ell
from unified_cvo_tpu_torch.parallel.batch_align import make_batch_align, stack_pairs
from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud

torch.set_num_threads(1)

PARAMS = JaxParams(ell_init=0.5, is_using_intensity=1, max_step=0.05)


def _jax_pair(seed, n):
    import __graft_entry__ as ge

    return ge._synthetic_pair(n=n, m=n, seed=seed)


def _port(pc):
    return convert.pointcloud_from_numpy(
        **{k: None if getattr(pc, k) is None else np.asarray(getattr(pc, k))
           for k in ("xyz", "mask", "features", "labels", "geometric_types")}, device="cpu")


def test_batch_align_matches_jax_sequential():
    B = 4
    pairs = [_jax_pair(s, 192) for s in range(B)]
    src_b, tgt_b = stack_pairs([_port(p[0]) for p in pairs], [_port(p[1]) for p in pairs])
    params = convert.params_from_fields(PARAMS.__dict__)
    fn = make_batch_align(params, chunk=192, max_iter=25, device="cpu")
    Tb, rets, iters = fn(src_b, tgt_b, torch.eye(4).repeat(B, 1, 1))
    assert Tb.shape == (B, 4, 4) and rets.shape == (B,) and iters.shape == (B,)
    for b in range(B):
        T1, _, info1 = j_align(pairs[b][0], pairs[b][1], jnp.eye(4), PARAMS, chunk=192,
                               max_iter=25)
        np.testing.assert_allclose(Tb[b].numpy(), np.asarray(T1), atol=2e-3)
        assert int(iters[b]) == int(info1.iterations)


def test_stack_pairs_matches_jax():
    pairs = [_jax_pair(s, 128) for s in range(3)]
    js, jt = j_stack_pairs([p[0] for p in pairs], [p[1] for p in pairs])
    ts, tt = stack_pairs([_port(p[0]) for p in pairs], [_port(p[1]) for p in pairs])
    for j, t in ((js, ts), (jt, tt)):
        for k in ("xyz", "mask", "features", "labels", "geometric_types"):
            a, b = getattr(j, k), getattr(t, k)
            assert (a is None) == (b is None)
            assert a is None or np.array_equal(np.asarray(a), b.numpy())


@pytest.fixture(scope="module")
def geo_frames():
    frames, _ = f2f.make_sequence(4096, 2)
    return [make_pointcloud(f, bucket=4096, device="cpu") for f in frames]


@pytest.mark.parametrize("case", ["default_skin", "forced_rebuilds", "frozen_lane"])
def test_batched_ell_loop_matches_sequential(geo_frames, case):
    """Each lane makes the sequential align's iterations and builds and
    ends on its pose bit for bit; the host reads one flag tensor per
    batched iteration."""
    pcs = geo_frames
    guess = torch.from_numpy(f2f.initial_guess())
    kw = {"default_skin": dict(max_iter=20), "forced_rebuilds": dict(max_iter=40, nl_skin=0.02),
          "frozen_lane": dict(max_iter=40, nl_skin=0.02)}[case]
    srcs, tgts, guesses = [pcs[0], pcs[1]], [pcs[1], pcs[2]], [guess, guess]
    if case == "frozen_lane":           # lane 1: an empty target, degenerate at once
        tgts[1] = dataclasses.replace(pcs[2], mask=torch.zeros_like(pcs[2].mask))
    src_b, tgt_b = stack_pairs(srcs, tgts)
    T_b, ret_b, info_b = align_batch(src_b, tgt_b, torch.stack(guesses),
                                     KITTI_GEOMETRIC_BENCH, device="cpu", **kw)
    assert (info_b.backend, info_b.nl_builder) == ("ell", "grid")
    assert info_b.host_reads == max(info_b.iterations)
    for b in range(2):
        T, ret, info = align(srcs[b], tgts[b], guesses[b], KITTI_GEOMETRIC_BENCH, device="cpu",
                             **kw)
        assert info_b.iterations[b] == info.iterations
        assert info_b.nl_rebuilds[b] == info.nl_rebuilds
        assert int(ret_b[b]) == int(ret) and int(info_b.nl_overflow[b]) == int(info.nl_overflow)
        assert torch.equal(info_b.final_ell[b], info.final_ell)
        assert torch.equal(T_b[b], T), float((T_b[b] - T).abs().max())
    if case == "forced_rebuilds":
        assert min(info_b.nl_rebuilds) > 1
    if case == "frozen_lane":
        assert info_b.iterations[1] < info_b.iterations[0] and int(ret_b[1]) == -1


@pytest.mark.parametrize("case", ["acvo_ell", "colour_ell", "channel_only", "acvo_dense",
                                  "pallas"])
def test_other_batched_paths_match_sequential(case):
    """align_batch on the other paths against align lane by lane: ACVO on
    'ell' (xx and yy lists, the staleness bound per lane) and on a dense
    backend, the colour list (geometry x channel), the channel-only scan
    list, and 'pallas' (Morton culling per lane): iterations, builds and
    final ell equal, transforms bit-equal, but on the colour list within
    1e-5: the CPU's channel factor comes out of its gathers laid out
    point-major, so the sequential step's plain sums run in another order
    than the lanes' stacked (contiguous) ones."""
    from unified_cvo_tpu_torch.config import KITTI_COLOR_BENCH

    n, max_iter, params, kw = {
        "acvo_ell": (1024, 8, KITTI_GEOMETRIC_BENCH.replace(is_ell_adaptive=1),
                     dict(backend="ell")),
        "colour_ell": (4096, 15, KITTI_COLOR_BENCH, {}),
        "channel_only": (1024, 10, KITTI_COLOR_BENCH.replace(is_using_geometry=0),
                         dict(backend="ell")),
        "acvo_dense": (1024, 6, KITTI_GEOMETRIC_BENCH.replace(is_ell_adaptive=1),
                       dict(backend="jnp")),
        "pallas": (1024, 6, KITTI_COLOR_BENCH, dict(backend="pallas"))}[case]
    frames, _, feats = f2f.make_sequence(n, 2, features=True)
    pcs = [make_pointcloud(f, features=feats, bucket=n, device="cpu") for f in frames]
    guess = torch.from_numpy(f2f.initial_guess())
    src_b, tgt_b = stack_pairs(pcs[:2], pcs[1:])
    T_b, _, info_b = align_batch(src_b, tgt_b, guess.repeat(2, 1, 1), params, device="cpu",
                                 max_iter=max_iter, **kw)
    for b in range(2):
        T, _, info = align(pcs[b], pcs[b + 1], guess, params, device="cpu", max_iter=max_iter,
                           **kw)
        assert info_b.iterations[b] == info.iterations
        assert (info_b.nl_rebuilds is None) == (info.nl_rebuilds is None)
        assert info_b.nl_rebuilds is None or info_b.nl_rebuilds[b] == info.nl_rebuilds
        assert torch.equal(info_b.final_ell[b], info.final_ell)
        if case == "colour_ell":
            assert float(torch.max(torch.abs(T_b[b] - T))) <= 1e-5
        else:
            assert torch.equal(T_b[b], T), float(torch.max(torch.abs(T_b[b] - T)))


def _lane_inputs(seed, K=32, N=2048):
    g = torch.Generator().manual_seed(seed)
    xp = torch.randn(6, N, generator=g)
    xp[3] = torch.rand(N, generator=g) * 2           # distance gate
    xp[4] = -torch.rand(N, generator=g)              # -1 / (2 l^2)
    xp[5] = torch.rand(N, generator=g)               # step coef
    y = torch.randn(3, K, N, generator=g) * 0.7
    R = torch.linalg.qr(torch.randn(3, 3, generator=g))[0]
    T = torch.randn(3, generator=g) * 0.1
    chan = torch.rand(K, N, generator=g)
    return xp, y, t_ell.pack_scalars(KITTI_GEOMETRIC_BENCH, R, T), chan


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("variant", ["geo", "geo_chan", "chan"])
def test_lane_plain_versions_equal_the_unbatched_ones(B, variant):
    """flow_reduce_lanes and step_cached_lanes (their plain versions on the
    CPU) give each lane the unbatched pass's bits."""
    ins = [_lane_inputs(s) for s in range(B)]
    use_geo = variant != "chan"
    chan_b = None if variant == "geo" else torch.stack([i[3] for i in ins])
    xp_b, y_b, sc_b = (torch.stack([i[j] for i in ins]) for j in range(3))
    fb = t_ell.flow_reduce_lanes(xp_b, y_b, sc_b, 0.1, 0.2, chan=chan_b, use_geometry=use_geo)
    sb = t_ell.step_cached_lanes(xp_b, y_b, fb[4], sc_b, twist=fb[0])
    assert fb[0].shape == (B, 6) and fb[4].shape == (B, 32, 2048) and sb.shape == (B, 4)
    for b, (xp, y, sc, ch) in enumerate(ins):
        f1 = t_ell.flow_reduce(xp, y, sc, 0.1, 0.2, chan=None if variant == "geo" else ch,
                               use_geometry=use_geo)
        assert all(torch.equal(a[b], c) for a, c in zip(fb, f1))
        assert torch.equal(sb[b], t_ell.step_cached(xp, y, f1[4], sc, twist=f1[0]))


def test_lane_wrappers_take_the_plain_path_on_cpu(monkeypatch):
    def no_build(name):
        raise AssertionError(f"a CPU call tried to load the {name} kernel")

    monkeypatch.setattr(cuda_lib, "load", no_build)
    xp, y, sc, _ = _lane_inputs(0, N=256)
    before = (t_ell.flow_reduce_lanes.launches, t_ell.step_cached_lanes.launches)
    f = t_ell.flow_reduce_lanes(xp[None], y[None], sc[None], 0.1, 0.2)
    t_ell.step_cached_lanes(xp[None], y[None], f[4], sc[None], twist=f[0])
    assert (t_ell.flow_reduce_lanes.launches, t_ell.step_cached_lanes.launches) == before
