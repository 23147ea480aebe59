"""The port's sharded paths (unified_cvo_tpu_torch/parallel/: sp, ring, dp,
dp x sp, the sharded IRLS solver and its elastic restarts) against the JAX
package on the CPU.

The ranks are 4 processes on one gloo group (torch.multiprocessing spawn,
a file:// store under tmp_path; tests/torch_parallel_worker.py), started
once for the whole module, each held to a time limit so that a hung rank
fails the tests instead of stalling them. The JAX package's own tests run
these paths on an 8-device mesh; the comparisons here are against JAX on
one device, as those tests use it as their oracle, with their tolerances:

* one ring iteration against _align_iteration_local: R and T atol 2e-6,
  nonzeros equal, a_sum rtol 1e-5 (test_parallel.py);
* the whole sp and ring loops against align(backend='jnp', max_iter=120):
  iterations equal, final ell rtol 1e-6; the pose within atol 5e-3 (sp),
  rotation 1e-3 and translation 2e-2 (ring) of the port's own align on one
  process, and within the ring's tolerances of JAX's (_full_align_agrees
  says why);
* a dp x sp iteration of a 4-pair batch on a 2 x 2 grid against
  _align_iteration_local pair by pair (test_sharding.py: atol 1e-5,
  inner product rtol 1e-4, nonzeros equal), and whole alignments of a
  6-pair batch split over the 4 ranks (padded to 8) against align lane by
  lane (atol 2e-3, iterations equal);
* the sharded IRLS solver, frame-sharded, against irls_solve(engine=
  'device'): it equal, ell rtol 1e-6, poses atol 5e-4 (test_sharding.py);
* test_elastic.py's two cases on 4 ranks, then on a 2-rank group: the
  error falls in each part and ends below 0.02.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unified_cvo_tpu.config import CvoParams
from unified_cvo_tpu.models import irls as j_irls
from unified_cvo_tpu.models.align import align as j_align
from unified_cvo_tpu.ops import lie as j_lie
from unified_cvo_tpu.parallel.sharded import _align_iteration_local
from unified_cvo_tpu.utils.pointcloud import make_pointcloud as j_make
from unified_cvo_tpu_torch import convert
from unified_cvo_tpu_torch.models.align import align as t_align
from unified_cvo_tpu_torch.parallel import sharded_irls as t_sirls

import torch_parallel_worker as worker
from test_elastic import _pose_err, _setup

WORLD = 4
TIMEOUT = 240.0
PARAMS = CvoParams(ell_init=0.5, is_using_intensity=1, max_step=0.05)


def _pair(seed, n):
    import __graft_entry__ as ge

    return ge._synthetic_pair(n=n, m=n, seed=seed)


def _np_cloud(pc):
    return worker.stacked_numpy(pc)


def _stack(clouds):
    return {k: None if v[0] is None else np.stack(v)
            for k, v in zip(("xyz", "mask", "features", "labels", "geometric_types"),
                            zip(*[list(_np_cloud(c).values()) for c in clouds]))}


def _irls_case():
    """test_sharding.py::test_sharded_full_irls_matches_device_engine's setup."""
    rng = np.random.default_rng(0)
    F, n = 5, 256
    base = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(-1, 1, n)],
                    axis=1).astype(np.float32)
    clouds, init = [], []
    for f in range(F):
        xi = 0.06 * rng.normal(size=6).astype(np.float32)
        R, t = (np.asarray(v) for v in j_lie.se3_exp(jnp.asarray(xi), 1.0))
        if f == 0:
            R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        clouds.append(j_make(((base - t) @ R).astype(np.float32), bucket=n))
        init.append(np.eye(3, 4, dtype=np.float32))
    edges = [(i, j) for i in range(F) for j in range(i + 1, F)]
    p = CvoParams(ell_init=0.5, multiframe_ell_init=0.5, multiframe_ell_min=0.15,
                  multiframe_ell_decay_rate=0.8, multiframe_iterations_per_ell=3,
                  multiframe_iterations_per_solve=4, multiframe_min_nonzeros=10,
                  multiframe_max_iters=40)
    return j_irls.stack_clouds(clouds), np.stack(init), edges, [True] + [False] * (F - 1), p


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The inputs, the ranks' results (one dict a rank) and the JAX side's."""
    tmp = tmp_path_factory.mktemp("ranks")
    src, tgt = _pair(0, 512)
    pairs4 = [_pair(s, 128) for s in range(4)]
    pairs6 = [_pair(s, 128) for s in range(6)]
    stacked, init, edges, pivots, bp = _irls_case()
    el_stacked, el_true, el_edges = _setup(np.random.default_rng(0))
    F = len(el_true)
    el_params = CvoParams(ell_init=0.6, multiframe_ell_init=0.6, multiframe_min_nonzeros=10)
    el_solver = CvoParams(ell_init=0.6, multiframe_ell_init=0.6, multiframe_ell_min=0.1,
                          multiframe_ell_decay_rate=0.8, multiframe_iterations_per_ell=2,
                          multiframe_iterations_per_solve=3, multiframe_min_nonzeros=10)
    inp = {
        "params": dataclasses.asdict(PARAMS),
        "src": _np_cloud(src), "tgt": _np_cloud(tgt),
        "src_b": _stack([p[0] for p in pairs4]), "tgt_b": _stack([p[1] for p in pairs4]),
        "dp_batch": {"src": _stack([p[0] for p in pairs6]),
                     "tgt": _stack([p[1] for p in pairs6])},
        "irls": {"params": dataclasses.asdict(bp), "clouds": _np_cloud(stacked),
                 "init": init, "edge_i": np.asarray([e[0] for e in edges], np.int32),
                 "edge_j": np.asarray([e[1] for e in edges], np.int32),
                 "pivots": np.asarray(pivots, np.float32)},
        "elastic": {"params": dataclasses.asdict(el_params),
                    "solver_params": dataclasses.asdict(el_solver),
                    "clouds": _np_cloud(el_stacked),
                    "init": np.tile(np.eye(3, 4, dtype=np.float32), (F, 1, 1)),
                    "edge_i": np.asarray([e[0] for e in el_edges], np.int32),
                    "edge_j": np.asarray([e[1] for e in el_edges], np.int32),
                    "pivots": np.asarray([1.0] + [0.0] * (F - 1), np.float32)},
    }
    worker.run_ranks(worker.cases, WORLD, str(tmp / "store"), TIMEOUT, inp, str(tmp))
    got = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"inp": inp, "got": got, "pair": (src, tgt), "pairs4": pairs4, "pairs6": pairs6,
            "irls": (stacked, init, edges, pivots, bp), "elastic_true": el_true}


@pytest.fixture(scope="module")
def jax_full(ranks):
    src, tgt = ranks["pair"]
    return j_align(src, tgt, jnp.eye(4, dtype=jnp.float32), PARAMS, backend="jnp",
                   max_iter=120, chunk=512)


@pytest.fixture(scope="module")
def port_full(ranks):
    """The port's own align on one process, at the shards' chunk."""
    src, tgt = ranks["pair"]
    params = convert.params_from_fields(dataclasses.asdict(PARAMS))
    s = convert.pointcloud_from_numpy(**_np_cloud(src), device="cpu")
    t = convert.pointcloud_from_numpy(**_np_cloud(tgt), device="cpu")
    return t_align(s, t, np.eye(4, dtype=np.float32), params, device="cpu", backend="jnp",
                   max_iter=120, chunk=64)


def test_every_rank_returns_the_same(ranks):
    """Every rank of a group ends with the same bits (the sums are
    all-reduced, never kept per rank)."""
    def same(a, b):
        if isinstance(a, dict):
            return all(same(a[k], b[k]) for k in a)
        if isinstance(a, (tuple, list)):
            return all(same(x, y) for x, y in zip(a, b))
        return np.array_equal(np.asarray(a), np.asarray(b))

    got = ranks["got"]
    for key in ("ring_step", "ring_full", "sp_full", "dp_sp_step", "dp_batch", "irls"):
        assert all(same(got[0][key], got[r][key]) for r in range(1, WORLD)), key
    for key in ("elastic_step", "elastic_solver"):
        assert same(got[0][key], got[1][key]), key
        assert got[2][key][1] is None and got[3][key][1] is None


def test_ring_iteration_matches_single_device(ranks):
    src, tgt = ranks["pair"]
    R1, T1, m1 = ranks["got"][0]["ring_step"]
    R2, T2, m2 = _align_iteration_local(PARAMS, None, src, tgt, jnp.eye(3, dtype=jnp.float32),
                                        jnp.zeros((3,), jnp.float32), jnp.float32(0.5))
    np.testing.assert_allclose(R1, np.asarray(R2), atol=2e-6)
    np.testing.assert_allclose(T1, np.asarray(T2), atol=2e-6)
    assert int(m1["nonzeros"]) == int(m2["nonzeros"])
    np.testing.assert_allclose(float(m1["a_sum"]), float(m2["inner_product"]), rtol=1e-5)


def _full_align_agrees(got, jax_full, port_full, pose_atol):
    """The whole sharded loop: JAX's schedule (iterations equal, final ell
    rtol 1e-6); the pose within `pose_atol` (rotation, translation) of the
    port's own align on one process at the shards' chunk, and within the
    ring's tolerances (1e-3, 2e-2) of JAX's. On this fixture the 120
    iterations stop before convergence and reordered float32 sums spread the
    pose: JAX against itself at chunk 64 and 512 by 5.2e-3, the port's one
    process against JAX by 1.19e-2 (translation; rotation 1.6e-4)."""
    T_ref, _, info_ref = jax_full
    T_sh, _, info_sh = got
    assert int(info_sh["iterations"]) == int(info_ref.iterations) == port_full[2].iterations
    np.testing.assert_allclose(float(info_sh["final_ell"]), float(info_ref.final_ell),
                               rtol=1e-6)
    T_one = port_full[0].numpy()
    np.testing.assert_allclose(T_sh[:3, :3], T_one[:3, :3], atol=pose_atol[0])
    np.testing.assert_allclose(T_sh[:3, 3], T_one[:3, 3], atol=pose_atol[1])
    np.testing.assert_allclose(T_sh[:3, :3], np.asarray(T_ref)[:3, :3], atol=1e-3)
    np.testing.assert_allclose(T_sh[:3, 3], np.asarray(T_ref)[:3, 3], atol=2e-2)


def test_full_align_sharded_sp_matches_single_device(ranks, jax_full, port_full):
    _full_align_agrees(ranks["got"][0]["sp_full"], jax_full, port_full, (5e-3, 5e-3))


def test_full_align_ring_matches_single_device(ranks, jax_full, port_full):
    _full_align_agrees(ranks["got"][0]["ring_full"], jax_full, port_full, (1e-3, 2e-2))


def test_dp_sp_step_matches_single_device(ranks):
    R_new, T_new, metrics = ranks["got"][0]["dp_sp_step"]
    for b, (src, tgt) in enumerate(ranks["pairs4"]):
        R1, T1, m1 = _align_iteration_local(
            PARAMS, None, src, tgt, jnp.eye(3, dtype=jnp.float32),
            jnp.zeros((3,), jnp.float32), jnp.float32(0.5))
        np.testing.assert_allclose(R_new[b], np.asarray(R1), atol=1e-5)
        np.testing.assert_allclose(T_new[b], np.asarray(T1), atol=1e-5)
        np.testing.assert_allclose(float(metrics["inner_product"][b]),
                                   float(m1["inner_product"]), rtol=1e-4)
        assert int(metrics["nonzeros"][b]) == int(m1["nonzeros"])


def test_dp_batch_align_matches_single_device(ranks):
    Tb, rets, iters = ranks["got"][0]["dp_batch"]
    assert Tb.shape == (6, 4, 4) and rets.shape == (6,) and iters.shape == (6,)
    assert np.all(np.isfinite(Tb))
    for b, (src, tgt) in enumerate(ranks["pairs6"]):
        T1, _, info1 = j_align(src, tgt, jnp.eye(4), PARAMS, chunk=128, max_iter=15)
        np.testing.assert_allclose(Tb[b], np.asarray(T1), atol=2e-3)
        assert int(iters[b]) == int(info1.iterations)


def test_sharded_irls_matches_device_engine(ranks):
    stacked, init, edges, pivots, p = ranks["irls"]
    ref_poses, hist = j_irls.irls_solve(stacked, init, edges, pivots, p, chunk=256,
                                        engine="device", backend="dense")
    poses, info = ranks["got"][0]["irls"]
    assert int(info["it"]) == hist[0]["iter"]
    np.testing.assert_allclose(float(info["ell"]), hist[0]["ell"], rtol=1e-6)
    np.testing.assert_allclose(poses, np.asarray(ref_poses), atol=5e-4)


def _errors(ranks, key):
    true = ranks["elastic_true"]
    F = len(true)
    err0 = _pose_err(np.tile(np.eye(3, 4, dtype=np.float32), (F, 1, 1)), true)
    return err0, [_pose_err(np.asarray(part if key == "elastic_step" else part[0]), true)
                  for part in ranks["got"][0][key]]


def test_ba_survives_rank_loss(ranks):
    """test_elastic.py::test_ba_survives_device_loss on 4 ranks, then on a
    2-rank group from the carried poses."""
    err0, (err1, err2) = _errors(ranks, "elastic_step")
    assert err1 < err0, (err1, err0)
    assert err2 < err1, (err2, err1)
    assert err2 < 0.02, err2


def test_full_sharded_solver_survives_rank_loss(ranks):
    """test_elastic.py::test_full_sharded_solver_survives_device_loss: the
    schedule capped at 4 outer iterations on 4 ranks, resumed on 2 from
    (poses, ell) through ell0."""
    err0, (err1, err2) = _errors(ranks, "elastic_solver")
    (_, info1), (_, info2) = ranks["got"][0]["elastic_solver"]
    assert int(info1["it"]) >= 4
    assert err1 < err0, (err1, err0)
    assert float(info2["ell"]) < float(info1["ell"])
    assert err2 < err1, (err2, err1)
    assert err2 < 0.02, err2


def test_pad_edges_and_frames_match_jax():
    from unified_cvo_tpu.parallel import sharded_irls as j_sirls

    ei, ej = np.array([0, 1, 2, 0, 1], np.int32), np.array([1, 2, 3, 3, 3], np.int32)
    for n in (1, 2, 4, 8):
        for a, b in zip(t_sirls.pad_edges(ei, ej, n), j_sirls.pad_edges(ei, ej, n)):
            assert np.array_equal(a, b)
    stacked, *_ = _irls_case()
    for n in (1, 2, 4):
        jp = j_sirls.pad_frames(stacked, n)
        tp = t_sirls.pad_frames(worker._clouds(_np_cloud(stacked)), n)
        for k, v in _np_cloud(jp).items():
            got = getattr(tp, k)
            assert (v is None) == (got is None)
            assert v is None or np.array_equal(got.numpy(), v)


@pytest.mark.parametrize("kw, what", [
    (dict(group=object(), ring_group=object()), "mutually exclusive"),
    (dict(group=object(), adaptive_ell=True), "adaptive_ell"),
    (dict(ring_group=object(), backend="ell"), "backend"),
    (dict(group=object(), backend="pallas"), "backend"),
])
def test_sharded_align_arguments_raise(kw, what):
    """JAX's ValueErrors for the sharded align (align.py:199-210), raised
    before any collective."""
    src, tgt = _pair(0, 128)
    s = convert.pointcloud_from_numpy(**_np_cloud(src), device="cpu")
    t = convert.pointcloud_from_numpy(**_np_cloud(tgt), device="cpu")
    params = convert.params_from_fields(dataclasses.asdict(PARAMS))
    with pytest.raises(ValueError, match=what):
        t_align(s, t, np.eye(4, dtype=np.float32), params, device="cpu", **kw)


def test_a_hung_rank_fails_within_the_limit(tmp_path):
    """run_ranks kills ranks that are not done by the limit and raises."""
    with pytest.raises(TimeoutError):
        worker.run_ranks(worker.hang, 2, str(tmp_path / "store"), 8.0)
