"""The port's multiframe IRLS bundle adjustment (models/irls.py) and the
device covariance (utils/covariance.py) against the JAX package on the CPU,
on identical numpy inputs:

* the Gauss-Newton blocks of one edge against JAX's and against the numpy
  brute force of test_irls.py (per-pair residuals and jacobians);
* the edge moments, dense and from the ELL list at K = 192, P = 32
  (test_neighbors.py::test_irls_edge_moments_ell_matches_dense's setup),
  rtol 2e-4, atol 2e-3, nonzeros exact;
* the bunny BA of test_irls.py on both engines, each frame within
  |log dT| < 5e-3 of JAX's with the pivot unchanged; the device engine
  against the host engine (test_irls.py's rtol 1e-4, atol 1e-4); block PCG
  against the dense solve on the 120-frame chain;
* a solve resumed from a checkpoint that JAX's host engine wrote, against
  JAX's uninterrupted solve;
* point_covariances_device against JAX's point_covariances_tpu.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unified_cvo_tpu.models import irls as j_irls
from unified_cvo_tpu.ops import lie as j_lie
from unified_cvo_tpu.ops.neighbors import static_support_radius as j_radius
from unified_cvo_tpu.utils.covariance import point_covariances_tpu as j_cov
from unified_cvo_tpu.utils.pointcloud import make_pointcloud as j_make
from unified_cvo_tpu_torch import convert
from unified_cvo_tpu_torch.models import irls as t_irls
from unified_cvo_tpu_torch.ops import lie as t_lie
from unified_cvo_tpu_torch.utils import covariance as t_cov
from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud as t_make

from oracle import oracle_kernel_matrix
from test_irls import _bunnyish, _params, brute_force_system
from test_neighbors import _params as _nbr_params
from test_neighbors import _scene

torch.set_num_threads(1)

POSE_TOL = 5e-3


def _tp(jp):
    return convert.params_from_fields(dataclasses.asdict(jp))


def _T(xi):
    R, t = (np.array(v) for v in j_lie.se3_exp(jnp.asarray(np.float32(xi)), 1.0))
    return np.hstack([R, t[:, None]]).astype(np.float32)


def _pose_gap(A, B):
    """|log(A B^-1)| of two [3, 4] poses."""
    def h(P):
        return np.vstack([np.asarray(P, np.float64), [0, 0, 0, 1]])

    D = torch.from_numpy((h(A) @ np.linalg.inv(h(B))).astype(np.float32))
    return float(torch.linalg.vector_norm(t_lie.se3_log(D[:3, :3], D[:3, 3])))


def test_edge_blocks_match_jax_and_brute_force(rng):
    """test_irls.py::test_edge_blocks_match_brute_force's edge, through the
    port's dense moments and blocks."""
    p = _params()
    ell = 0.5
    p1 = _bunnyish(rng, 40)
    T1 = _T([0.05, -0.02, 0.04, 0.1, 0.05, -0.08])
    T2 = _T([-0.03, 0.04, 0.01, -0.06, 0.02, 0.05])
    p2 = p1 + rng.normal(scale=0.05, size=p1.shape).astype(np.float32)
    A = oracle_kernel_matrix(p, ell, p1 @ T1[:, :3].T + T1[:, 3], p2 @ T2[:, :3].T + T2[:, 3])

    mom = t_irls._edge_moments_single(
        _tp(p), torch.tensor(ell), t_make(p1, bucket=8, device="cpu"),
        t_make(p2, bucket=8, device="cpu"), torch.from_numpy(T1), torch.from_numpy(T2), 8)
    assert int(mom.nonzeros) == int((A > 0).sum())
    got = [np.asarray(v) for v in t_irls._edge_blocks(mom.P11, mom.P12, mom.P22,
                                                      torch.from_numpy(T1),
                                                      torch.from_numpy(T2))]
    jm = j_irls._edge_moments_single(p, jnp.float32(ell), j_make(p1, bucket=8),
                                     j_make(p2, bucket=8), jnp.asarray(T1), jnp.asarray(T2), 8)
    want = [np.asarray(v) for v in j_irls._edge_blocks(jm.P11, jm.P12, jm.P22,
                                                       jnp.asarray(T1), jnp.asarray(T2))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    H_ref, b_ref, cost_ref = brute_force_system(A, p1, p2, T1, T2)
    H_aa, H_bb, H_ab, b_a, b_b, cost = got
    for g, w in ((H_aa, H_ref[:6, :6]), (H_bb, H_ref[6:, 6:]), (H_ab, H_ref[:6, 6:]),
                 (b_a, b_ref[:6]), (b_b, b_ref[6:])):
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(cost, cost_ref, rtol=1e-3)


def _moments_case():
    rng = np.random.default_rng(0)
    jp = _nbr_params(multiframe_ell_init=0.4)
    xyz1 = _scene(rng, n=2048)
    xyz2 = _scene(rng, n=2048) + np.float32([0.05, 0.0, 0.1])
    T1 = np.eye(3, 4, dtype=np.float32)
    T2 = _T([0.004, -0.002, 0.003, 0.02, 0.01, -0.03])
    return jp, xyz1, xyz2, T1, T2


@pytest.mark.parametrize("backend", ["dense", "ell"])
def test_edge_moments_match_jax(backend):
    """One edge's moments, dense (chunk 512) or from the ELL list (K = 192,
    P = 32: the grid builder at skin 0, select_plain on the CPU), against
    JAX's same pass and against JAX's dense pass."""
    jp, xyz1, xyz2, T1, T2 = _moments_case()
    j_args = (jp, jnp.float32(0.4), j_make(xyz1, bucket=2048), j_make(xyz2, bucket=2048),
              jnp.asarray(T1), jnp.asarray(T2))
    t_args = (_tp(jp), torch.tensor(0.4), t_make(xyz1, bucket=2048, device="cpu"),
              t_make(xyz2, bucket=2048, device="cpu"), torch.from_numpy(T1),
              torch.from_numpy(T2))
    dense_ref = j_irls._edge_moments_single(*j_args, 512)
    if backend == "dense":
        want = dense_ref
        got = t_irls._edge_moments_single(*t_args, 512)
    else:
        # jitted as make_irls_kernels runs it (eager dispatch takes ~20 s)
        ell_pass = jax.jit(j_irls._edge_moments_single_ell, static_argnums=(0, 6, 7))
        want = ell_pass(*j_args, 192, 32)
        got = t_irls._edge_moments_single_ell(*t_args, nl_k=192, nl_per_cell=32)
        assert int(got.overflow) == int(want.overflow)
    assert int(got.nonzeros) == int(want.nonzeros) == int(dense_ref.nonzeros)
    for name in ("P11", "P12", "P22"):
        for ref in (want, dense_ref):
            np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                       rtol=2e-4, atol=2e-3, err_msg=name)


def _bunny_ba(F=4):
    """test_irls.py::test_irls_bunny_random_recovers_poses's frames."""
    rng = np.random.default_rng(0)
    base = _bunnyish(rng, 256)
    pts, true = [base], [np.eye(3, 4, dtype=np.float32)]
    rngs = np.random.default_rng(7)
    for _ in range(1, F):
        T = _T(0.1 * rngs.normal(size=6))
        pts.append(((base - T[:, 3]) @ T[:, :3]).astype(np.float32))
        true.append(T)
    init = np.tile(np.eye(3, 4, dtype=np.float32), (F, 1, 1))
    edges = [(i, j) for i in range(F) for j in range(i + 1, F)]
    return pts, true, init, edges, [True] + [False] * (F - 1)


def _stacks(pts, bucket=256):
    return (j_irls.stack_clouds([j_make(x, bucket=bucket) for x in pts]),
            t_irls.stack_clouds([t_make(x, bucket=bucket, device="cpu") for x in pts]))


@pytest.mark.parametrize("engine", ["host", "device"])
def test_bunny_ba_matches_jax(engine):
    p = _params()
    pts, true, init, edges, piv = _bunny_ba()
    js, ts = _stacks(pts)
    pj, hj = j_irls.irls_solve(js, init, edges, piv, p, chunk=256, engine=engine)
    pt, ht = t_irls.irls_solve(ts, init, edges, piv, _tp(p), chunk=256, engine=engine,
                               device="cpu")
    assert pt.shape == (4, 3, 4) and pt.dtype == np.float32
    np.testing.assert_array_equal(pt[0], init[0])
    for f in range(4):
        assert _pose_gap(pt[f], pj[f]) < POSE_TOL, f
        assert _pose_gap(pt[f], true[f]) < 0.05, f
    # the schedule's length is not compared: its decisions compare integer
    # nonzero totals, which one pair at the sp_thres gate can move
    assert len(ht) >= 1
    if engine == "device":
        assert set(ht[0]) == set(hj[0]) | {"host_reads"}
        assert ht[0]["host_reads"] == ht[0]["iter"] and ht[0]["overflow"] == 0
    else:
        assert set(ht[0]) == set(hj[0]) == {"iter", "ell", "nonzeros", "cost", "delta"}


def test_device_engine_matches_host_engine():
    """test_irls.py::test_device_solver_matches_host_loop through the port:
    poses at rtol 1e-4, atol 1e-4; the device engine reads the host once
    per outer iteration."""
    p = _tp(_params())
    pts, _, init, edges, piv = _bunny_ba()
    _, ts = _stacks(pts)
    host_poses, hist = t_irls.irls_solve(ts, init, edges, piv, p, chunk=256, engine="host",
                                         device="cpu")
    solve = t_irls.make_irls_solver(p, chunk=256, cloud_capacity=256)
    dev_poses, info = solve(ts, torch.from_numpy(init), torch.tensor([e[0] for e in edges]),
                            torch.tensor([e[1] for e in edges]),
                            torch.tensor(piv, dtype=torch.float32))
    assert int(info["it"]) >= len(hist)
    assert info["host_reads"] == int(info["it"])
    np.testing.assert_allclose(dev_poses.numpy(), host_poses, rtol=1e-4, atol=1e-4)


def test_cg_solver_matches_dense():
    """test_irls.py::test_cg_solver_matches_dense's 120-frame chain with
    skip-three edges: block PCG against the dense solve (atol 2e-4), and the
    short schedule moves the frames toward the truth."""
    rng = np.random.default_rng(0)
    base = _bunnyish(rng)
    F = 120
    pts, true = [], []
    for f in range(F):
        xi = (0.015 * rng.normal(size=6)).astype(np.float32) * (0.0 if f == 0 else 1.0)
        T = _T(xi)
        true.append(T)
        pts.append(((base - T[:, 3]) @ T[:, :3]).astype(np.float32))
    _, ts = _stacks(pts)
    init = np.tile(np.eye(3, 4, dtype=np.float32), (F, 1, 1))
    edges = [(i, i + 1) for i in range(F - 1)] + [(i, i + 3) for i in range(F - 3)]
    piv = [True] + [False] * (F - 1)
    short = _tp(_params().replace(multiframe_max_iters=6, multiframe_iterations_per_ell=2,
                                  multiframe_iterations_per_solve=3))
    poses_d, _ = t_irls.irls_solve(ts, init, edges, piv, short, chunk=256, engine="device",
                                   solver="dense", device="cpu")
    poses_c, _ = t_irls.irls_solve(ts, init, edges, piv, short, chunk=256, engine="device",
                                   solver="cg", device="cpu")
    np.testing.assert_allclose(poses_c, poses_d, atol=2e-4)
    err0 = max(np.abs(init[f] - true[f]).max() for f in range(F))
    err1 = max(np.abs(poses_c[f] - true[f]).max() for f in range(F))
    assert err1 < 0.7 * err0, (err0, err1)


def test_resume_from_a_jax_checkpoint(tmp_path):
    """JAX's host engine stops after 10 outer iterations with a checkpoint;
    the port resumes it under the full schedule and ends within the pose
    tolerance of JAX's uninterrupted solve."""
    p = _params()
    pts, _, init, edges, piv = _bunny_ba()
    js, ts = _stacks(pts)
    ckpt = str(tmp_path / "irls.npz")
    j_irls.irls_solve(js, init, edges, piv, p.replace(multiframe_max_iters=10), chunk=256,
                      checkpoint_path=ckpt)
    snap = convert.irls_checkpoint_from_npz(ckpt)
    assert int(snap["iter"]) == 10 and snap["world_center"].shape == (3,)
    want, _ = j_irls.irls_solve(js, init, edges, piv, p, chunk=256, engine="host")
    logs = []
    got, hist = t_irls.irls_solve(ts, init, edges, piv, _tp(p), chunk=256,
                                  checkpoint_path=ckpt, resume=True, log=logs.append,
                                  device="cpu")
    assert logs[0].startswith(f"resumed from {ckpt}: iter=10")
    assert hist and hist[0]["iter"] >= 10
    for f in range(4):
        assert _pose_gap(got[f], want[f]) < POSE_TOL, f
    assert int(np.load(ckpt)["iter"]) > 10          # the port wrote its own snapshots


def test_irls_state_carries_across_from_jax():
    """convert.irls_state_from_numpy takes the JAX stack's arrays, poses,
    edges and pivots: the clouds equal the port's own stack, and poses of
    the wrong shape are refused."""
    pts, _, init, edges, piv = _bunny_ba()
    js, ts = _stacks(pts)
    clouds, poses, pairs, flags = convert.irls_state_from_numpy(
        np.asarray(js.xyz), np.asarray(js.mask), init, np.asarray(edges), piv, device="cpu")
    assert torch.equal(clouds.xyz, ts.xyz) and torch.equal(clouds.mask, ts.mask)
    assert pairs == edges and flags == piv and poses.shape == (4, 3, 4)
    with pytest.raises(ValueError, match="3, 4"):
        convert.irls_state_from_numpy(np.asarray(js.xyz), np.asarray(js.mask), init[:, :, :3],
                                      edges, piv, device="cpu")


def test_stack_clouds_pads_to_a_common_capacity():
    a = t_make(np.ones((10, 3), np.float32), bucket=8, device="cpu")
    b = t_make(np.ones((20, 3), np.float32), bucket=8, device="cpu")
    s = t_irls.stack_clouds([a, b])
    assert s.xyz.shape == (2, 24, 3) and s.mask.shape == (2, 24)
    assert s.mask.sum(1).tolist() == [10.0, 20.0] and s.features is None


@pytest.mark.parametrize("flags, cap, want", [
    (dict(), 32768, "ell"),
    (dict(), 16384, "dense"),
    (dict(is_using_geometry=0, is_using_intensity=1), 65536, "dense"),
    (dict(multiframe_ell_init=0.7), 32768, "ell"),
    (dict(multiframe_ell_init=0.8), 32768, "dense"),
], ids=["bench", "small", "no_geometry", "support_1.85m", "support_2.11m"])
def test_irls_backend_rule_matches_jax(flags, cap, want):
    """JAX's auto backend (irls.py:378-388), with JAX's own radius."""
    from unified_cvo_tpu.config import CvoParams as JaxParams

    jp = JaxParams(**flags)
    est = j_radius(jp.replace(ell_init=jp.multiframe_ell_init))
    assert ("ell" if jp.is_using_geometry and est <= 2.0 and cap >= 32768 else "dense") == want
    assert t_irls.resolve_irls_backend(_tp(jp), cap) == want
    assert t_irls.resolve_irls_backend(_tp(jp), cap, "dense") == "dense"


def test_point_covariances_device_matches_jax():
    """test_variants.py::test_point_covariances_tpu_matches_host's cloud:
    the port's device covariance against JAX's, masked rows zero."""
    rng = np.random.default_rng(7)
    n, valid = 512, 450
    xyz = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    mask = np.zeros(n, np.float32)
    mask[:valid] = 1.0
    cov_j, eig_j, deg_j = (np.asarray(v) for v in j_cov(xyz, mask, k=16, block=128))
    cov_t, eig_t, deg_t = t_cov.point_covariances_device(
        torch.from_numpy(xyz), torch.from_numpy(mask), k=16, block=128)
    np.testing.assert_allclose(cov_t.numpy(), cov_j, rtol=1e-4, atol=2e-6)
    np.testing.assert_allclose(eig_t.numpy(), eig_j, rtol=1e-4, atol=2e-6)
    assert np.array_equal(deg_t.numpy(), deg_j)
    assert np.abs(cov_t.numpy()[valid:]).max() == 0.0
    cov_h, eig_h, _ = t_cov.point_covariances(xyz[:valid], k=16)
    np.testing.assert_allclose(eig_t.numpy()[:valid], eig_h, atol=2e-5)
