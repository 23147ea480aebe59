"""The SLAM back end's port (models/{posegraph,bki,keyframe}.py and the
convert.py carries) against the JAX package on the CPU: the counterparts of
test_posegraph_bki.py.

Pose graph: the dense, CG and Huber-reweighted solves of the 200-keyframe
loop, the windowed graph's marginal prior (H and b within 1e-4 of their
largest entry), incremental mode on 200 keyframes (gated on the size of the
active subgraph, not on wall-clock ratios); poses within 1e-4 of JAX's.

BKI: inserts with labels, without labels and with free rays. Both packages
decide a voxel at the kernel's support edge on the sign of a weight that is
float32 cancellation noise (k ~ (1 - d/l)^5 there), and their cos differ in
the last bit, so some edge voxels exist on one side only: those must carry
negligible evidence (|alpha - prior| < 1e-4, test_posegraph_bki.py's own
rule). Shared voxels agree within rtol 1e-5 plus JAX's own error bound: JAX
sums a voxel as the difference of two float32 prefix sums over the whole
chunk (bki.py _segment_rows_sum), off by up to ~2^-23 of the chunk's total
evidence; the port sums each voxel in float64. Against a float64
brute-force oracle the port holds rtol 1e-5, atol 1e-6. Semantics agree
where the top two alphas are apart by more than 1e-4 relative; `query`
agrees at the inserted points, on the rays and off the map.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unified_cvo_tpu.models import bki as j_bki
from unified_cvo_tpu.models import keyframe as j_kf
from unified_cvo_tpu.models import posegraph as j_pg
from unified_cvo_tpu.ops import lie as j_lie
from unified_cvo_tpu.utils.pointcloud import make_pointcloud as j_make_pointcloud
from unified_cvo_tpu_torch import convert
from unified_cvo_tpu_torch.models import bki as t_bki
from unified_cvo_tpu_torch.models import keyframe as t_kf
from unified_cvo_tpu_torch.models import posegraph as t_pg
from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud, to_numpy_valid

torch.set_num_threads(1)

CPU = "cpu"
POSE_TOL = 1e-4
EDGE_EVIDENCE = 1e-4


def _rand_se3(rng, scale):
    xi = scale * rng.normal(size=6).astype(np.float32)
    R, t = (np.asarray(v) for v in j_lie.se3_exp(jnp.asarray(xi), 1.0))
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


# ------------------------------------------------------------------ pose graph


@pytest.fixture(scope="module")
def loop_200():
    """test_posegraph_bki.py's 200-keyframe loop: noisy odometry, three
    exact closures, poses initialised by composing the odometry."""
    rng = np.random.default_rng(0)
    F = 200
    true = [np.eye(4)]
    for _ in range(F - 1):
        true.append(true[-1] @ _rand_se3(rng, 0.2))
    Zs, fi, fj = [], [], []
    for k in range(F - 1):
        Zs.append(np.linalg.inv(true[k]) @ true[k + 1] @ _rand_se3(rng, 0.01))
        fi.append(k)
        fj.append(k + 1)
    for a, b in ((0, F - 1), (0, F // 2), (F // 2, F - 1)):
        Zs.append(np.linalg.inv(true[a]) @ true[b])
        fi.append(a)
        fj.append(b)
    init = [np.eye(4)]
    for k in range(F - 1):
        init.append(init[-1] @ Zs[k])
    fixed = np.zeros(F, np.float32)
    fixed[0] = 1.0
    return (np.stack(init).astype(np.float32), np.asarray(fi), np.asarray(fj),
            np.stack(Zs).astype(np.float32), np.ones(len(Zs), np.float32), fixed, true)


@pytest.mark.parametrize("solver,robust", [("dense", None), ("cg", None), ("dense", 0.05)])
def test_optimize_pose_graph_matches_jax(solver, robust, loop_200):
    init, fi, fj, Z, w, fixed, true = loop_200
    out_j, dn_j = j_pg.optimize_pose_graph(
        jnp.asarray(init), jnp.asarray(fi, jnp.int32), jnp.asarray(fj, jnp.int32),
        jnp.asarray(Z), jnp.asarray(w), jnp.asarray(fixed), iters=15, solver=solver,
        robust_delta=robust)
    out_t, dn_t = t_pg.optimize_pose_graph(init, fi, fj, Z, w, fixed, iters=15, solver=solver,
                                           robust_delta=robust, device=CPU)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(out_t.numpy()[0], np.eye(4), atol=1e-6)   # gauge held
    drift_before = np.linalg.norm(init[-1][:3, 3] - true[-1][:3, 3])
    drift_after = np.linalg.norm(out_t.numpy()[-1][:3, 3] - true[-1][:3, 3])
    assert drift_after < drift_before * 0.2 + 1e-3, (drift_before, drift_after)


def _windowed(mod, seed, window, n_kf=14, stop=None, pg=None):
    """test_posegraph_bki.py's windowed SLAM run: a noisy circle with
    odometry and skip-2 factors; `stop` ends after that many keyframes,
    `pg` continues a given graph."""
    rng = np.random.default_rng(seed)
    true = [np.eye(4)]
    step = np.eye(4)
    th = 2 * np.pi / n_kf
    step[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                             [-np.sin(th), 0, np.cos(th)]])
    step[:3, 3] = [0.0, 0.0, 1.0]
    for _ in range(n_kf - 1):
        true.append(true[-1] @ step)
    noise = [(_rand_se3(rng, 0.01), _rand_se3(rng, 0.03)) for _ in range(n_kf)]
    kw = {} if mod is j_pg else {"device": CPU}
    if pg is None:
        pg = mod.PoseGraph(mod.PoseGraphConfig(keyframe_function_angle_threshold=0.5,
                                               window_size=window, optimize_iters=8), **kw)
        pg.add_first_frame(0)
    for k in range(pg.num_keyframes, n_kf if stop is None else stop):
        extra = []
        if k >= 2:
            extra.append(mod.RelativePose(curr_id=k, ref_id=k - 2, inner_product=0.3,
                                          transform=np.linalg.inv(true[k - 2]) @ true[k]
                                          @ noise[k][0]))
        pg.add_frame(k, np.linalg.inv(true[k - 1]) @ true[k] @ noise[k][1],
                     function_angle=0.2, extra_factors=extra)
    return pg


def _graphs_agree(pt, pj):
    assert pt.num_keyframes == pj.num_keyframes and pt.window_lo == pj.window_lo
    for a, b in zip(pt.keyframe_poses, pj.keyframe_poses):
        np.testing.assert_allclose(a, b, rtol=0, atol=POSE_TOL)
    assert (pt.prior is None) == (pj.prior is None)
    if pj.prior is not None:
        assert pt.prior["ids"] == pj.prior["ids"]
        for key in ("H", "b"):
            scale = np.abs(pj.prior[key]).max()
            np.testing.assert_allclose(pt.prior[key], pj.prior[key], rtol=1e-4,
                                       atol=1e-4 * scale)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_windowed_marginalization_matches_jax(seed):
    pj = _windowed(j_pg, seed, window=5)
    pt = _windowed(t_pg, seed, window=5)
    assert pj.prior is not None and len(pj.prior["ids"]) >= 1
    _graphs_agree(pt, pj)


def _incremental(mod, F=200):
    rng = np.random.default_rng(5)
    kw = {} if mod is j_pg else {"device": CPU}
    pg = mod.PoseGraph(mod.PoseGraphConfig(incremental=True,
                                           keyframe_function_angle_threshold=1.0,
                                           optimize_iters=4), **kw)
    pg.add_first_frame(0)
    step = np.eye(4)
    step[:3, 3] = [0.0, 0.0, 0.4]
    active = []
    for k in range(1, F):
        noisy = step.copy()
        noisy[:3, 3] += rng.normal(0, 0.01, 3)
        extra = None
        if k % 25 == 0:
            rel = np.eye(4)
            rel[:3, 3] = 2 * step[:3, 3]
            extra = [mod.RelativePose(curr_id=k, ref_id=k - 2, transform=rel,
                                      inner_product=0.5)]
        pg.add_frame(k, noisy, function_angle=0.5, extra_factors=extra)
        active.append(getattr(pg, "last_active", 0))
    return pg, active


def test_incremental_mode_matches_jax_on_bounded_subgraphs():
    """The iSAM2-analogue mode: every optimize() solves a subgraph whose
    size does not grow with the trajectory (the same bound early and late),
    and the poses follow JAX's."""
    pj, _ = _incremental(j_pg)
    pt, active = _incremental(t_pg)
    for a, b in zip(pt.keyframe_poses, pj.keyframe_poses):
        np.testing.assert_allclose(a, b, rtol=0, atol=POSE_TOL)
    assert max(active) <= 8, max(active)
    assert max(active[-50:]) == max(active[:50])


def test_pose_graph_carries_from_jax():
    """A JAX graph stopped after 9 keyframes (window slid, prior set),
    carried over by convert.pose_graph_from_numpy and continued in the port,
    equals JAX continuing it."""
    pj = _windowed(j_pg, 3, window=5, stop=9)
    pt = convert.pose_graph_from_numpy(
        dataclasses.asdict(pj.config), pj.keyframe_poses, pj.keyframe_ids, pj.factors,
        pj.window_lo, pj.prior, trajectory=pj.trajectory, device=CPU)
    _graphs_agree(pt, pj)
    _windowed(j_pg, 3, window=5, pg=pj)
    _windowed(t_pg, 3, window=5, pg=pt)
    assert len(pt.trajectory) == len(pj.trajectory) == 14
    _graphs_agree(pt, pj)


def test_online_keyframing():
    pg = t_pg.PoseGraph(t_pg.PoseGraphConfig(keyframe_function_angle_threshold=0.6),
                        device=CPU)
    pg.add_first_frame(0)
    T = np.eye(4)
    T[0, 3] = 0.1
    assert not pg.add_frame(1, T, function_angle=0.9)
    assert pg.num_keyframes == 1
    assert pg.add_frame(2, T, function_angle=0.3)
    assert pg.num_keyframes == 2 and len(pg.trajectory) == 3


# ------------------------------------------------------------------------ BKI


def _jax_state(m):
    m._sync_host()
    return m._keys, m._alpha


def _maps_agree(keys_t, alpha_t, keys_r, alpha_r, prior, atol, rtol=1e-5,
                edge=EDGE_EVIDENCE):
    """Voxels on one side only carry negligible evidence; shared voxels agree
    within rtol plus atol; the top class agrees where the top two alphas are
    apart by more than 1e-4 relative and by more than twice atol. Returns
    the shared voxel count."""
    common, it, ir = np.intersect1d(keys_t, keys_r, return_indices=True)
    for keys, alpha, other in ((keys_t, alpha_t, keys_r), (keys_r, alpha_r, keys_t)):
        only = np.isin(keys, other, invert=True)
        if only.any():
            assert (alpha[only] - prior).max() < edge, (alpha[only] - prior).max()
    at, ar = alpha_t[it], alpha_r[ir]
    np.testing.assert_allclose(at, ar, rtol=rtol, atol=atol)
    top2 = np.sort(ar, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0] > np.maximum(1e-4 * top2[:, 1], 2 * atol))
    np.testing.assert_array_equal(at.argmax(1)[clear], ar.argmax(1)[clear])
    assert len(common) > 0.99 * max(len(keys_t), len(keys_r))
    return len(common)


def _exports_agree(mt, mj, atol):
    """export_occupied of both sides: every voxel that carries evidence
    (more than EDGE_EVIDENCE over the prior) and whose top two alphas are
    apart by more than 1e-4 relative and twice atol is exported by both or
    by neither, with the same centre and class. The others (an edge voxel
    whose noise-level weights rounded away on one side, a voxel whose free
    and occupied evidence are within the tolerance) may differ."""
    kj, aj = _jax_state(mj)
    kt, at = mt.keys.numpy(), mt.alpha.numpy()
    common, it, ij = np.intersect1d(kt, kj, return_indices=True)
    a = aj[ij]
    top2 = np.sort(a, axis=1)[:, -2:]
    sure = (((a - mt.prior).max(1) > EDGE_EVIDENCE)
            & (top2[:, 1] - top2[:, 0] > np.maximum(1e-4 * top2[:, 1], 2 * atol)))
    res = mt.resolution

    def exported(e):
        c, sem, _ = e
        return dict(zip(j_bki._pack_keys(np.floor(c / res).astype(np.int64)).tolist(),
                        sem.tolist()))

    et, ej = exported(mt.export_occupied()), exported(mj.export_occupied())
    for key in common[sure].tolist():
        assert et.get(key) == ej.get(key), key
    assert sum(k in ej for k in common[sure].tolist()) > 10


def _jax_bound(m_t):
    """JAX's float32 prefix-difference bound: 2^-23 of the total evidence
    (the port's map holds it: the sum of alpha less the priors)."""
    total = float((m_t.alpha.double() - m_t.prior).sum())
    return 2.0 ** -23 * total


def _oracle(pos, ev, res, ell, sigma0, prior):
    """Float64 brute force over every point and kernel offset: (keys,
    alpha) with the float32 voxel floor both packages use."""
    reach = int(np.ceil(ell / res))
    offs = t_bki._kernel_offsets(reach, res, ell)
    base = np.floor(pos.astype(np.float32) / np.float32(res)).astype(np.int64)
    vox = base[:, None, :] + offs[None]
    d = np.linalg.norm((vox + 0.5) * res - pos.astype(np.float32)[:, None, :], axis=-1)
    w = j_bki.sparse_kernel(d, ell, sigma0)
    p, o = np.nonzero(w > 0)
    keys = j_bki._pack_keys(vox[p, o])
    uk, inv = np.unique(keys, return_inverse=True)
    alpha = np.full((len(uk), ev.shape[1]), prior)
    np.add.at(alpha, inv, w[p, o, None] * ev[p])
    return uk, alpha


@pytest.mark.parametrize("labelled", [True, False], ids=["labels", "no_labels"])
def test_bki_occupied_insert_matches_jax_and_oracle(labelled):
    rng = np.random.default_rng(0)
    res, ell, C = 0.1, 0.2, 3
    pos = rng.uniform(-0.8, 0.8, (200, 3))
    labels = np.eye(C + 1)[rng.integers(1, C + 1, 200)][:, 1:] if labelled else None
    mj = j_bki.SemanticBKIMap(resolution=res, num_classes=C, ell=ell)
    mt = t_bki.SemanticBKIMap(resolution=res, num_classes=C, ell=ell, device=CPU)
    mj.insert_pointcloud(pos, labels)
    mt.insert_pointcloud(pos, labels)
    kt, at = mt.keys.numpy(), mt.alpha.numpy()
    assert np.all(kt[1:] > kt[:-1])
    kj, aj = _jax_state(mj)
    _maps_agree(kt, at, kj, aj, mt.prior, atol=_jax_bound(mt))
    ev = np.zeros((200, C + 1))
    if labelled:
        ev[:, 1:] = labels
    else:
        ev[:, 1] = 1.0
    ko, ao = _oracle(pos, ev, res, ell, mt.sigma0, mt.prior)
    _maps_agree(kt, at, ko, ao, mt.prior, atol=1e-6, edge=1e-6)
    q = np.concatenate([pos, rng.uniform(5, 6, (10, 3))])
    for a, b in zip(mt.query(q), mj.query(q)):
        np.testing.assert_array_equal(a, b)


def test_bki_free_rays_and_second_insert_match_jax():
    """A labelled wall seen from two origins: occupied evidence, free-space
    samples along every ray (free_resolution 0.5), and the merge of a second
    insert into the map."""
    rng = np.random.default_rng(1)
    C = 4
    maps = (j_bki.SemanticBKIMap(resolution=0.1, num_classes=C, ell=0.2),
            t_bki.SemanticBKIMap(resolution=0.1, num_classes=C, ell=0.2, device=CPU))
    for origin in (np.zeros(3), np.array([0.3, -0.1, 0.2])):
        pts = np.stack([rng.uniform(-0.5, 0.5, 300), rng.uniform(-0.5, 0.5, 300),
                        np.full(300, 2.0) + rng.normal(0, 0.01, 300)], 1)
        labels = rng.dirichlet(np.ones(C), 300)
        for m in maps:
            m.insert_pointcloud(pts, labels, origin=origin)
    mj, mt = maps
    kj, aj = _jax_state(mj)
    _maps_agree(mt.keys.numpy(), mt.alpha.numpy(), kj, aj, mt.prior, atol=_jax_bound(mt))
    assert (mt.alpha.numpy().argmax(1) == 0).sum() > 100      # free voxels on the rays
    q = np.concatenate([pts, np.array([[0.0, 0.0, 1.0], [0.1, 0.0, 0.5], [5.0, 5.0, 5.0]])])
    st, sj = mt.query(q), mj.query(q)
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a, b)
    assert st[0][-3] == -1 and st[0][-1] == 0
    _exports_agree(mt, mj, _jax_bound(mt))
    assert len(mt) == len(mt.keys)


def test_bki_inserts_are_bit_equal_and_empty_query():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, (500, 3)) + [0, 0, 3]
    labels = rng.dirichlet(np.ones(5), 500)
    a = t_bki.SemanticBKIMap(num_classes=5, device=CPU)
    b = t_bki.SemanticBKIMap(num_classes=5, device=CPU)
    states, sems = a.query(np.array([[0.0, 0.0, 0.0], [1.0, 2.0, 3.0]]))
    assert (states == 0).all() and (sems == 0).all()
    for m in (a, b):
        m.insert_pointcloud(pts, labels, origin=np.zeros(3))
    assert torch.equal(a.keys, b.keys) and torch.equal(a.alpha, b.alpha)


def test_bki_map_carries_from_jax():
    """A JAX map after one insert, carried over by convert.bki_map_from_numpy
    and continued in the port, agrees with JAX continuing it."""
    rng = np.random.default_rng(3)
    C = 3
    kw = dict(resolution=0.1, num_classes=C, ell=0.2, sigma0=1.0, prior=0.001,
              free_resolution=0.5)
    mj = j_bki.SemanticBKIMap(**kw)
    mj.insert_pointcloud(rng.uniform(-0.5, 0.5, (150, 3)) + [0, 0, 2],
                         rng.dirichlet(np.ones(C), 150), origin=np.zeros(3))
    kj, aj = _jax_state(mj)
    mt = convert.bki_map_from_numpy(kj, aj, device=CPU, **kw)
    assert len(mt) == len(mj)
    pts = rng.uniform(-0.5, 0.5, (150, 3)) + [0.2, 0, 2.1]
    labels = rng.dirichlet(np.ones(C), 150)
    mj.insert_pointcloud(pts, labels, origin=np.array([0.1, 0, 0]))
    mt.insert_pointcloud(pts, labels, origin=np.array([0.1, 0, 0]))
    kj, aj = _jax_state(mj)
    _maps_agree(mt.keys.numpy(), mt.alpha.numpy(), kj, aj, mt.prior, atol=_jax_bound(mt))


def test_keyframe_local_map_roundtrip_matches_jax():
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-1, 1, (100, 3)).astype(np.float32) + [0, 0, 3]
    labels = np.tile(np.eye(5, dtype=np.float32)[3][None, :], (100, 1))
    kj = j_kf.Keyframe(0, j_make_pointcloud(xyz, labels=labels, bucket=64))
    kt = t_kf.Keyframe(0, make_pointcloud(xyz, labels=labels, bucket=64, device=CPU))
    for k in (kj, kt):
        k.construct_map(resolution=0.2, num_classes=5, ell=0.3)
    other = rng.uniform(-1, 1, (100, 3)).astype(np.float32) + [0.2, 0, 3]
    pose = np.eye(4)
    pose[:3, 3] = [0.05, 0.0, -0.1]
    kj.add_points_from(j_kf.Keyframe(1, j_make_pointcloud(other, labels=labels, bucket=64),
                                     pose=pose))
    kt.add_points_from(t_kf.Keyframe(1, make_pointcloud(other, labels=labels, bucket=64,
                                                        device=CPU), pose=pose))
    kjs, ajs = _jax_state(kj.local_map)
    _maps_agree(kt.local_map.keys.numpy(), kt.local_map.alpha.numpy(), kjs, ajs,
                kt.local_map.prior, atol=_jax_bound(kt.local_map))
    _exports_agree(kt.local_map, kj.local_map, _jax_bound(kt.local_map))
    data = to_numpy_valid(kt.export_points_from_map())
    assert len(data["xyz"]) > 10
    # weakly-touched boundary voxels may stay prior-uniform; the bulk must
    # carry the inserted class
    assert (data["labels"].argmax(1) == 3).mean() > 0.9
