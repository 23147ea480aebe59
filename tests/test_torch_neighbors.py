"""The PyTorch port's grid neighbor-list builder (ops/neighbors.py with the
plain version of the select kernel) against the JAX package's
build_neighbor_list, with both its sort path and its Pallas select kernel
(run in interpret mode, as tests/test_neighbors.py runs it).

Lists compare as per-row SETS (tie order may differ, pallas_select.py:16-20):
the per-row index sets, the valid count per row, the raw coordinates at
matched indices (exactly) and the overflow count (exactly).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unified_cvo_tpu.config import CvoParams as JaxParams
from unified_cvo_tpu.ops import lie as j_lie
from unified_cvo_tpu.ops import neighbors as j_nbr
from unified_cvo_tpu.utils.pointcloud import make_pointcloud as j_make
from unified_cvo_tpu_torch import convert
from unified_cvo_tpu_torch.ops import neighbors as t_nbr
from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud as t_make

torch.set_num_threads(1)


def _scene(rng, n=512, spread=12.0):
    return np.stack([rng.uniform(-spread, spread, n), rng.uniform(-2, 2, n),
                     rng.uniform(2, 50, n)], axis=1).astype(np.float32)


def _params(**kw):
    base = dict(ell_init=0.4, ell_min=0.05, ell_decay_rate=0.9,
                ell_decay_start=5, indicator_window_size=5,
                indicator_stable_threshold=0.2, max_step=0.1,
                sp_thres=0.0006, is_using_geometry=1)
    base.update(kw)
    jp = JaxParams(**base)
    return jp, convert.params_from_fields(dataclasses.asdict(jp))


def _pose():
    xi = np.array([0.004, -0.006, 0.003, 0.02, -0.01, 0.03], np.float32)
    R, t = j_lie.se3_exp(jnp.asarray(xi), 1.0)
    return np.array(R), np.array(t)


def _both_lists(xyz, xyz2, bucket, select, k=32, skin=0.3, per_cell_cap=8,
                pose=None):
    jp, tp = _params()
    R, T = _pose() if pose is None else pose
    ell = jp.ell_init
    nl_j = j_nbr.build_neighbor_list(
        jp, jnp.float32(ell), j_make(xyz, bucket=bucket), j_make(xyz2, bucket=bucket),
        jnp.asarray(R), jnp.asarray(T), k=k, skin=skin, per_cell_cap=per_cell_cap,
        select=select)
    nl_t = t_nbr.build_neighbor_list(
        tp, torch.tensor(ell), t_make(xyz, bucket=bucket, device="cpu"),
        t_make(xyz2, bucket=bucket, device="cpu"), torch.from_numpy(R),
        torch.from_numpy(T), k=k, skin=skin, per_cell_cap=per_cell_cap)
    return nl_j, nl_t


def _assert_same_list(nl_j, nl_t):
    idx_j, idx_t = np.asarray(nl_j.idx), nl_t.idx.numpy()
    y_j, y_t = np.asarray(nl_j.y_xyz), nl_t.y_xyz.numpy()
    assert idx_t.dtype == np.int32 and idx_t.shape == idx_j.shape
    np.testing.assert_array_equal(nl_t.valid.numpy(), idx_t >= 0)
    np.testing.assert_array_equal((idx_t >= 0).sum(0), (idx_j >= 0).sum(0))
    # per-row sets, with the raw coordinates carried along
    oj, ot = np.argsort(idx_j, axis=0), np.argsort(idx_t, axis=0)
    np.testing.assert_array_equal(np.take_along_axis(idx_t, ot, 0),
                                  np.take_along_axis(idx_j, oj, 0))
    for c in range(3):
        np.testing.assert_array_equal(np.take_along_axis(y_t[c], ot, 0),
                                      np.take_along_axis(y_j[c], oj, 0))
    assert int(nl_t.overflow) == int(nl_j.overflow)
    np.testing.assert_array_equal(nl_t.y_t_build.numpy(), np.asarray(nl_j.y_t_build))
    np.testing.assert_allclose(nl_t.pose_build.numpy(), np.asarray(nl_j.pose_build))
    np.testing.assert_allclose(float(nl_t.r_max_t), float(nl_j.r_max_t), rtol=1e-6)
    np.testing.assert_allclose(float(nl_t.k_lin), float(nl_j.k_lin), rtol=1e-6)


@pytest.mark.parametrize("per_cell_cap", [8, 24])
@pytest.mark.parametrize("select", ["sort", "kernel_interpret"])
def test_grid_builder_matches_jax(select, per_cell_cap):
    rng = np.random.default_rng(0)
    xyz = _scene(rng)
    xyz2 = _scene(rng) + np.float32([0.15, 0.0, 0.1])
    nl_j, nl_t = _both_lists(xyz, xyz2, 512, select, per_cell_cap=per_cell_cap)
    assert int((np.asarray(nl_j.idx) >= 0).sum()) > 0
    _assert_same_list(nl_j, nl_t)


@pytest.mark.parametrize("select", ["sort", "kernel_interpret"])
def test_grid_builder_dead_slots_match_jax(select):
    """400 points in a 512 bucket: masked source rows and padded targets
    leave dead slots (-1 / DEAD_COORD) on both sides."""
    rng = np.random.default_rng(1)
    xyz = _scene(rng, n=400)
    R, t = _pose()
    xyz2 = (xyz @ R.T + t).astype(np.float32)
    Rinv, Tinv = j_lie.invert_rt(jnp.asarray(R), jnp.asarray(t))
    nl_j, nl_t = _both_lists(xyz, xyz2, 512, select, per_cell_cap=24,
                             pose=(np.array(Rinv), np.array(Tinv)))
    _assert_same_list(nl_j, nl_t)
    dead = nl_t.idx.numpy() < 0
    assert dead[:, 400:].all()
    assert (nl_t.y_xyz.numpy()[:, dead] == t_nbr.DEAD_COORD).all()


def test_grid_builder_overflow_matches_jax():
    """A dense cloud saturates both the per-cell cap and K: the overflow
    count (dropped candidates) must agree exactly."""
    rng = np.random.default_rng(2)
    xyz = rng.uniform(-0.5, 0.5, (512, 3)).astype(np.float32)
    xyz[:, 2] += 5.0
    nl_j, nl_t = _both_lists(xyz, xyz + np.float32([0.02, 0, 0]), 512, "sort",
                             k=32, per_cell_cap=4, pose=(np.eye(3, dtype=np.float32),
                                                         np.zeros(3, np.float32)))
    assert int(nl_j.overflow) > 0
    _assert_same_list(nl_j, nl_t)


@pytest.mark.parametrize("multiple", [128, 384, 512])
def test_pad_cloud_to_multiple_matches_jax(multiple):
    from unified_cvo_tpu.ops import kernels as j_k
    from unified_cvo_tpu_torch.ops import kernels as t_k

    xyz = _scene(np.random.default_rng(6), n=300)
    feats = np.random.default_rng(7).uniform(0, 1, (300, 3)).astype(np.float32)
    j_pc = j_k.pad_cloud_to_multiple(j_make(xyz, features=feats, bucket=100), multiple)
    t_pc = t_k.pad_cloud_to_multiple(
        t_make(xyz, features=feats, bucket=100, device="cpu"), multiple)
    assert t_pc.capacity == j_pc.capacity and t_pc.capacity % multiple == 0
    for name in ("xyz", "mask", "features", "geometric_types"):
        np.testing.assert_array_equal(getattr(t_pc, name).numpy(),
                                      np.asarray(getattr(j_pc, name)))
    assert t_pc.labels is None and j_pc.labels is None


@pytest.mark.parametrize("scale", [0.0, 1e-3, 1e-2, 5e-2])
def test_drift_bound_matches_jax(scale):
    rng = np.random.default_rng(3)
    xyz = _scene(rng)
    nl_j, nl_t = _both_lists(xyz, xyz, 512, "sort")
    R, T = _pose()
    xi = scale * np.array([0.5, -1.0, 0.3, 4.0, 2.0, -3.0], np.float32)
    dR, dT = j_lie.se3_exp(jnp.asarray(xi), 1.0)
    R2 = np.array(dR) @ R
    T2 = np.array(dR) @ T + np.array(dT)
    got = bool(t_nbr.drift_bound_exceeded(nl_t, torch.from_numpy(R2),
                                          torch.from_numpy(T2), 0.3))
    want = bool(j_nbr.drift_bound_exceeded(nl_j, jnp.asarray(R2), jnp.asarray(T2), 0.3))
    assert got == want
    assert got == (scale >= 1e-2)


def test_plain_consume_passes_match_jax():
    """kernel_slots / flow_stats_ell / step_coeffs_ell (the JAX package's
    jnp consume twins) on one list carried across with convert.py."""
    from unified_cvo_tpu.ops import kernels as j_k
    from unified_cvo_tpu_torch.ops import kernels as t_k

    rng = np.random.default_rng(4)
    jp, tp = _params()
    xyz = _scene(rng, n=400)
    R, t = _pose()
    xyz2 = (xyz @ R.T + t + 0.05).astype(np.float32)
    src = j_make(xyz, bucket=512)
    Rinv, Tinv = j_lie.invert_rt(jnp.asarray(R), jnp.asarray(t))
    ell = jnp.float32(jp.ell_init)
    nl = j_nbr.build_neighbor_list(jp, ell, src, j_make(xyz2, bucket=512), Rinv,
                                   Tinv, k=32, skin=0.3, per_cell_cap=24)
    nl_t = convert.neighbor_list_from_numpy(
        **{f: np.asarray(getattr(nl, f)) for f in (
            "idx", "valid", "y_xyz", "y_t_build", "overflow", "pose_build",
            "r_max_t", "ell_build", "k_lin")}, device="cpu")
    src_t = convert.pointcloud_from_numpy(np.asarray(src.xyz), np.asarray(src.mask),
                                          device="cpu")
    tR, tT = torch.from_numpy(np.array(Rinv)), torch.from_numpy(np.array(Tinv))
    st_t, a_t, yts_t = t_nbr.flow_stats_ell(tp, torch.tensor(jp.ell_init), src_t, nl_t, tR, tT)
    st_j, a_j, yts_j = j_nbr.flow_stats_ell(jp, ell, src, nl, Rinv, Tinv)
    assert int(st_t.nonzeros) == int(st_j.nonzeros) > 0
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(st_t.a_sum), float(st_j.a_sum), rtol=1e-5)
    tw_t, jn_t = t_k.flow_from_stats(tp, src_t, st_t)
    tw_j, jn_j = j_k.flow_from_stats(jp, src, st_j)
    np.testing.assert_allclose(float(jn_t), float(jn_j), rtol=1e-4)
    np.testing.assert_allclose(tw_t.numpy(), np.asarray(tw_j), atol=1e-4)
    got = t_nbr.step_coeffs_ell(tp, torch.tensor(jp.ell_init), src_t, a_t, yts_t, tw_t)
    want = j_nbr.step_coeffs_ell(jp, ell, src, a_j, yts_j, tw_j)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-3, atol=1e-4)
