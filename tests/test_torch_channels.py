"""The port's channel factor and scan builder (ops/neighbors.py) against the
JAX package on the same numpy inputs:

* `nl.chan` of the grid builder for intensity, semantics (4 one-hot
  classes), geometric types and all three together: the nonzero pattern
  equal and the values to rtol 1e-6, compared per row over the matched
  target indices (slot order may differ on ties, pallas_select.py:16-20);
* `build_neighbor_list_scan` with geometry on (the fixture of
  test_neighbors.py::test_scan_builder_matches_grid_builder) and off (the
  fixture of test_align_scan_no_geometry_channel): per-row index sets,
  overflow, raw coordinates and the channel factor;
* the plain consume passes `kernel_slots` / `flow_stats_ell` on a list with
  a channel factor, carried across with convert.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unified_cvo_tpu.ops import lie as j_lie
from unified_cvo_tpu.ops import neighbors as j_nbr
from unified_cvo_tpu.utils.pointcloud import make_pointcloud as j_make
from unified_cvo_tpu_torch import convert
from unified_cvo_tpu_torch.ops import neighbors as t_nbr
from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud as t_make

from test_torch_neighbors import _params, _scene

torch.set_num_threads(1)

NL_FIELDS = ("idx", "valid", "y_xyz", "y_t_build", "overflow", "pose_build",
             "r_max_t", "ell_build", "k_lin", "chan")


def _clouds(xyz, bucket, **fields):
    return (j_make(xyz, bucket=bucket, **fields),
            t_make(xyz, bucket=bucket, device="cpu", **fields))


def _row_sorted(nl_idx, *fields):
    """Each [.., K, N] field reordered so that every row (column n) runs in
    ascending target index: per-row sets compare element by element."""
    order = np.argsort(nl_idx, axis=0, kind="stable")
    out = [np.take_along_axis(nl_idx, order, 0)]
    for f in fields:
        f = np.asarray(f)
        out.append(np.take_along_axis(f, np.broadcast_to(order, f.shape), -2))
    return out


def _assert_same_lists(nl_j, nl_t, with_chan):
    idx_j, y_j, *c_j = _row_sorted(np.asarray(nl_j.idx), np.asarray(nl_j.y_xyz),
                                   *([np.asarray(nl_j.chan)] if with_chan else []))
    idx_t, y_t, *c_t = _row_sorted(nl_t.idx.numpy(), nl_t.y_xyz.numpy(),
                                   *([nl_t.chan.numpy()] if with_chan else []))
    assert nl_t.idx.dtype == torch.int32 and nl_t.idx.shape == nl_j.idx.shape
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_array_equal(y_t, y_j)
    np.testing.assert_array_equal(nl_t.valid.numpy(), nl_t.idx.numpy() >= 0)
    assert int(nl_t.overflow) == int(nl_j.overflow)
    if with_chan:
        assert nl_t.chan.shape == nl_t.idx.shape and nl_t.chan.dtype == torch.float32
        np.testing.assert_array_equal(c_t[0] > 0, c_j[0] > 0)
        np.testing.assert_allclose(c_t[0], c_j[0], rtol=1e-6, atol=0)
    else:
        assert nl_t.chan is None and nl_j.chan is None


CHANNEL_SETS = {
    "intensity": dict(is_using_intensity=1, c_ell=0.5, c_sigma=1.0),
    "semantics": dict(is_using_semantics=1, s_ell=0.6, s_sigma=1.0),
    "geometric_types": dict(is_using_geometric_type=1),
    "all": dict(is_using_intensity=1, c_ell=0.5, c_sigma=1.0, is_using_semantics=1,
                s_ell=0.6, s_sigma=1.0, is_using_geometric_type=1),
}


def _channel_fields(rng, n):
    return dict(features=rng.uniform(0, 1, (n, 3)).astype(np.float32),
                labels=np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)],
                geometric_types=rng.normal(size=(n, 2)).astype(np.float32))


@pytest.mark.parametrize("channels", list(CHANNEL_SETS))
def test_grid_builder_channel_factor_matches_jax(channels):
    """400 points in a 512 bucket (dead slots, masked rows), every target of
    a source row's support kept (K 64, 24 per cell), at a pose between."""
    rng = np.random.default_rng(0)
    n = 400
    xyz = _scene(rng, n)
    fields = _channel_fields(rng, n)
    xi = np.array([0.002, 0.005, -0.001, 0.05, 0.02, 0.4], np.float32)
    R_m, t_m = j_lie.se3_exp(jnp.asarray(xi), 1.0)
    xyz2 = np.asarray(xyz @ np.asarray(R_m).T + np.asarray(t_m))
    jp, tp = _params(**CHANNEL_SETS[channels])
    js, ts = _clouds(xyz, 512, **fields)
    jt, tt = _clouds(xyz2, 512, **fields)
    R_h, t_h = j_lie.se3_exp(jnp.asarray(0.5 * xi), 1.0)
    Rinv, Tinv = j_lie.invert_rt(R_h, t_h)
    nl_j = j_nbr.build_neighbor_list(jp, jnp.float32(jp.ell_init), js, jt, Rinv, Tinv,
                                     k=64, skin=0.3, per_cell_cap=24)
    nl_t = t_nbr.build_neighbor_list(tp, torch.tensor(jp.ell_init), ts, tt,
                                     torch.from_numpy(np.array(Rinv)),
                                     torch.from_numpy(np.array(Tinv)),
                                     k=64, skin=0.3, per_cell_cap=24)
    _assert_same_lists(nl_j, nl_t, with_chan=True)
    chan = nl_t.chan.numpy()
    # gates fold in as exact zeros: dead slots, masked rows, and (for a
    # gated channel) some live slots
    assert (chan[nl_t.idx.numpy() < 0] == 0).all() and (chan[:, n:] == 0).all()
    assert 0 < int((chan > 0).sum()) <= int(nl_t.valid.sum())


def test_grid_builder_without_channels_has_no_factor():
    rng = np.random.default_rng(1)
    xyz = _scene(rng, 256)
    jp, tp = _params()
    nl = t_nbr.build_neighbor_list(tp, torch.tensor(jp.ell_init),
                                   t_make(xyz, bucket=256, device="cpu"),
                                   t_make(xyz, bucket=256, device="cpu"),
                                   torch.eye(3), torch.zeros(3), k=32)
    assert nl.chan is None


@pytest.mark.parametrize("chunk", [1024, 4096], ids=["4_chunks", "1_chunk"])
def test_scan_builder_with_geometry_matches_jax(chunk):
    """test_neighbors.py::test_scan_builder_matches_grid_builder's setup."""
    rng = np.random.default_rng(0)
    jp, tp = _params()
    xyz = _scene(rng, 4096)
    xyz2 = _scene(rng, 4096) + np.float32([0.1, 0.0, 0.2])
    js, ts = _clouds(xyz, 512)
    jt, tt = _clouds(xyz2, 512)
    ell = jp.ell_init
    nl_j = j_nbr.build_neighbor_list_scan(jp, jnp.float32(ell), js, jt, jnp.eye(3),
                                          jnp.zeros(3), k=192, skin=0.3, chunk=chunk)
    nl_t = t_nbr.build_neighbor_list_scan(tp, torch.tensor(ell), ts, tt, torch.eye(3),
                                          torch.zeros(3), k=192, skin=0.3, chunk=chunk)
    assert int(nl_j.overflow) == 0 and int(nl_j.valid.sum()) > 0
    _assert_same_lists(nl_j, nl_t, with_chan=False)
    np.testing.assert_array_equal(nl_t.y_t_build.numpy(), np.asarray(nl_j.y_t_build))
    np.testing.assert_allclose(float(nl_t.r_max_t), float(nl_j.r_max_t), rtol=1e-6)
    np.testing.assert_allclose(float(nl_t.k_lin), float(nl_j.k_lin), rtol=1e-6)


def _no_geometry_case(rng):
    """test_neighbors.py::test_align_scan_no_geometry_channel's setup."""
    jp, tp = _params(is_using_geometry=0, is_using_intensity=1, c_ell=0.3,
                     c_sigma=1.0, sp_thres=0.01, max_step=0.02)
    xyz = _scene(rng, 512, spread=4.0)
    feats = rng.uniform(0, 1, (512, 3)).astype(np.float32)
    xi = np.array([0.0, 0.002, -0.001, 0.02, 0.01, 0.05], np.float32)
    R_m, t_m = j_lie.se3_exp(jnp.asarray(xi), 1.0)
    xyz2 = np.asarray(xyz @ np.asarray(R_m).T + np.asarray(t_m))
    return jp, tp, xyz, xyz2, feats, xi


@pytest.mark.parametrize("k", [512, 64], ids=["k512_exact", "k64_capped"])
def test_scan_builder_without_geometry_matches_jax(k):
    """Candidates ranked by the channel kernel value, strongest first; with
    K 64 the cap binds on every row and the overflow counts the rest."""
    jp, tp, xyz, xyz2, feats, _ = _no_geometry_case(np.random.default_rng(0))
    js, ts = _clouds(xyz, 512, features=feats)
    jt, tt = _clouds(xyz2, 512, features=feats)
    ell = jp.ell_init
    nl_j = j_nbr.build_neighbor_list_scan(jp, jnp.float32(ell), js, jt, jnp.eye(3),
                                          jnp.zeros(3), k=k)
    nl_t = t_nbr.build_neighbor_list_scan(tp, torch.tensor(ell), ts, tt, torch.eye(3),
                                          torch.zeros(3), k=k)
    assert (int(nl_j.overflow) > 0) == (k == 64)
    _assert_same_lists(nl_j, nl_t, with_chan=True)


def test_plain_consume_passes_with_channels_match_jax():
    """kernel_slots / flow_stats_ell with nl.chan (the JAX package's jnp
    twins) on one list carried across with convert.py."""
    rng = np.random.default_rng(4)
    jp, tp = _params(**CHANNEL_SETS["all"])
    n = 400
    xyz = _scene(rng, n)
    fields = _channel_fields(rng, n)
    xyz2 = (xyz + 0.05).astype(np.float32)
    js = j_make(xyz, bucket=512, **fields)
    ell = jnp.float32(jp.ell_init)
    I3, z3 = jnp.eye(3), jnp.zeros(3)
    nl = j_nbr.build_neighbor_list(jp, ell, js, j_make(xyz2, bucket=512, **fields), I3, z3,
                                   k=32, skin=0.3, per_cell_cap=24)
    nl_t = convert.neighbor_list_from_numpy(
        **{f: np.asarray(getattr(nl, f)) for f in NL_FIELDS}, device="cpu")
    assert nl_t.chan is not None
    src_t = convert.pointcloud_from_numpy(np.asarray(js.xyz), np.asarray(js.mask),
                                          device="cpu")
    st_t, a_t, _ = t_nbr.flow_stats_ell(tp, torch.tensor(jp.ell_init), src_t, nl_t,
                                        torch.eye(3), torch.zeros(3))
    st_j, a_j, _ = j_nbr.flow_stats_ell(jp, ell, js, nl, I3, z3)
    assert int(st_t.nonzeros) == int(st_j.nonzeros) > 0
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(st_t.a_sum), float(st_j.a_sum), rtol=1e-5)
    np.testing.assert_allclose(st_t.row_wy.numpy(), np.asarray(st_j.row_wy),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("ell_init, want_grid", [(0.5, True), (0.15, True), (5.0, False)])
def test_static_support_radius_matches_jax(ell_init, want_grid):
    jp, tp = _params(ell_init=ell_init)
    r = t_nbr.static_support_radius(tp)
    assert r == pytest.approx(j_nbr.static_support_radius(jp), rel=1e-12)
    assert (r <= 2.0) == want_grid
