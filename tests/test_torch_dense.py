"""The port's dense passes against the JAX package on identical numpy clouds:

* ops/kernels.py's blocked plain passes (the 'jnp' backend) against
  unified_cvo_tpu/ops/kernels.py on the four channel sets of
  tests/test_pallas.py;
* ops/dense.py's packing and tile compaction against
  unified_cvo_tpu/ops/pallas_kernels.py's;
* the plain versions of the dense tiled kernels against the Pallas kernels
  in interpret mode (small clouds, tiles 16 x 32), on full, culled and
  all-culled tile masks.

Tolerances are test_pallas.py's: row_sum rtol 1e-5 atol 1e-7, row_wy rtol
1e-5 atol 1e-6, nonzeros exact, a_sum rtol 1e-5, B..E rtol 2e-4 atol 1e-6
(f32 sums reassociate); packed matrices allclose at 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unified_cvo_tpu.config import CvoParams as JaxParams
from unified_cvo_tpu.ops import kernels as j_kernels
from unified_cvo_tpu.ops import pallas_kernels as pk
from unified_cvo_tpu.utils.pointcloud import make_pointcloud as j_make
from unified_cvo_tpu_torch import convert
from unified_cvo_tpu_torch.ops import cuda_lib
from unified_cvo_tpu_torch.ops import dense as t_dense
from unified_cvo_tpu_torch.ops import kernels as t_kernels
from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud as t_make

from test_kernels import _random_clouds

torch.set_num_threads(1)

FLAGS = [
    dict(is_using_geometry=1),
    dict(is_using_geometry=1, is_using_intensity=1),
    dict(is_using_geometry=1, is_using_intensity=1, is_using_semantics=1,
         is_using_geometric_type=1),
    dict(is_using_geometry=1, is_using_range_ell=1),
]
FLAG_IDS = ["geometry", "intensity", "all_channels", "range_ell"]
TI, TJ = 16, 32


def _setup(flags, seed=0, n=70, m=90):
    """JAX and port params and clouds (bucket 8: padding rows) from one seed."""
    jp = JaxParams(sp_thres=0.002).replace(**flags)
    tp = convert.params_from_fields(dataclasses.asdict(jp))
    rng = np.random.default_rng(seed)
    x, y, kw_x, kw_y = _random_clouds(
        rng, n=n, m=m, features="is_using_intensity" in flags,
        labels="is_using_semantics" in flags, geo=True)
    return (jp, tp, j_make(x, bucket=8, **kw_x), j_make(y, bucket=8, **kw_y),
            t_make(x, bucket=8, device="cpu", **kw_x),
            t_make(y, bucket=8, device="cpu", **kw_y))


def _twist(jp, jx, jy, ell):
    stats = j_kernels.flow_stats(jp, ell, jx, jy, chunk=16)
    twist, _ = j_kernels.flow_from_stats(jp, jx, stats)
    return twist


def _check_stats(got, ref):
    np.testing.assert_allclose(got.row_sum.numpy(), np.asarray(ref.row_sum), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.row_wy.numpy(), np.asarray(ref.row_wy), rtol=1e-5, atol=1e-6)
    assert int(got.nonzeros) == int(ref.nonzeros)
    np.testing.assert_allclose(float(got.a_sum), float(ref.a_sum), rtol=1e-5)


def _check_coeffs(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g), float(r), rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
def test_kernel_block_matches_jax(flags):
    jp, tp, jx, jy, tx, ty = _setup(flags)
    want = np.asarray(j_kernels.kernel_block(jp, jnp.float32(0.45), jx, jy))
    got = t_kernels.kernel_block(tp, torch.tensor(0.45), tx, ty)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    assert int((got > 0).sum()) == int((want > 0).sum())


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
def test_flow_stats_and_step_coeffs_match_jax(flags):
    jp, tp, jx, jy, tx, ty = _setup(flags)
    ell = jnp.float32(0.45)
    _check_stats(t_kernels.flow_stats(tp, torch.tensor(0.45), tx, ty, chunk=16),
                 j_kernels.flow_stats(jp, ell, jx, jy, chunk=16))
    twist = _twist(jp, jx, jy, ell)
    _check_coeffs(t_kernels.step_coeffs(tp, torch.tensor(0.45), tx, ty,
                                        torch.from_numpy(np.array(twist)), chunk=16),
                  j_kernels.step_coeffs(jp, ell, jx, jy, twist, chunk=16))


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
def test_pack_x_and_pack_y_match_jax(flags):
    jp, tp, jx, jy, tx, ty = _setup(flags)
    jlo, tlo = pk.layout_for(jp, jx), t_dense.layout_for(tp, tx)
    assert (tlo.x_dim, tlo.y_dim_flow, tlo.y_dim_step) == (jlo.x_dim, jlo.y_dim_flow, jlo.y_dim_step)
    jc, tc = pk.cloud_center(jx), t_dense.cloud_center(tx)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    for center in (None, "c"):
        jcen, tcen = (None, None) if center is None else (jc, tc)
        np.testing.assert_allclose(
            t_dense.pack_x(tp, tlo, tx, torch.tensor(0.45), center=tcen).numpy(),
            np.asarray(pk.pack_x(jp, jlo, jx, jnp.float32(0.45), center=jcen)),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            t_dense.pack_y(tlo, ty, center=tcen).numpy(),
            np.asarray(pk.pack_y(jlo, jy, center=jcen)), rtol=1e-6, atol=1e-6)
    twist = _twist(jp, jx, jy, jnp.float32(0.45))
    np.testing.assert_allclose(
        t_dense.pack_y(tlo, ty, twist=torch.from_numpy(np.array(twist)), center=tc).numpy(),
        np.asarray(pk.pack_y(jlo, jy, twist=twist, center=jc)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("density", [0.0, 0.1, 0.3, 0.7, 1.0])
def test_compact_tile_mask_fields_equal(density):
    rng = np.random.default_rng(int(density * 10))
    mask = (rng.random((6, 8)) < density).astype(np.int32)
    want = pk.compact_tile_mask(jnp.asarray(mask))
    got = t_dense.compact_tile_mask(torch.from_numpy(mask))
    assert got._fields == want._fields
    for name in want._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
def test_tiled_flow_and_step_match_pallas_interpret(flags):
    jp, tp, jx, jy, tx, ty = _setup(flags)
    ell = jnp.float32(0.45)
    t_ell = torch.tensor(0.45)
    _check_stats(t_dense.flow_stats_tiled(tp, t_ell, tx, ty, tile_i=TI, tile_j=TJ),
                 pk.flow_stats_pallas(jp, ell, jx, jy, tile_i=TI, tile_j=TJ, interpret=True))
    twist = _twist(jp, jx, jy, ell)
    _check_coeffs(t_dense.step_coeffs_tiled(tp, t_ell, tx, ty, torch.from_numpy(np.array(twist)),
                                            tile_i=TI, tile_j=TJ),
                  pk.step_coeffs_pallas(jp, ell, jx, jy, twist, tile_i=TI, tile_j=TJ,
                                        interpret=True))


@pytest.mark.parametrize("mask_kind", ["culled", "all_culled"])
def test_tiled_passes_on_culled_masks_match_pallas_interpret(mask_kind):
    jp, tp, jx, jy, tx, ty = _setup(FLAGS[1], seed=1)
    nI, nJ = -(-jx.capacity // TI), -(-jy.capacity // TJ)
    rng = np.random.default_rng(3)
    mask = ((rng.random((nI, nJ)) < 0.5) if mask_kind == "culled"
            else np.zeros((nI, nJ))).astype(np.int32)
    ell, t_ell = jnp.float32(0.45), torch.tensor(0.45)
    kw = dict(tile_i=TI, tile_j=TJ)
    got = t_dense.flow_stats_tiled(tp, t_ell, tx, ty, tile_mask=torch.from_numpy(mask), **kw)
    _check_stats(got, pk.flow_stats_pallas(jp, ell, jx, jy, tile_mask=jnp.asarray(mask),
                                           interpret=True, **kw))
    if mask_kind == "all_culled":
        assert float(got.row_sum.abs().max()) == 0.0 and float(got.row_wy.abs().max()) == 0.0
        assert int(got.nonzeros) == 0
    twist = _twist(jp, jx, jy, ell)
    _check_coeffs(
        t_dense.step_coeffs_tiled(tp, t_ell, tx, ty, torch.from_numpy(np.array(twist)),
                                  tile_mask=torch.from_numpy(mask), **kw),
        pk.step_coeffs_pallas(jp, ell, jx, jy, twist, tile_mask=jnp.asarray(mask),
                              interpret=True, **kw))


def test_dense_wrappers_take_the_plain_path_on_cpu(monkeypatch):
    def no_build(name):
        raise AssertionError(f"a CPU call tried to load the {name} kernel")

    monkeypatch.setattr(cuda_lib, "load", no_build)
    _, tp, _, _, tx, ty = _setup(FLAGS[2])
    lo = t_dense.layout_for(tp, tx)
    x = t_kernels.pad_cloud_to_multiple(tx, TI)
    y = t_kernels.pad_cloud_to_multiple(ty, TJ)
    xp = t_dense.pack_x(tp, lo, x, torch.tensor(0.45))
    twist = torch.tensor([0.1, -0.2, 0.3, 0.5, 0.1, -0.7])
    twist = twist / torch.linalg.vector_norm(twist)
    comp = t_dense.compact_tile_mask(torch.ones((x.capacity // TI, y.capacity // TJ)))
    before = (t_dense.dense_flow.launches, t_dense.dense_step.launches)
    for fn, plain, yp in (
            (t_dense.dense_flow, t_dense.dense_flow_plain, t_dense.pack_y(lo, y)),
            (t_dense.dense_step, t_dense.dense_step_plain, t_dense.pack_y(lo, y, twist=twist))):
        got = fn(tp, lo, xp, yp, comp, TI, TJ)
        ref = plain(tp, lo, xp, yp, comp, TI, TJ)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert (t_dense.dense_flow.launches, t_dense.dense_step.launches) == before


INSTANCE_CASES = {
    "colour": (dict(is_using_geometry=1, is_using_intensity=1), 5, 0, "colour"),
    "all_channels": (dict(is_using_geometry=1, is_using_intensity=1, is_using_semantics=1,
                          is_using_geometric_type=1), 5, 19, "all_channels"),
    "geometry": (dict(is_using_geometry=1), 0, 0, "geometry"),
    "unlisted_width": (dict(is_using_geometry=1, is_using_intensity=1), 3, 0, "generic"),
    "unlisted_flags": (dict(is_using_geometry=0, is_using_intensity=1), 5, 0, "generic"),
}


@pytest.mark.parametrize("case", list(INSTANCE_CASES), ids=list(INSTANCE_CASES))
def test_kernel_instance_follows_the_channel_set(case):
    flags, F, C, want = INSTANCE_CASES[case]
    tp = convert.params_from_fields(dataclasses.asdict(JaxParams().replace(**flags)))
    rng = np.random.default_rng(0)
    kw = {}
    if F:
        kw["features"] = rng.random((12, F)).astype(np.float32)
    if C:
        kw["labels"] = rng.random((12, C)).astype(np.float32)
    cloud = t_make(rng.random((12, 3)).astype(np.float32), bucket=4, device="cpu", **kw)
    lo = t_dense.layout_for(tp, cloud)
    assert t_dense.kernel_instance(lo) == want
    assert want in t_dense.KERNEL_INSTANCES
    # the flags the C entry point chooses from carry the same six values
    assert list(t_dense._flags(lo)) == [lo.feature_dim, lo.num_classes, int(lo.use_geometry),
                                        int(lo.use_intensity), int(lo.use_semantics),
                                        int(lo.use_geo_type)]


@pytest.mark.parametrize("shape", [(16384, 16384, 128, 512), (512, 1024, 256, 128),
                                   (96, 64, 32, 32)], ids=["bench", "two_row_blocks", "small"])
def test_scratch_shapes_cover_every_item(shape):
    N, M, ti, tj = shape
    pairs = (N // ti) * (M // tj)
    shapes = t_dense.scratch_shapes(N, M, ti, tj)
    blocks = t_dense.row_blocks(ti)
    assert blocks * t_dense.KERNEL_ROW_BLOCK >= ti > (blocks - 1) * t_dense.KERNEL_ROW_BLOCK
    assert shapes == {"flow": (pairs, 5, ti), "step": (pairs * blocks, 4)}
    if shape[0] == 16384:  # 10.5 MB of flow partials at the bench shapes
        assert 4 * int(np.prod(shapes["flow"])) == 10485760


def _item_model(tp, lo, xp, yp, comp, ti, tj, grid, row_block):
    """Numpy model of the CUDA passes' work split: block b takes items b,
    b + grid, ... of the first n * row_blocks items (item = pair * row_blocks
    + row block), writes each item's row partials into scratch by item, and
    every source tile then sums its pairs' partials in list order."""
    k = t_dense._consts(tp)
    N, M = xp.shape[0], yp.shape[1]
    nI = N // ti
    rbn = -(-ti // row_block)
    n = int(comp.n)
    pair_i, pair_j = comp.pair_i.numpy(), comp.pair_j.numpy()
    row_has = comp.row_has.numpy()
    part = np.full(((N // ti) * (M // tj), 5, ti), np.nan, np.float32)
    done = []
    for b in range(grid):
        for item in range(b, n * rbn, grid):
            p, rb = divmod(item, rbn)
            rows = slice(rb * row_block, min(ti, (rb + 1) * row_block))
            i, j = int(pair_i[p]), int(pair_j[p])
            xb = xp[i * ti:(i + 1) * ti][rows][None]
            yb = yp[:, j * tj:(j + 1) * tj][None]
            a = t_dense._a_tiles(lo, k, xb, yb)[0].numpy()
            if not row_has[i]:
                a = np.zeros_like(a)
            y = yb[0].numpy()
            part[p, 0, rows] = a.sum(-1)
            for c in range(3):
                part[p, 1 + c, rows] = (a * y[c][None, :]).sum(-1)
            part[p, 4, rows] = (a > 0).sum(-1)
            done.append(item)
    assert sorted(done) == list(range(n * rbn))
    s = np.zeros((nI, ti), np.float32)
    wy = np.zeros((nI, ti, 3), np.float32)
    cnt = np.zeros((nI, ti), np.int64)
    for tile in range(nI):
        if not row_has[tile]:
            continue
        lo_p, hi_p = np.searchsorted(pair_i[:n], [tile, tile + 1])
        for p in range(lo_p, hi_p):
            s[tile] += part[p, 0]
            wy[tile] += part[p, 1:4].T
            cnt[tile] += part[p, 4].astype(np.int64)
    return s.reshape(N), wy.reshape(N, 3), int(cnt.sum())


@pytest.mark.parametrize("grid,row_block", [(1, 16), (3, 16), (7, 8), (64, 16)],
                         ids=["one_block", "three_blocks", "two_row_blocks", "more_blocks_than_items"])
def test_item_split_model_reproduces_plain_flow_rows(grid, row_block):
    # a wide colour kernel: random features leave nothing above sp_thres at
    # the default c_ell
    _, tp, _, _, tx, ty = _setup(dict(FLAGS[1], c_ell=3.0), seed=2)
    lo = t_dense.layout_for(tp, tx)
    x = t_kernels.pad_cloud_to_multiple(tx, TI)
    y = t_kernels.pad_cloud_to_multiple(ty, TJ)
    nI, nJ = x.capacity // TI, y.capacity // TJ
    mask = (np.random.default_rng(5).random((nI, nJ)) < 0.6).astype(np.int32)
    mask[1] = 0  # an empty source tile
    mask[0, 0] = 1
    comp = t_dense.compact_tile_mask(torch.from_numpy(mask))
    xp = t_dense.pack_x(tp, lo, x, torch.tensor(0.45))
    yp = t_dense.pack_y(lo, y)
    s, wy, nz = _item_model(tp, lo, xp, yp, comp, TI, TJ, grid, row_block)
    ref_s, ref_wy, ref_nz, _ = t_dense.dense_flow_plain(tp, lo, xp, yp, comp, TI, TJ)
    assert int(ref_nz) > 30
    np.testing.assert_allclose(s, ref_s.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(wy, ref_wy.numpy(), rtol=1e-5, atol=1e-6)
    assert nz == int(ref_nz)
    assert not s[TI:2 * TI].any() and not wy[TI:2 * TI].any()
    # the pairs a pass must evaluate in full are those inside the geometric gate
    gated = t_dense.geometric_gate_count(lo, xp, yp, comp, TI, TJ)
    assert nz <= gated <= int(comp.n) * TI * TJ


def test_lib_path_follows_each_source_s_own_flags(tmp_path, monkeypatch):
    assert "-fmad=false" in cuda_lib.flags_for("select") == cuda_lib.flags_for("ell")
    assert "-fmad=false" not in cuda_lib.flags_for("dense")
    assert not any("fast_math" in f for n in cuda_lib.SOURCES for f in cuda_lib.flags_for(n))
    # one source, two flag sets: two libraries
    assert cuda_lib.lib_path("dense") != cuda_lib.lib_path("dense", ("-fmad=false",))
    assert cuda_lib.lib_path("dense", ("-DDENSE_PREFILTER=0",)) not in (
        cuda_lib.lib_path("dense"), cuda_lib.lib_path("dense", ("-DDENSE_ASYNC=0",)))
    # the same source text under two names differs only by its flags
    for name in ("ell", "dense"):
        (tmp_path / f"{name}.cu").write_text("// same text\n")
    monkeypatch.setattr(cuda_lib, "CSRC", tmp_path)
    monkeypatch.setitem(cuda_lib.SOURCE_FLAGS, "ell", cuda_lib.flags_for("dense"))
    same = cuda_lib.lib_path("ell").name.split("-")[1]
    monkeypatch.delitem(cuda_lib.SOURCE_FLAGS, "ell")
    assert cuda_lib.lib_path("ell").name.split("-")[1] != same
