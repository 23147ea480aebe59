"""The plain versions of the port's consume kernels (ops/ell.py) against the
JAX package's Pallas kernels in interpret mode, fed one neighbor list built
by the JAX package and carried across with convert.py.

Setup: 400 points in a 512 bucket (dead slots and masked rows), the list
consumed half-way to the true pose so that the flow is well away from zero.
Tolerances: nonzeros exact; a_sum rtol 1e-5; unit twist atol 1e-4; joint
norm rtol 1e-4; A atol 1e-6 slot by slot; B..E rtol 1e-3 atol 1e-4 (the
JAX package's own, test_neighbors.py:299-301: per-tile partial sums
reassociate the f32 reductions).

Every pass that evaluates A runs in the three variants of
pallas_ell._transform_and_a: geometry only, geometry times a channel factor
(intensity + 4 semantic classes on a grid list, the setup of
test_neighbors.py::test_fused_ell_consume_matches_jnp_with_channels) and
the channel factor alone (intensity on a scan list built without geometry,
the setup of test_align_scan_no_geometry_channel). With a channel factor
the step coefficients carry cancelling sums and compare at rtol 3e-3 atol
1e-3 (test_neighbors.py:339-342); the rows at the JAX package's rtol 1e-5
atol 1e-6 (s) and rtol 1e-4 atol 1e-5 (wy) (test_neighbors.py:290-293).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unified_cvo_tpu.config import CvoParams as JaxParams
from unified_cvo_tpu.ops import lie as j_lie
from unified_cvo_tpu.ops import neighbors as j_nbr
from unified_cvo_tpu.ops import pallas_ell as pe
from unified_cvo_tpu.utils.pointcloud import make_pointcloud as j_make
from unified_cvo_tpu_torch import convert
from unified_cvo_tpu_torch.ops import cuda_lib
from unified_cvo_tpu_torch.ops import ell as t_ell

from test_torch_channels import NL_FIELDS
from test_torch_neighbors import _scene

torch.set_num_threads(1)

TILE = 256


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    xyz = np.stack([rng.uniform(-12, 12, 400), rng.uniform(-2, 2, 400),
                    rng.uniform(2, 50, 400)], axis=1).astype(np.float32)
    jp = JaxParams(ell_init=0.4, sp_thres=0.0006, is_using_geometry=1)
    tp = convert.params_from_fields(dataclasses.asdict(jp))
    xi = np.array([0.002, 0.005, -0.001, 0.05, 0.02, 0.4], np.float32)
    R_m, t_m = j_lie.se3_exp(jnp.asarray(xi), 1.0)
    xyz2 = np.asarray(xyz @ np.asarray(R_m).T + np.asarray(t_m))
    src = j_make(xyz, bucket=512)
    tgt = j_make(xyz2, bucket=512)
    R_h, t_h = j_lie.se3_exp(jnp.asarray(0.5 * xi), 1.0)
    Rinv, Tinv = j_lie.invert_rt(R_h, t_h)
    ell = jnp.float32(jp.ell_init)
    nl = j_nbr.build_neighbor_list(jp, ell, src, tgt, Rinv, Tinv, k=32,
                                   skin=0.3, per_cell_cap=24)
    t_src = convert.pointcloud_from_numpy(np.asarray(src.xyz), np.asarray(src.mask),
                                          device="cpu")
    t_nl = convert.neighbor_list_from_numpy(
        **{f: np.asarray(getattr(nl, f)) for f in (
            "idx", "valid", "y_xyz", "y_t_build", "overflow", "pose_build",
            "r_max_t", "ell_build", "k_lin")}, device="cpu")
    flow_j = pe.flow_twist_ell_fused(jp, ell, src, nl, Rinv, Tinv, tile_n=TILE,
                                     interpret=True, emit_a=True)
    return dict(jp=jp, tp=tp, src=src, nl=nl, Rinv=Rinv, Tinv=Tinv, ell=ell,
                t_src=t_src, t_nl=t_nl, flow_j=flow_j,
                tR=torch.from_numpy(np.array(Rinv)), tT=torch.from_numpy(np.array(Tinv)))


def _xp(s):
    return t_ell.pack_x(s["tp"], torch.tensor(s["jp"].ell_init), s["t_src"])


def test_pack_x_matches_jax(setup):
    s = setup
    ref = np.asarray(pe.pack_x(s["jp"], s["ell"], s["src"]))
    np.testing.assert_allclose(_xp(s).numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("with_twist", [False, True])
def test_pack_scalars_matches_jax(setup, with_twist):
    s = setup
    tw = s["flow_j"][0] if with_twist else None
    ref = np.asarray(pe.pack_scalars(s["jp"], s["Rinv"], s["Tinv"], tw))
    got = t_ell.pack_scalars(s["tp"], s["tR"], s["tT"],
                             None if tw is None else torch.from_numpy(np.array(tw)))
    assert got.shape == (t_ell.S_LEN,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)


def test_flow_plain_matches_pallas(setup):
    s = setup
    unit_j, jn_j, nz_j, asum_j, a_j = s["flow_j"]
    unit, jn, nz, asum, a = t_ell.flow_reduce_plain(
        _xp(s), s["t_nl"].y_xyz, t_ell.pack_scalars(s["tp"], s["tR"], s["tT"]),
        s["tp"].c, s["tp"].d)
    assert int(nz) == int(nz_j) > 0
    np.testing.assert_allclose(float(asum), float(asum_j), rtol=1e-5)
    np.testing.assert_allclose(unit.numpy(), np.asarray(unit_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(jn), float(jn_j), rtol=1e-4)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), rtol=0, atol=1e-6)
    # dead slots and masked rows carry exactly zero kernel values
    dead = s["t_nl"].idx.numpy() < 0
    assert (a.numpy()[dead] == 0).all() and (a.numpy()[:, 400:] == 0).all()


def test_step_plain_matches_pallas(setup):
    s = setup
    unit_j, _, _, _, a_j = s["flow_j"]
    want = pe.step_coeffs_ell_fused_cached(
        s["jp"], s["ell"], s["src"], s["nl"], s["Rinv"], s["Tinv"], unit_j, a_j,
        tile_n=TILE, interpret=True)
    scal = t_ell.pack_scalars(s["tp"], s["tR"], s["tT"], torch.from_numpy(np.array(unit_j)))
    got = t_ell.step_cached_plain(_xp(s), s["t_nl"].y_xyz,
                                  torch.from_numpy(np.array(a_j)), scal)
    assert bool(torch.all(torch.isfinite(got)))
    for g, w in zip(got.tolist(), want):
        np.testing.assert_allclose(g, float(w), rtol=1e-3, atol=1e-4)


def test_cpu_wrappers_take_the_plain_path(setup, monkeypatch):
    """On CPU tensors the wrappers run the plain versions, never load a
    library and never count a launch."""
    s = setup

    def no_build(name):
        raise AssertionError(f"a CPU call tried to load the {name} kernel")

    monkeypatch.setattr(cuda_lib, "load", no_build)
    flow0, step0 = t_ell.flow_reduce.launches, t_ell.step_cached.launches
    xp = _xp(s)
    scal = t_ell.pack_scalars(s["tp"], s["tR"], s["tT"])
    got = t_ell.flow_reduce(xp, s["t_nl"].y_xyz, scal, s["tp"].c, s["tp"].d)
    ref = t_ell.flow_reduce_plain(xp, s["t_nl"].y_xyz, scal, s["tp"].c, s["tp"].d)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    scal_t = t_ell.pack_scalars(s["tp"], s["tR"], s["tT"], got[0])
    assert torch.equal(t_ell.step_cached(xp, s["t_nl"].y_xyz, got[4], scal_t),
                       t_ell.step_cached_plain(xp, s["t_nl"].y_xyz, got[4], scal_t))
    assert (t_ell.flow_reduce.launches, t_ell.step_cached.launches) == (flow0, step0)


@pytest.mark.parametrize("which", ["flow_twist", "zero"])
def test_twist_scalars_match_jax(setup, which):
    """twist_scalars is the twist part (S_OM2 ..) of the JAX scalar block."""
    s = setup
    tw = s["flow_j"][0] if which == "flow_twist" else jnp.zeros((6,), jnp.float32)
    ref = np.asarray(pe.pack_scalars(s["jp"], s["Rinv"], s["Tinv"], tw))[t_ell.S_OM2:]
    got = t_ell.twist_scalars(torch.from_numpy(np.array(tw)))
    assert got.shape == (t_ell.S_LEN - t_ell.S_OM2,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)


def test_step_plain_takes_the_twist(setup):
    """step_cached_plain(..., scal without twist, twist=u) is bit-equal to
    the step on the host-built block pack_scalars(..., u), and matches the
    Pallas step in interpret mode at the step's tolerance."""
    s = setup
    unit_j, _, _, _, a_j = s["flow_j"]
    u = torch.from_numpy(np.array(unit_j))
    xp, a = _xp(s), torch.from_numpy(np.array(a_j))
    got = t_ell.step_cached_plain(xp, s["t_nl"].y_xyz, a,
                                  t_ell.pack_scalars(s["tp"], s["tR"], s["tT"]), twist=u)
    host = t_ell.step_cached_plain(xp, s["t_nl"].y_xyz, a,
                                   t_ell.pack_scalars(s["tp"], s["tR"], s["tT"], u))
    assert torch.equal(got, host)
    want = pe.step_coeffs_ell_fused_cached(
        s["jp"], s["ell"], s["src"], s["nl"], s["Rinv"], s["Tinv"], unit_j, a_j,
        tile_n=TILE, interpret=True)
    for g, w in zip(got.tolist(), want):
        np.testing.assert_allclose(g, float(w), rtol=1e-3, atol=1e-4)


def test_cpu_step_with_twist_takes_the_plain_path(setup, monkeypatch):
    """step_cached(..., twist=) on CPU tensors runs the plain version, never
    loads a library and never counts a launch."""
    s = setup

    def no_build(name):
        raise AssertionError(f"a CPU call tried to load the {name} kernel")

    monkeypatch.setattr(cuda_lib, "load", no_build)
    step0 = t_ell.step_cached.launches
    xp = _xp(s)
    scal = t_ell.pack_scalars(s["tp"], s["tR"], s["tT"])
    unit, _, _, _, a = t_ell.flow_reduce(xp, s["t_nl"].y_xyz, scal, s["tp"].c, s["tp"].d)
    got = t_ell.step_cached(xp, s["t_nl"].y_xyz, a, scal, twist=unit)
    assert torch.equal(got, t_ell.step_cached_plain(xp, s["t_nl"].y_xyz, a, scal, unit))
    assert t_ell.step_cached.launches == step0


@pytest.fixture(scope="module", params=t_ell.VARIANTS)
def case(request):
    """One list per kernel variant, consumed half-way to the true pose."""
    v = request.param
    return _variant_case(v, 400 if v != "chan" else 512, 512)


@pytest.fixture(scope="module", params=t_ell.VARIANTS)
def odd_case(request):
    """The same lists at N = 509 (N % 4 != 0: the kernels' one-point-a-thread
    shape), one tile of N."""
    return _variant_case(request.param, 509, 509)


def _variant_case(v, n, bucket):
    rng = np.random.default_rng(0)
    base = dict(ell_init=0.4, ell_min=0.05, ell_decay_rate=0.9, ell_decay_start=5,
                indicator_window_size=5, indicator_stable_threshold=0.2,
                max_step=0.1, sp_thres=0.0006, is_using_geometry=1)
    fields = {}
    if v == "geo":
        xyz = _scene(rng, n)
    elif v == "geo_chan":
        base.update(is_using_intensity=1, c_ell=0.5, c_sigma=1.0,
                    is_using_semantics=1, s_ell=0.6, s_sigma=1.0)
        xyz = _scene(rng, n)
        fields = dict(features=rng.uniform(0, 1, (n, 3)).astype(np.float32),
                      labels=np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)])
    else:
        base.update(is_using_geometry=0, is_using_intensity=1, c_ell=0.3,
                    c_sigma=1.0, sp_thres=0.01, max_step=0.02)
        xyz = _scene(rng, n, spread=4.0)
        fields = dict(features=rng.uniform(0, 1, (n, 3)).astype(np.float32))
    jp = JaxParams(**base)
    tp = convert.params_from_fields(dataclasses.asdict(jp))
    xi = np.array([0.002, 0.005, -0.001, 0.05, 0.02, 0.4], np.float32)
    R_m, t_m = j_lie.se3_exp(jnp.asarray(xi), 1.0)
    xyz2 = np.asarray(xyz @ np.asarray(R_m).T + np.asarray(t_m))
    src = j_make(xyz, bucket=bucket, **fields)
    tgt = j_make(xyz2, bucket=bucket, **fields)
    R_h, t_h = j_lie.se3_exp(jnp.asarray(0.5 * xi), 1.0)
    Rinv, Tinv = j_lie.invert_rt(R_h, t_h)
    ell = jnp.float32(jp.ell_init)
    tile = TILE if bucket % TILE == 0 else bucket
    if v == "chan":
        nl = j_nbr.build_neighbor_list_scan(jp, ell, src, tgt, Rinv, Tinv, k=64)
    else:
        nl = j_nbr.build_neighbor_list(jp, ell, src, tgt, Rinv, Tinv, k=64,
                                       skin=0.3, per_cell_cap=24)
    assert (nl.chan is None) == (v == "geo")
    t_nl = convert.neighbor_list_from_numpy(
        **{f: None if getattr(nl, f) is None else np.asarray(getattr(nl, f))
           for f in NL_FIELDS}, device="cpu")
    t_src = convert.pointcloud_from_numpy(np.asarray(src.xyz), np.asarray(src.mask),
                                          device="cpu")
    tR, tT = torch.from_numpy(np.array(Rinv)), torch.from_numpy(np.array(Tinv))
    # the reduced flow kernel folds each tile into 128 lanes: not at N = 509
    flow_j = pe.flow_twist_ell_fused(jp, ell, src, nl, Rinv, Tinv, tile_n=tile,
                                     interpret=True, emit_a=True) if tile % 128 == 0 else None
    return dict(v=v, jp=jp, tp=tp, src=src, nl=nl, Rinv=Rinv, Tinv=Tinv, ell=ell, tile=tile,
                t_src=t_src, t_nl=t_nl, tR=tR, tT=tT, flow_j=flow_j,
                xp=t_ell.pack_x(tp, torch.tensor(jp.ell_init), t_src),
                use_geo=bool(jp.is_using_geometry))


def test_flow_variant_plain_matches_pallas(case):
    c = case
    unit_j, jn_j, nz_j, asum_j, a_j = c["flow_j"]
    unit, jn, nz, asum, a = t_ell.flow_reduce_plain(
        c["xp"], c["t_nl"].y_xyz, t_ell.pack_scalars(c["tp"], c["tR"], c["tT"]),
        c["tp"].c, c["tp"].d, chan=c["t_nl"].chan, use_geometry=c["use_geo"])
    assert int(nz) == int(nz_j) > 0
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(asum), float(asum_j), rtol=1e-5)
    np.testing.assert_allclose(unit.numpy(), np.asarray(unit_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(jn), float(jn_j), rtol=1e-4)
    assert (a.numpy()[c["t_nl"].idx.numpy() < 0] == 0).all()


def test_flow_rows_plain_matches_pallas(case):
    """Kernel 4 (pallas_ell._flow_kernel) through flow_stats_ell_fused."""
    _check_flow_rows(case)


def test_flow_rows_plain_at_odd_n_matches_pallas(odd_case):
    """Kernel 4 at N = 509, the point count the CUDA kernel takes one point
    a thread for."""
    _check_flow_rows(odd_case)


def _check_flow_rows(c):
    N = c["t_src"].capacity
    want = pe.flow_stats_ell_fused(c["jp"], c["ell"], c["src"], c["nl"], c["Rinv"],
                                   c["Tinv"], tile_n=c["tile"], interpret=True)
    got = t_ell.flow_stats_ell_fused(c["tp"], torch.tensor(c["jp"].ell_init), c["t_src"],
                                     c["t_nl"], c["tR"], c["tT"])
    assert got.nonzeros.dtype == torch.int32
    assert int(got.nonzeros) == int(want.nonzeros) > 0
    np.testing.assert_allclose(float(got.a_sum), float(want.a_sum), rtol=1e-5)
    np.testing.assert_allclose(got.row_sum.numpy(), np.asarray(want.row_sum),
                               rtol=1e-5, atol=1e-6)
    assert tuple(got.row_wy.shape) == (N, 3)
    np.testing.assert_allclose(got.row_wy.numpy(), np.asarray(want.row_wy),
                               rtol=1e-4, atol=1e-5)
    # the per-point counts add up to the nonzeros, row by row as A > 0
    s, wy, cnt, nz, asum = t_ell.flow_rows_plain(
        c["xp"], c["t_nl"].y_xyz, t_ell.pack_scalars(c["tp"], c["tR"], c["tT"]),
        c["t_nl"].chan, c["use_geo"])
    a = (c["flow_j"][4] if c["flow_j"] is not None else
         j_nbr.flow_stats_ell(c["jp"], c["ell"], c["src"], c["nl"], c["Rinv"], c["Tinv"])[1])
    np.testing.assert_array_equal(cnt.numpy(), (np.asarray(a) > 0).sum(0))
    assert int(nz) == int(cnt.sum())


def test_step_uncached_plain_matches_pallas(case):
    """Kernel 5 (pallas_ell._step_kernel, reduced) through
    step_coeffs_ell_fused, at the flow's own twist."""
    c = case
    twist = c["flow_j"][0]
    want = pe.step_coeffs_ell_fused(c["jp"], c["ell"], c["src"], c["nl"], c["Rinv"],
                                    c["Tinv"], twist, tile_n=TILE, interpret=True)
    got = t_ell.step_coeffs_ell_fused(c["tp"], torch.tensor(c["jp"].ell_init), c["t_src"],
                                      c["t_nl"], c["tR"], c["tT"],
                                      torch.from_numpy(np.array(twist)))
    rtol, atol = (1e-3, 1e-4) if c["v"] == "geo" else (3e-3, 1e-3)
    assert all(bool(torch.isfinite(g)) for g in got)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=rtol, atol=atol)
    # the uncached step equals the cached step fed the flow pass's A
    scal = t_ell.pack_scalars(c["tp"], c["tR"], c["tT"], torch.from_numpy(np.array(twist)))
    a = t_ell.flow_reduce_plain(c["xp"], c["t_nl"].y_xyz,
                                t_ell.pack_scalars(c["tp"], c["tR"], c["tT"]),
                                c["tp"].c, c["tp"].d, c["t_nl"].chan, c["use_geo"])[4]
    assert torch.equal(torch.stack(list(got)),
                       t_ell.step_cached_plain(c["xp"], c["t_nl"].y_xyz, a, scal))


def test_new_cpu_wrappers_take_the_plain_path(case, monkeypatch):
    """flow_rows and step_uncached on CPU tensors run their plain versions,
    never load a library and never count a launch, in every variant."""
    c = case

    def no_build(name):
        raise AssertionError(f"a CPU call tried to load the {name} kernel")

    monkeypatch.setattr(cuda_lib, "load", no_build)
    before = {f.__name__: (f.launches, dict(f.variant_launches))
              for f in (t_ell.flow_reduce, t_ell.flow_rows, t_ell.step_uncached)}
    scal = t_ell.pack_scalars(c["tp"], c["tR"], c["tT"])
    args = (c["xp"], c["t_nl"].y_xyz, scal, c["t_nl"].chan, c["use_geo"])
    for g, r in zip(t_ell.flow_rows(*args), t_ell.flow_rows_plain(*args)):
        assert torch.equal(g, r)
    assert torch.equal(t_ell.step_uncached(*args), t_ell.step_uncached_plain(*args))
    got = t_ell.flow_reduce(c["xp"], c["t_nl"].y_xyz, scal, c["tp"].c, c["tp"].d,
                            chan=c["t_nl"].chan, use_geometry=c["use_geo"])
    assert int(got[2]) > 0
    after = {f.__name__: (f.launches, dict(f.variant_launches))
             for f in (t_ell.flow_reduce, t_ell.flow_rows, t_ell.step_uncached)}
    assert after == before


def test_variant_needs_geometry_or_a_channel_factor():
    assert [t_ell.variant(None, True), t_ell.variant(torch.ones(1), True),
            t_ell.variant(torch.ones(1), False)] == list(t_ell.VARIANTS)
    with pytest.raises(ValueError, match="channel"):
        t_ell.variant(None, False)
    with pytest.raises(ValueError, match="channel"):
        t_ell.flow_rows_plain(torch.zeros(6, 4), torch.zeros(3, 2, 4),
                              torch.zeros(t_ell.S_LEN), None, False)
