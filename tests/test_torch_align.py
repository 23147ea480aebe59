"""The port's aligner (models/align.py) and its slices against JAX align on
the CPU, on identical numpy inputs:

* the frame-to-frame ELL slice (apps/f2f_sequence.py) against JAX
  align(backend='ell', nl_builder='grid');
* the ELL path with channels and the scan builder: the colour chain on the
  default backend (grid list with a channel factor), the no-geometry scan
  fixture (one build per solve) and the large-support small-cloud fixture
  (the default builder resolves to 'scan' on both sides), each against JAX
  align(backend='ell'), and the builder rule against JAX's;
* the dense backends: 'pallas' (plain versions of the dense tiled kernels,
  with Morton culling) against JAX 'pallas_interpret', and 'jnp' against
  JAX 'jnp', at test_pallas.py's setup (poses to 1e-5, equal iterations);
* the dense slice as a whole: the colour sequence on 'pallas' against the
  same chain through JAX 'jnp' (JAX's dense-Pallas interpret mode is too
  slow at 2048 points; test_pallas.py shows the two JAX backends agree).

Sequence poses compare by |log(T_jax T_port^-1)| < 5e-3, and both must stay
within the 0.05 pose-error bound. Iteration counts of capped ELL runs are
not compared unless both hit the cap: f32 reduction order perturbs each step
by ~1e-4 relative and the threshold-driven schedule amplifies that (PERF.md,
"Fused-vs-jnp consume drift").
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unified_cvo_tpu.config import CvoParams as JaxParams
from unified_cvo_tpu.models.align import align as j_align
from unified_cvo_tpu.ops import lie as j_lie
from unified_cvo_tpu.utils.pointcloud import make_pointcloud as j_make
from unified_cvo_tpu_torch import convert
from unified_cvo_tpu_torch.apps import f2f_sequence as f2f
from unified_cvo_tpu_torch.config import KITTI_COLOR_BENCH, KITTI_GEOMETRIC_BENCH, CvoParams
from unified_cvo_tpu_torch.models.align import align as t_align
from unified_cvo_tpu_torch.models.align import resolve_backend, resolve_nl_builder
from unified_cvo_tpu_torch.ops import lie as t_lie
from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud as t_make

from test_align import _bunnyish_cloud
from test_torch_neighbors import _params, _scene

torch.set_num_threads(1)

POSE_TOL = 5e-3


def _log_norm(T):
    T = torch.as_tensor(np.asarray(T, np.float32))
    return float(torch.linalg.vector_norm(t_lie.se3_log(T[:3, :3], T[:3, 3])))


def _pose_gap(T_a, T_b):
    return _log_norm(np.asarray(T_a, np.float64) @ np.linalg.inv(np.asarray(T_b, np.float64)))


def _case_1024():
    """test_neighbors.py::test_fused_vs_jnp_convergence_agreement's setup."""
    rng = np.random.default_rng(0)
    xyz = np.stack([rng.uniform(-12, 12, 1024), rng.uniform(-2, 2, 1024),
                    rng.uniform(2, 50, 1024)], axis=1).astype(np.float32)
    xi = np.array([0.002, 0.005, -0.003, 0.05, 0.02, 0.35], np.float32)
    R_m, t_m = j_lie.se3_exp(jnp.asarray(xi), 1.0)
    xyz2 = np.asarray(xyz @ np.asarray(R_m).T + np.asarray(t_m))
    xyz2 += rng.normal(scale=0.003, size=xyz2.shape).astype(np.float32)
    ig = np.array(j_lie.rt_to_mat44(*j_lie.se3_exp(jnp.asarray(xi * 0.3), 1.0)))
    T_true = np.array(j_lie.rt_to_mat44(R_m, t_m))
    jp = JaxParams(ell_init=0.4, ell_min=0.05, ell_decay_rate=0.9,
                   ell_decay_start=5, indicator_window_size=5,
                   indicator_stable_threshold=0.2, max_step=0.1,
                   sp_thres=0.0006, is_using_geometry=1)
    return xyz, xyz2, ig, T_true, jp


@pytest.mark.parametrize("skin", [None, 0.12], ids=["default_skin", "forced_rebuilds"])
def test_align_matches_jax(skin):
    xyz, xyz2, ig, T_true, jp = _case_1024()
    tp = convert.params_from_fields(dataclasses.asdict(jp))
    kw = dict(backend="ell", max_iter=120, nl_k=160, nl_per_cell=20, nl_skin=skin)
    T_j, ret_j, info_j = j_align(j_make(xyz, bucket=1024), j_make(xyz2, bucket=1024),
                                 jnp.asarray(ig), jp, nl_builder="grid", **kw)
    T_t, ret_t, info_t = t_align(t_make(xyz, bucket=1024, device="cpu"),
                                 t_make(xyz2, bucket=1024, device="cpu"), ig, tp,
                                 device="cpu", nl_builder="grid", **kw)
    assert T_t.shape == (4, 4) and T_t.dtype == torch.float32
    assert int(ret_t) == int(ret_j) == 0
    assert info_t.iterations == int(info_j.iterations) == 120
    assert info_t.host_reads == info_t.iterations
    gap = _pose_gap(T_j, T_t.numpy())
    assert gap < POSE_TOL, f"port and JAX poses {gap} apart"
    err_j = _log_norm(np.asarray(T_j) @ T_true)
    err_t = _log_norm(T_t.numpy() @ T_true)
    assert max(err_j, err_t) < f2f.POSE_ERROR_BOUND
    assert abs(err_j - err_t) < POSE_TOL
    assert int(info_t.nl_overflow) == int(info_j.nl_overflow) == 0
    if skin is not None:
        assert info_t.nl_rebuilds >= 2 and int(info_j.nl_rebuilds) >= 2


def test_f2f_sequence_matches_jax_chain():
    """Two 4096-point bench pairs with KITTI_GEOMETRIC_BENCH, max_iter=300,
    through the port's device-resident constant-velocity chain and the same
    chain through JAX align."""
    frames, T_true = f2f.make_sequence(4096, 2)
    guess = f2f.initial_guess()
    res_t, infos = f2f.run_sequence(
        [t_make(f, bucket=4096, device="cpu") for f in frames],
        torch.from_numpy(guess), KITTI_GEOMETRIC_BENCH, device="cpu", max_iter=300)
    jp = JaxParams(**dataclasses.asdict(KITTI_GEOMETRIC_BENCH))
    g = jnp.asarray(guess)
    res_j = []
    jf = [j_make(f, bucket=4096) for f in frames]
    for k in range(2):
        T, _, _ = j_align(jf[k], jf[k + 1], g, jp, max_iter=300)
        g = j_lie.rt_to_mat44(*j_lie.invert_rt(*j_lie.mat44_to_rt(T)))
        res_j.append(np.asarray(T))
    errs_t = f2f.pose_errors(res_t, T_true)
    errs_j = f2f.pose_errors(res_j, T_true)
    assert max(errs_t) < f2f.POSE_ERROR_BOUND and max(errs_j) < f2f.POSE_ERROR_BOUND
    for T_j, T_t in zip(res_j, res_t):
        assert _pose_gap(T_j, T_t.numpy()) < POSE_TOL
    assert all(i.nl_rebuilds >= 1 and i.iterations == 300 for i in infos)


@pytest.mark.parametrize("case", ["channels", "acvo", "scan", "acvo_dense", "channels_ell"])
def test_configurations_outside_the_slice_raise(case):
    """Configurations that were outside earlier slices (the name dates from
    when they raised) run on the CPU with the backend and builder JAX
    picks: intensity on the auto and on the explicit ELL backend and the
    scan builder go through the ELL path with the grid or scan builder;
    ACVO on the auto backend goes to 'ell' with
    the scan builder (the support at ell_max is 3.2 m), on the explicit
    'pallas' backend to the dense tiles, and its ell schedule moves. The
    ACVO cases register a moved copy of the cloud (on the cloud itself at
    the identity the dl gradient is 0)."""
    from unified_cvo_tpu.models.align import resolve_backend as j_resolve

    rng = np.random.default_rng(5)
    n = 4096
    xyz = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    feats = rng.uniform(0, 1, (n, 5)).astype(np.float32)
    pc = t_make(xyz, features=feats, bucket=n, device="cpu")
    params, kw = CvoParams(), {}
    if case in ("channels", "channels_ell"):
        params = params.replace(is_using_intensity=1)
    if case in ("acvo", "acvo_dense"):
        params = params.replace(is_ell_adaptive=1)
    if case == "scan":
        kw = dict(nl_builder="scan")
    elif case == "acvo_dense":
        kw = dict(backend="pallas")
    elif case == "channels_ell":
        kw = dict(backend="ell")
    if case.startswith("acvo"):
        moved = t_make(xyz + np.float32([0.05, 0.0, 0.02]), features=feats, bucket=n,
                       device="cpu")
        T, ret, info = t_align(pc, moved, np.eye(4, dtype=np.float32), params, device="cpu",
                               max_iter=3, **kw)
        jp = JaxParams(**dataclasses.asdict(params))
        want = j_resolve(jp, n, n, kw.get("backend", "auto"))
        assert info.backend == want == ("pallas" if case == "acvo_dense" else "ell")
        assert info.nl_builder == (None if case == "acvo_dense" else "scan")
        assert info.iterations == 3 and float(info.final_ell) != params.ell_init
        assert bool(torch.all(torch.isfinite(T)))
        return
    T, ret, info = t_align(pc, pc, np.eye(4, dtype=np.float32), params, device="cpu",
                           max_iter=3, **kw)
    assert (info.backend, info.nl_builder) == ("ell", "scan" if case == "scan" else "grid")
    assert info.iterations == 3 and info.nl_rebuilds == 1
    assert bool(torch.all(torch.isfinite(T)))


@pytest.mark.parametrize("kw, match", [
    (dict(params=dict(is_using_geometry=0), backend="ell"), "rank candidates"),
    (dict(params=dict(is_using_geometry=0, is_using_intensity=1), backend="ell",
          nl_builder="grid"), "needs the geometric channel"),
    (dict(params={}, backend="ell", nl_builder="kdtree"), "unknown nl_builder"),
    (dict(params=dict(is_using_geometry=0, is_using_intensity=1, is_ell_adaptive=1),
          backend="ell"), "adaptive_ell needs the geometric channel"),
], ids=["no_channel", "grid_without_geometry", "unknown_builder", "acvo_without_geometry"])
def test_ell_preconditions_raise_value_error(kw, match):
    """align.py:248-256 and :274-277: the ELL path needs a ranking channel
    and, under adaptive ell, geometry; the grid builder needs geometry."""
    xyz = np.random.default_rng(6).uniform(-5, 5, (256, 3)).astype(np.float32)
    pc = t_make(xyz, features=np.ones((256, 5), np.float32), bucket=256, device="cpu")
    params = CvoParams(**kw.pop("params"))
    with pytest.raises(ValueError, match=match):
        t_align(pc, pc, np.eye(4, dtype=np.float32), params, device="cpu", max_iter=1, **kw)


def test_explicit_ell_runs_small_clouds():
    """backend='ell' runs at any size, as in JAX; 'auto' would send a
    1024-point cloud to the dense 'jnp' backend."""
    xyz, xyz2, ig, _, jp = _case_1024()
    tp = convert.params_from_fields(dataclasses.asdict(jp))
    T, ret, info = t_align(t_make(xyz, bucket=1024, device="cpu"),
                           t_make(xyz2, bucket=1024, device="cpu"), ig, tp,
                           device="cpu", backend="ell", max_iter=3, nl_k=32)
    assert info.iterations == 3 and info.nl_rebuilds == 1
    assert bool(torch.all(torch.isfinite(T)))


def test_ell_loop_packs_one_scalar_block_per_iteration(monkeypatch):
    """The ELL loop builds one scalar block per iteration (pose only) and
    hands the flow's twist to the step, which builds the twist part."""
    from unified_cvo_tpu_torch.ops import ell as t_ell

    packs, twists = [], []
    real_pack, real_step = t_ell.pack_scalars, t_ell.step_cached

    def pack_spy(*a, **kw):
        packs.append(len(a) > 3 or "twist" in kw)
        return real_pack(*a, **kw)

    def step_spy(*a, twist=None, **kw):
        twists.append(twist is not None)
        return real_step(*a, twist=twist, **kw)

    monkeypatch.setattr(t_ell, "pack_scalars", pack_spy)
    monkeypatch.setattr(t_ell, "step_cached", step_spy)
    xyz, xyz2, ig, _, jp = _case_1024()
    tp = convert.params_from_fields(dataclasses.asdict(jp))
    _, _, info = t_align(t_make(xyz, bucket=1024, device="cpu"),
                         t_make(xyz2, bucket=1024, device="cpu"), ig, tp,
                         device="cpu", backend="ell", max_iter=3, nl_k=32)
    assert info.iterations == 3
    assert packs == [False] * 3 and twists == [True] * 3


@pytest.mark.parametrize("caps, flags, device, want", [
    ((1024, 1024), {}, "cpu", "jnp"),
    ((4096, 2048), {}, "cpu", "jnp"),
    ((4096, 4096), {}, "cuda", "ell"),
    ((4096, 4096), dict(is_using_geometry=0), "cpu", "jnp"),
    ((4096, 8192), dict(is_using_geometry=0), "cuda", "pallas"),
    ((2048, 8192), {}, "cuda", "pallas"),
    ((4096, 4096), dict(is_ell_adaptive=1), "cuda", "ell"),
    ((4096, 4096), dict(is_ell_adaptive=1, is_using_geometry=0, is_using_intensity=1),
     "cuda", "pallas"),
    ((4096, 4096), dict(is_ell_adaptive=1, is_using_geometry=0, is_using_intensity=1),
     "cpu", "jnp"),
], ids=["small", "one_small", "large", "no_channel_cpu", "no_channel_card", "mixed",
        "acvo", "acvo_colour_only_card", "acvo_colour_only_cpu"])
def test_auto_backend_policy_matches_jax(caps, flags, device, want):
    """JAX's auto policy (align.py:94-122), with the port's device in place of
    jax.default_backend(); resolving needs no card."""
    assert resolve_backend(CvoParams(**flags), *caps, "auto", device) == want


@pytest.mark.parametrize("flags, caps, want", [
    (dict(), (4096, 4096), "grid"),
    (dict(), (16384, 16384), "grid"),
    (dict(is_using_intensity=1), (16384, 16384), "grid"),
    (dict(ell_init=0.7), (4096, 4096), "grid"),
    (dict(ell_init=0.8), (4096, 4096), "scan"),
    (dict(), (2048, 4096), "scan"),
    (dict(), (4096, 1024), "scan"),
    (dict(is_using_geometry=0, is_using_intensity=1), (16384, 16384), "scan"),
    (dict(sigma=1.0), (4096, 4096), "scan"),
    (dict(is_ell_adaptive=1), (16384, 16384), "scan"),
    (dict(is_ell_adaptive=1, ell_max=0.7), (16384, 16384), "grid"),
], ids=["bench", "bench_16k", "colour", "support_1.85m", "support_2.11m", "small_source",
        "small_target", "no_geometry", "wide_sigma", "acvo_3.16m", "acvo_ell_max_0.7"])
def test_nl_builder_rule_matches_jax(flags, caps, want):
    """JAX's default builder (align.py:257-273): 'grid' for geometric
    configurations whose static support radius is at most 2 m with both
    clouds at 4096 points or more, else 'scan'; under adaptive ell the
    radius is scaled by ell_max / ell_init. The radius is JAX's own."""
    from unified_cvo_tpu.ops.neighbors import static_support_radius as j_radius

    params = CvoParams(**flags)
    jp = JaxParams(**dataclasses.asdict(params))
    radius = j_radius(jp) * (float(jp.ell_max) / max(float(jp.ell_init), 1e-6)
                             if jp.is_ell_adaptive else 1.0)
    jax_rule = "grid" if (bool(jp.is_using_geometry) and radius <= 2.0
                          and min(caps) >= 4096) else "scan"
    assert jax_rule == want
    assert resolve_nl_builder(params, *caps) == want
    assert resolve_nl_builder(params, *caps, "scan") == "scan"


def test_align_no_geometry_scan_matches_jax():
    """test_neighbors.py::test_align_scan_no_geometry_channel's setup: the
    kernel is pose-independent, so the value-ranked scan list is built once
    and never rebuilt, and each iteration reads only `done`."""
    rng = np.random.default_rng(0)
    jp, tp = _params(is_using_geometry=0, is_using_intensity=1, c_ell=0.3,
                       c_sigma=1.0, sp_thres=0.01, max_step=0.02)
    xyz = _scene(rng, 512, spread=4.0)
    feats = rng.uniform(0, 1, (512, 3)).astype(np.float32)
    xi = np.array([0.0, 0.002, -0.001, 0.02, 0.01, 0.05], np.float32)
    R_m, t_m = j_lie.se3_exp(jnp.asarray(xi), 1.0)
    xyz2 = np.asarray(xyz @ np.asarray(R_m).T + np.asarray(t_m))
    kw = dict(backend="ell", max_iter=60, nl_k=512)
    T_j, _, info_j = j_align(j_make(xyz, features=feats, bucket=512),
                             j_make(xyz2, features=feats, bucket=512), jnp.eye(4), jp, **kw)
    T_t, _, info_t = t_align(t_make(xyz, features=feats, bucket=512, device="cpu"),
                             t_make(xyz2, features=feats, bucket=512, device="cpu"),
                             np.eye(4, dtype=np.float32), tp, device="cpu", **kw)
    assert info_t.nl_builder == "scan"
    assert info_t.nl_rebuilds == int(info_j.nl_rebuilds) == 1
    assert int(info_t.nl_overflow) == int(info_j.nl_overflow) == 0
    assert info_t.host_reads == info_t.iterations
    assert float(np.max(np.abs(T_t.numpy() - np.asarray(T_j)))) < 2e-3


def test_align_large_support_small_cloud_matches_jax():
    """test_neighbors.py::test_align_scan_large_support_small_cloud's setup
    (support 3.3 m, 768 points) with the DEFAULT nl_builder: both sides
    choose the scan builder; poses within the JAX test's 8e-3."""
    rng = np.random.default_rng(0)
    jp, tp = _params(ell_init=3.0, ell_min=0.5, max_step=0.1)
    xyz = _scene(rng, 768)
    xi = np.array([0.001, 0.004, -0.002, 0.02, 0.01, 0.1], np.float32)
    R_m, t_m = j_lie.se3_exp(jnp.asarray(xi), 1.0)
    xyz2 = np.asarray(xyz @ np.asarray(R_m).T + np.asarray(t_m))
    kw = dict(backend="ell", max_iter=250, nl_k=640)
    T_j, _, info_j = j_align(j_make(xyz, bucket=256), j_make(xyz2, bucket=256),
                             jnp.eye(4), jp, **kw)
    T_t, _, info_t = t_align(t_make(xyz, bucket=256, device="cpu"),
                             t_make(xyz2, bucket=256, device="cpu"),
                             np.eye(4, dtype=np.float32), tp, device="cpu", **kw)
    assert info_t.nl_builder == "scan"
    assert int(info_t.nl_overflow) == int(info_j.nl_overflow) == 0
    assert float(np.max(np.abs(T_t.numpy() - np.asarray(T_j)))) < 8e-3


def test_colour_sequence_ell_matches_jax_chain(monkeypatch):
    """Two 4096-point pairs of the colour sequence with KITTI_COLOR_BENCH
    and the DEFAULT backend, max_iter=300: the port resolves to 'ell' with
    the grid builder and passes the list's channel factor to every flow
    pass, as JAX routes it; poses against the same chain through JAX."""
    from unified_cvo_tpu_torch.ops import ell as t_ell

    seen = []
    real = t_ell.flow_reduce

    def spy(*a, chan=None, use_geometry=True, **kw):
        seen.append(t_ell.variant(chan, use_geometry))
        return real(*a, chan=chan, use_geometry=use_geometry, **kw)

    monkeypatch.setattr(t_ell, "flow_reduce", spy)
    n, max_iter = 4096, 300
    frames, T_true, feats = f2f.make_sequence(n, 2, features=True)
    guess = f2f.initial_guess()
    res_t, infos = f2f.run_sequence(
        [t_make(f, features=feats, bucket=n, device="cpu") for f in frames],
        torch.from_numpy(guess), KITTI_COLOR_BENCH, device="cpu", max_iter=max_iter)
    jp = JaxParams(**dataclasses.asdict(KITTI_COLOR_BENCH))
    g = jnp.asarray(guess)
    res_j = []
    jf = [j_make(f, features=feats, bucket=n) for f in frames]
    for k in range(2):
        T, _, _ = j_align(jf[k], jf[k + 1], g, jp, max_iter=max_iter)
        g = j_lie.rt_to_mat44(*j_lie.invert_rt(*j_lie.mat44_to_rt(T)))
        res_j.append(np.asarray(T))
    assert all((i.backend, i.nl_builder) == ("ell", "grid") for i in infos)
    assert seen == ["geo_chan"] * sum(i.iterations for i in infos)
    errs_t = f2f.pose_errors(res_t, T_true)
    errs_j = f2f.pose_errors(res_j, T_true)
    assert max(errs_t) < f2f.POSE_ERROR_BOUND and max(errs_j) < f2f.POSE_ERROR_BOUND
    for T_j, T_t in zip(res_j, res_t):
        assert _pose_gap(T_j, T_t.numpy()) < POSE_TOL


def _bunny_case(moved):
    """test_pallas.py::test_align_backend_pallas_interpret_matches_jnp's
    setup; `moved` registers a rotated copy instead of the cloud itself."""
    xyz, feats = _bunnyish_cloud(np.random.default_rng(0), n=160)
    jp = JaxParams(ell_init=0.5, is_using_intensity=1, max_step=0.05,
                   ell_decay_start=5, indicator_window_size=5,
                   indicator_stable_threshold=0.2)
    xyz2 = xyz
    if moved:
        R, t = j_lie.se3_exp(jnp.asarray([0.03, -0.05, 0.04, 0.08, -0.05, 0.06]), 1.0)
        xyz2 = (xyz @ np.asarray(R).T + np.asarray(t)).astype(np.float32)
    return (jp, convert.params_from_fields(dataclasses.asdict(jp)),
            (j_make(xyz, features=feats, bucket=64), j_make(xyz2, features=feats, bucket=64)),
            (t_make(xyz, features=feats, bucket=64, device="cpu"),
             t_make(xyz2, features=feats, bucket=64, device="cpu")))


def test_pallas_backend_matches_jax_pallas_interpret():
    jp, tp, (jx, jy), (tx, ty) = _bunny_case(moved=False)
    T_j, ret_j, info_j = j_align(jx, jy, jnp.eye(4), jp, max_iter=10, backend="pallas_interpret")
    T_t, ret_t, info_t = t_align(tx, ty, np.eye(4, dtype=np.float32), tp, device="cpu",
                                 max_iter=10, backend="pallas")
    assert info_t.iterations == int(info_j.iterations) and int(ret_t) == int(ret_j)
    assert info_t.host_reads == info_t.iterations
    assert info_t.nl_overflow is None and info_t.nl_rebuilds is None
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-5)


@pytest.mark.parametrize("moved", [False, True], ids=["same_cloud", "moved"])
def test_jnp_backend_matches_jax_jnp(moved):
    jp, tp, (jx, jy), (tx, ty) = _bunny_case(moved)
    T_j, _, info_j = j_align(jx, jy, jnp.eye(4), jp, max_iter=10, chunk=64, backend="jnp")
    T_t, _, info_t = t_align(tx, ty, np.eye(4, dtype=np.float32), tp, device="cpu",
                             max_iter=10, chunk=64, backend="jnp")
    assert info_t.iterations == int(info_j.iterations)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-5)
    np.testing.assert_allclose(float(info_t.inner_product), float(info_j.inner_product),
                               rtol=1e-4)


def test_colour_sequence_dense_slice_matches_jax_chain():
    """The dense slice as a whole: two 2048-point pairs of the colour
    sequence with KITTI_COLOR_BENCH through the port's run_sequence on
    'pallas' (Morton culling, 128 x 512 tiles, plain versions of the
    kernels), against the same chain through JAX align(backend='jnp').
    Culling drops only pairs whose kernel is zero, so the poses agree."""
    n, max_iter = 2048, 30
    frames, T_true, feats = f2f.make_sequence(n, 2, features=True)
    guess = f2f.initial_guess()
    res_t, infos = f2f.run_sequence(
        [t_make(f, features=feats, bucket=n, device="cpu") for f in frames],
        torch.from_numpy(guess), KITTI_COLOR_BENCH, device="cpu", backend="pallas",
        max_iter=max_iter)
    jp = JaxParams(**dataclasses.asdict(KITTI_COLOR_BENCH))
    g = jnp.asarray(guess)
    res_j = []
    jf = [j_make(f, features=feats, bucket=n) for f in frames]
    for k in range(2):
        T, _, _ = j_align(jf[k], jf[k + 1], g, jp, max_iter=max_iter, backend="jnp")
        g = j_lie.rt_to_mat44(*j_lie.invert_rt(*j_lie.mat44_to_rt(T)))
        res_j.append(np.asarray(T))
    errs_t = f2f.pose_errors(res_t, T_true)
    errs_j = f2f.pose_errors(res_j, T_true)
    assert max(errs_t) < f2f.POSE_ERROR_BOUND and max(errs_j) < f2f.POSE_ERROR_BOUND
    for T_j, T_t in zip(res_j, res_t):
        assert _pose_gap(T_j, T_t.numpy()) < POSE_TOL
    assert all(i.host_reads == i.iterations and i.nl_rebuilds is None for i in infos)
