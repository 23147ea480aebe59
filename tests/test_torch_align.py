"""The whole frame-to-frame slice of the PyTorch port (models/align.py on the
ELL path, apps/f2f_sequence.py) against JAX align(backend='ell',
nl_builder='grid') on the CPU, on identical numpy inputs.

Poses compare by |log(T_jax T_port^-1)| < 5e-3, and both must stay within
the 0.05 pose-error bound. Iteration counts are not compared unless both hit
the cap: f32 reduction order perturbs each step by ~1e-4 relative and the
threshold-driven schedule amplifies that (PERF.md, "Fused-vs-jnp consume
drift").
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
from unified_cvo_tpu_torch.config import KITTI_GEOMETRIC_BENCH, CvoParams
from unified_cvo_tpu_torch.models.align import align as t_align
from unified_cvo_tpu_torch.ops import lie as t_lie
from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud as t_make

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


@pytest.mark.parametrize("case", ["channels", "acvo", "scan", "small_auto", "dense"])
def test_configurations_outside_the_slice_raise(case):
    rng = np.random.default_rng(5)
    n = 1024 if case == "small_auto" else 4096
    xyz = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    pc = t_make(xyz, bucket=n, device="cpu")
    params, kw = CvoParams(), {}
    if case == "channels":
        params = params.replace(is_using_intensity=1)
    elif case == "acvo":
        params = params.replace(is_ell_adaptive=1)
    elif case == "scan":
        kw = dict(nl_builder="scan")
    elif case == "dense":
        kw = dict(backend="pallas")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_align(pc, pc, np.eye(4, dtype=np.float32), params, device="cpu", **kw)


def test_explicit_ell_runs_small_clouds():
    """backend='ell' runs at any size, as in JAX; 'auto' would send a
    1024-point cloud to a dense backend."""
    xyz, xyz2, ig, _, jp = _case_1024()
    tp = convert.params_from_fields(dataclasses.asdict(jp))
    T, ret, info = t_align(t_make(xyz, bucket=1024, device="cpu"),
                           t_make(xyz2, bucket=1024, device="cpu"), ig, tp,
                           device="cpu", backend="ell", max_iter=3, nl_k=32)
    assert info.iterations == 3 and info.nl_rebuilds == 1
    assert bool(torch.all(torch.isfinite(T)))
