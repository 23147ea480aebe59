"""Adaptive ell (ACVO) in the port against the JAX package on the CPU, on
identical numpy inputs:

* the dl gradient's ingredients: weighted_d2_sum (dense, chunked) and
  weighted_d2_sum_ell (on JAX's own list, carried across), sums at rtol
  1e-5 and counts exact; stale_bound_exceeded on either side of its bound;
* ACVO align on 'jnp' (test_variants.py::test_adaptive_ell_align_converges's
  256-point colour pair): poses within |log dT| < 5e-3 of JAX's, final ell
  within 1e-3 of JAX's;
* ACVO align on 'ell' (test_variants.py::
  test_adaptive_ell_on_ell_backend_matches_dense's 4096-point pair, scan
  builder): the first two iterations equal to JAX's; then the whole solve
  at K = 96, held to JAX's own spread. The ACVO trajectory on this pair is
  chaotic: JAX itself, with its guess moved by 1e-6 m, ends at another final
  ell and, at the fixture's K = 32, at another pose (ROADMAP section 3). So
  the port's pose error and final ell must lie within the range of JAX's
  three runs (guess, guess +-1e-6 m), widened by 5e-3 and 1e-3, and its
  pose within 5e-3 of JAX's unperturbed run.

Run as a script for the bench pair (16384 points, KITTI_GEOMETRIC_BENCH with
is_ell_adaptive = 1, max_iter 1500: what chip_smoke.py phase 6 drives on
the card), through both packages on the CPU:

    JAX_PLATFORMS=cpu python tests/test_torch_acvo.py [--points 16384] [--max-iter 1500]

It prints each package's pose error, iterations, builds and final ell.
"""

import dataclasses
import sys
import time
from pathlib import Path

if __name__ == "__main__":      # as a script: the repo root and tests on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unified_cvo_tpu.config import CvoParams as JaxParams
from unified_cvo_tpu.models.align import align as j_align
from unified_cvo_tpu.ops import kernels as j_k
from unified_cvo_tpu.ops import lie as j_lie
from unified_cvo_tpu.ops import neighbors as j_nbr
from unified_cvo_tpu.utils.pointcloud import make_pointcloud as j_make
from unified_cvo_tpu_torch import convert
from unified_cvo_tpu_torch.apps import f2f_sequence as f2f
from unified_cvo_tpu_torch.config import KITTI_GEOMETRIC_BENCH
from unified_cvo_tpu_torch.models.align import align as t_align
from unified_cvo_tpu_torch.ops import kernels as t_k
from unified_cvo_tpu_torch.ops import lie as t_lie
from unified_cvo_tpu_torch.ops import neighbors as t_nbr
from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud as t_make

from test_align import _bunnyish_cloud
from test_kernels import _random_clouds

torch.set_num_threads(1)

POSE_TOL = 5e-3
ELL_TOL = 1e-3


def _tp(jp):
    return convert.params_from_fields(dataclasses.asdict(jp))


def _log_norm(T):
    T = torch.as_tensor(np.asarray(T, np.float32))
    return float(torch.linalg.vector_norm(t_lie.se3_log(T[:3, :3], T[:3, 3])))


def _pose_gap(T_a, T_b):
    return _log_norm(np.asarray(T_a, np.float64) @ np.linalg.inv(np.asarray(T_b, np.float64)))


@pytest.mark.parametrize("chunk", [8, 64], ids=["chunked", "one_chunk"])
def test_weighted_d2_sum_matches_jax(chunk):
    rng = np.random.default_rng(0)
    x, y, _, _ = _random_clouds(rng, n=40, m=56)
    jp = JaxParams(sp_thres=0.002)
    jx, jy = j_make(x, bucket=8), j_make(y, bucket=8)
    tx, ty = t_make(x, bucket=8, device="cpu"), t_make(y, bucket=8, device="cpu")
    for a, b, c, d in ((jx, jy, tx, ty), (jx, jx, tx, tx)):
        sj, nj = j_k.weighted_d2_sum(jp, jnp.float32(0.5), a, b, chunk)
        st, nt = t_k.weighted_d2_sum(_tp(jp), torch.tensor(0.5), c, d, chunk)
        assert nt.dtype == torch.int32 and int(nt) == int(nj) > 0
        np.testing.assert_allclose(float(st), float(sj), rtol=1e-5)


def _ell_lists(builder):
    """JAX's xy, xx and yy lists of a 2048-point scene pair (the xy and yy
    lists at a moved pose), and the same lists in the port's form."""
    rng = np.random.default_rng(1)
    n = 2048
    xyz = np.stack([rng.uniform(-12, 12, n), rng.uniform(-2, 2, n), rng.uniform(2, 50, n)],
                   axis=1).astype(np.float32)
    xyz2 = (xyz + rng.normal(scale=0.05, size=xyz.shape)).astype(np.float32)
    jp = JaxParams(ell_init=0.4, sp_thres=0.0006, is_using_geometry=1)
    R, t = (np.array(v) for v in j_lie.se3_exp(
        jnp.asarray(np.float32([0.002, -0.003, 0.001, 0.03, 0.01, -0.02])), 1.0))
    js, jt = j_make(xyz, bucket=n), j_make(xyz2, bucket=n)
    ts, tt = t_make(xyz, bucket=n, device="cpu"), t_make(xyz2, bucket=n, device="cpu")
    eye = np.eye(3, dtype=np.float32)
    zero = np.zeros(3, np.float32)
    # jitted, as JAX align runs the builders (eager dispatch is slow)
    build = jax.jit(j_nbr.build_neighbor_list if builder == "grid"
                    else j_nbr.build_neighbor_list_scan, static_argnums=(0,),
                    static_argnames=("k", "skin"))
    out = []
    for jx, jy, tx, pose in ((js, jt, ts, (R, t)), (js, js, ts, (eye, zero)),
                             (jt.transformed(jnp.asarray(R), jnp.asarray(t)), jt,
                              tt.transformed(torch.from_numpy(R), torch.from_numpy(t)),
                              (R, t))):
        nl = build(jp, jnp.float32(0.4), jx, jy, jnp.asarray(pose[0]), jnp.asarray(pose[1]),
                   k=32, skin=0.5)
        tl = convert.neighbor_list_from_numpy(
            **{f: None if getattr(nl, f) is None else np.asarray(getattr(nl, f))
               for f in nl._fields}, device="cpu")
        out.append((jx, nl, tx, tl, pose))
    return jp, out


@pytest.mark.parametrize("builder", ["grid", "scan"])
def test_weighted_d2_sum_ell_matches_jax(builder):
    """The three sums of the ELL gradient on JAX's own lists, at the build
    ell and at a grown one (more pairs pass the gate)."""
    jp, lists = _ell_lists(builder)
    for ell in (0.4, 0.55):
        for jx, nl, tx, tl, (R, t) in lists:
            sj, nj = j_nbr.weighted_d2_sum_ell(jp, jnp.float32(ell), jx, nl, jnp.asarray(R),
                                               jnp.asarray(t))
            st, nt = t_nbr.weighted_d2_sum_ell(_tp(jp), torch.tensor(ell), tx, tl,
                                               torch.from_numpy(R), torch.from_numpy(t))
            assert int(nt) == int(nj) > 0
            np.testing.assert_allclose(float(st), float(sj), rtol=1e-5)


def test_stale_bound_exceeded_matches_jax():
    """Poses and ell values that put drift + k_lin max(ell - ell_build, 0)
    just below and just above the skin, on JAX's xy list."""
    jp, lists = _ell_lists("grid")
    _, nl, _, tl, (R, t) = lists[0]
    checked = {True: 0, False: 0}
    for dt, ell in ((0.01, 0.4), (0.05, 0.4), (0.0, 0.5), (0.03, 0.45), (0.02, 0.3)):
        T = (t + np.float32([dt, 0.0, 0.0])).astype(np.float32)
        drift = float(np.linalg.norm(T - np.asarray(nl.pose_build[9:])))
        value = drift + float(nl.k_lin) * max(ell - float(nl.ell_build), 0.0)
        for skin, want in ((value * 0.999, True), (value * 1.001 + 1e-6, False)):
            bj = bool(j_nbr.stale_bound_exceeded(nl, jnp.asarray(R), jnp.asarray(T),
                                                 jnp.float32(ell), skin))
            bt = t_nbr.stale_bound_exceeded(tl, torch.from_numpy(R), torch.from_numpy(T),
                                            torch.tensor(ell), skin)
            assert bt.dtype == torch.bool and bool(bt) == bj == want, (dt, ell, skin)
            checked[want] += 1
    assert checked == {True: 5, False: 5}


def _acvo_colour_pair():
    rng = np.random.default_rng(0)
    xyz, feats = _bunnyish_cloud(rng, n=256)
    xi = np.array([0.02, -0.03, 0.02, 0.05, -0.03, 0.04], np.float32)
    R, t = (np.array(v) for v in j_lie.se3_exp(jnp.asarray(xi), 1.0))
    y = (xyz @ R.T + t).astype(np.float32)
    jp = JaxParams(ell_init=0.4, ell_min=0.05, ell_max=1.0, dl_step=0.3, is_ell_adaptive=1,
                   is_using_intensity=1, max_step=0.05, min_step=1e-6, sp_thres=0.0006)
    return xyz, y, feats, np.array(j_lie.rt_to_mat44(jnp.asarray(R), jnp.asarray(t))), jp


def test_acvo_jnp_matches_jax():
    xyz, y, feats, T_true, jp = _acvo_colour_pair()
    kw = dict(max_iter=800, chunk=256)
    T_j, _, info_j = j_align(j_make(xyz, features=feats, bucket=64),
                             j_make(y, features=feats, bucket=64), jnp.eye(4), jp, **kw)
    T_t, ret, info_t = t_align(t_make(xyz, features=feats, bucket=64, device="cpu"),
                               t_make(y, features=feats, bucket=64, device="cpu"),
                               np.eye(4, dtype=np.float32), _tp(jp), device="cpu", **kw)
    assert info_t.backend == "jnp" and int(ret) == 0
    assert _pose_gap(T_t.numpy(), T_j) < POSE_TOL
    assert abs(float(info_t.final_ell) - float(info_j.final_ell)) < ELL_TOL
    assert abs(float(info_t.final_ell) - jp.ell_init) > 1e-4
    assert _log_norm(T_t.numpy() @ T_true) < 0.05


def _acvo_ell_pair():
    rng = np.random.default_rng(0)
    xyz, _ = _bunnyish_cloud(rng, n=4096)
    xyz = (xyz * 3.0).astype(np.float32)
    xi = np.array([0.01, -0.02, 0.01, 0.04, -0.02, 0.03], np.float32)
    R, t = (np.array(v) for v in j_lie.se3_exp(jnp.asarray(xi), 1.0))
    y = (xyz @ R.T + t).astype(np.float32)
    jp = JaxParams(ell_init=0.4, ell_min=0.05, ell_max=1.0, dl_step=0.3, is_ell_adaptive=1,
                   is_using_geometry=1, max_step=0.05, min_step=1e-6, sp_thres=0.0006)
    return xyz, y, np.array(j_lie.rt_to_mat44(jnp.asarray(R), jnp.asarray(t))), jp


def _run_ell(xyz, y, jp, guess, **kw):
    kw = {"max_iter": 500, "chunk": 1024, "backend": "ell", **kw}
    T_j, _, info_j = j_align(j_make(xyz, bucket=4096), j_make(y, bucket=4096),
                             jnp.asarray(guess), jp, **kw)
    return np.asarray(T_j), info_j


def test_acvo_ell_first_iterations_match_jax():
    """Two iterations from the same guess: the same sums, the same ell
    steps, the same pose to f32 rounding, the same builder and builds."""
    xyz, y, _, jp = _acvo_ell_pair()
    T_j, info_j = _run_ell(xyz, y, jp, np.eye(4, dtype=np.float32), max_iter=2)
    T_t, _, info_t = t_align(t_make(xyz, bucket=4096, device="cpu"),
                             t_make(y, bucket=4096, device="cpu"), np.eye(4, dtype=np.float32),
                             _tp(jp), device="cpu", backend="ell", max_iter=2, chunk=1024)
    assert (info_t.backend, info_t.nl_builder) == ("ell", "scan")
    assert info_t.iterations == int(info_j.iterations) == 2
    assert info_t.nl_rebuilds == int(info_j.nl_rebuilds) == 1
    assert int(info_t.nl_overflow) == int(info_j.nl_overflow)
    assert int(info_t.nonzeros) == int(info_j.nonzeros)
    np.testing.assert_allclose(float(info_t.final_ell), float(info_j.final_ell), rtol=1e-5)
    assert float(info_t.final_ell) > jp.ell_init
    assert _pose_gap(T_t.numpy(), T_j) < 1e-5
    assert info_t.host_reads == 2


def test_acvo_ell_within_jax_spread():
    """At K = 96 (the list binds on fewer rows than at the fixture's 32,
    where JAX's own spread reaches from 7.7e-5 to 0.031 in pose error and
    from 0.14 to 1.0 in final ell)."""
    nl_k = 96
    xyz, y, T_true, jp = _acvo_ell_pair()
    runs = []
    for dt in (0.0, 1e-6, -1e-6):
        guess = np.eye(4, dtype=np.float32)
        guess[0, 3] = dt
        runs.append(_run_ell(xyz, y, jp, guess, nl_k=nl_k))
    T_t, _, info_t = t_align(t_make(xyz, bucket=4096, device="cpu"),
                             t_make(y, bucket=4096, device="cpu"), np.eye(4, dtype=np.float32),
                             _tp(jp), device="cpu", backend="ell", max_iter=500, chunk=1024,
                             nl_k=nl_k)
    errs = [_log_norm(T @ T_true) for T, _ in runs]
    ells = [float(i.final_ell) for _, i in runs]
    err_t, ell_t = _log_norm(T_t.numpy() @ T_true), float(info_t.final_ell)
    assert info_t.nl_rebuilds >= 1 and info_t.host_reads == info_t.iterations
    assert min(errs) - POSE_TOL <= err_t <= max(errs) + POSE_TOL, (err_t, errs)
    assert min(ells) - ELL_TOL <= ell_t <= max(ells) + ELL_TOL, (ell_t, ells)
    assert err_t < 0.05 and abs(ell_t - jp.ell_init) > 1e-4
    assert _pose_gap(T_t.numpy(), runs[0][0]) < POSE_TOL


def bench_pair(n: int, max_iter: int):
    """Frames 0 -> 1 of the bench sequence at n points with
    KITTI_GEOMETRIC_BENCH and is_ell_adaptive = 1, from the bench guess,
    through JAX align and the port's on the CPU (default backend and
    builder on both). Returns {package: (pose error, info)}."""
    frames, T_true = f2f.make_sequence(n, 1)
    guess = f2f.initial_guess()
    params = KITTI_GEOMETRIC_BENCH.replace(is_ell_adaptive=1)
    jp = JaxParams(**dataclasses.asdict(params))
    out = {}
    t0 = time.perf_counter()
    T_j, _, info_j = j_align(j_make(frames[0], bucket=n), j_make(frames[1], bucket=n),
                             jnp.asarray(guess), jp, max_iter=max_iter)
    out["jax"] = (_log_norm(np.asarray(T_j) @ T_true[0]), info_j, time.perf_counter() - t0,
                  np.asarray(T_j))
    t0 = time.perf_counter()
    T_t, _, info_t = t_align(t_make(frames[0], bucket=n, device="cpu"),
                             t_make(frames[1], bucket=n, device="cpu"), guess, params,
                             device="cpu", max_iter=max_iter)
    out["port"] = (_log_norm(T_t.numpy() @ T_true[0]), info_t, time.perf_counter() - t0,
                   T_t.numpy())
    return out


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="ACVO on the bench pair through JAX and the "
                                             "port, on the CPU")
    ap.add_argument("--points", type=int, default=16384)
    ap.add_argument("--max-iter", type=int, default=1500)
    args = ap.parse_args(argv)
    out = bench_pair(args.points, args.max_iter)
    for name, (err, info, sec, _) in out.items():
        print(f"{name}: pose error {err:.6f}, iterations {int(info.iterations)}, builds "
              f"{int(info.nl_rebuilds)}, final ell {float(info.final_ell):.6f}, overflow "
              f"{int(info.nl_overflow)}, {sec:.1f} s", flush=True)
    print(f"poses apart: {_pose_gap(out['jax'][3], out['port'][3]):.6f}; port backend "
          f"{out['port'][1].backend}, builder {out['port'][1].nl_builder}")


if __name__ == "__main__":
    main()
