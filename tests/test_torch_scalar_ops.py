"""Scalar glue of the align loop in the PyTorch port (ops/lie.py, ops/poly.py,
ops/indicator.py) against the JAX package on the seeds and cases of
test_lie.py, test_poly.py and test_indicator.py.

Tolerances: lie atol 1e-5 (f32 transcendental rounding); poly step rtol
1e-5; indicator decisions equal and window sums rtol 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unified_cvo_tpu.ops import indicator as j_ind
from unified_cvo_tpu.ops import lie as j_lie
from unified_cvo_tpu.ops import poly as j_poly
from unified_cvo_tpu_torch.ops import indicator as t_ind
from unified_cvo_tpu_torch.ops import lie as t_lie
from unified_cvo_tpu_torch.ops import poly as t_poly

torch.set_num_threads(1)

LIE_ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(port, ref, atol=LIE_ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol, rtol=0)


@pytest.mark.parametrize("seed", range(5))
def test_so3_exp_matches_jax(seed):
    w = np.random.default_rng(seed).normal(size=3).astype(np.float32)
    _close(t_lie.so3_exp(_t(w)), j_lie.so3_exp(jnp.asarray(w)))


def test_so3_exp_small_angle_branch():
    w = np.array([1e-9, -1e-9, 1e-9], np.float32)
    _close(t_lie.so3_exp(_t(w)), j_lie.so3_exp(jnp.asarray(w)), atol=1e-7)


@pytest.mark.parametrize("dt", [1.0, 0.01, 0.73])
@pytest.mark.parametrize("seed", range(3))
def test_se3_exp_matches_jax(dt, seed):
    xi = np.random.default_rng(seed).normal(size=6).astype(np.float32)
    xi /= np.linalg.norm(xi)
    R, t = t_lie.se3_exp(_t(xi), dt)
    Rj, tj = j_lie.se3_exp(jnp.asarray(xi), dt)
    _close(R, Rj)
    _close(t, tj)


def test_se3_exp_tensor_dt_and_small_angle():
    """The align loop passes the step as a 0-d tensor; pure translation
    takes the small-angle branch."""
    xi = np.array([0, 0, 0, 1.0, 2.0, -1.0], np.float32)
    R, t = t_lie.se3_exp(_t(xi), torch.tensor(0.25))
    Rj, tj = j_lie.se3_exp(jnp.asarray(xi), 0.25)
    _close(R, Rj)
    _close(t, tj)


@pytest.mark.parametrize("seed", range(5))
def test_se3_log_matches_jax(seed):
    xi = 0.5 * np.random.default_rng(seed).normal(size=6).astype(np.float32)
    Rj, tj = j_lie.se3_exp(jnp.asarray(xi), 1.0)
    R, t = _t(Rj), _t(tj)
    _close(t_lie.se3_log(R, t), j_lie.se3_log(Rj, tj))
    _close(t_lie.so3_log(R), j_lie.so3_log(Rj))


def test_so3_log_small_angle_branch():
    Rj = j_lie.so3_exp(jnp.asarray([2e-4, -1e-4, 3e-4], jnp.float32))
    _close(t_lie.so3_log(_t(Rj)), j_lie.so3_log(Rj), atol=1e-7)


@pytest.mark.parametrize("dt", [1e-4, 0.01, 0.5])
def test_se3_distance_matches_jax(dt):
    xi = np.random.default_rng(1).normal(size=6).astype(np.float32)
    xi /= np.linalg.norm(xi)
    Rj, tj = j_lie.se3_exp(jnp.asarray(xi), dt)
    _close(t_lie.se3_distance(_t(Rj), _t(tj)), j_lie.se3_distance(Rj, tj))


def test_invert_rt_and_mat44_match_jax():
    xi = np.random.default_rng(2).normal(size=6).astype(np.float32)
    Rj, tj = j_lie.se3_exp(jnp.asarray(xi), 1.0)
    Ri, ti = t_lie.invert_rt(_t(Rj), _t(tj))
    Rij, tij = j_lie.invert_rt(Rj, tj)
    _close(Ri, Rij)
    _close(ti, tij)
    T = t_lie.rt_to_mat44(Ri, ti)
    _close(T, j_lie.rt_to_mat44(Rij, tij))
    R2, t2 = t_lie.mat44_to_rt(T)
    _close(R2, Rij)
    _close(t2, tij)


def test_skew_matches_jax():
    w = np.array([0.3, -1.2, 2.5], np.float32)
    _close(t_lie.skew(_t(w)), j_lie.skew(jnp.asarray(w)), atol=0)


# ---------------------------------------------------------------- poly


@pytest.mark.parametrize("seed", range(20))
def test_step_from_poly_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, C, D, E = (np.float32(v) for v in rng.normal(scale=10.0, size=4))
    got = float(t_poly.step_from_poly(*(torch.tensor(v) for v in (B, C, D, E)),
                                      2e-5, 0.8))
    want = float(j_poly.step_from_poly(B, C, D, E, 2e-5, 0.8))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("coefs", [
    (1.0, -6.0, 11.0, -6.0),    # three real roots
    (1.0, 0.0, 1.0, 1.0),       # one real root (Cardano)
    (0.0, 1.0, -3.0, 2.0),      # quadratic fallback
    (0.0, 0.0, 2.0, -1.0),      # linear fallback
    (0.0, 0.0, 0.0, 1.0),       # no root at all
], ids=["three_real", "cardano", "quadratic", "linear", "none"])
def test_cubic_branches_match_jax(coefs):
    roots, valid = t_poly.cubic_real_roots(*(torch.tensor(c) for c in coefs))
    rj, vj = j_poly.cubic_real_roots(*coefs)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(vj))
    np.testing.assert_allclose(roots.numpy(), np.asarray(rj), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("BCDE,want", [
    ((6.0, 11.0, 6.0, 1.0), 0.8),       # no positive root -> max_step
    ((-4e-8, 1.0, 0.0, 0.0), 2e-5),     # root below min_step -> min_step
])
def test_step_clamps_match_jax(BCDE, want):
    got = float(t_poly.step_from_poly(*(torch.tensor(v) for v in BCDE), 2e-5, 0.8))
    assert got == pytest.approx(float(j_poly.step_from_poly(*BCDE, 2e-5, 0.8)), rel=1e-5)
    assert got == pytest.approx(want)


# ----------------------------------------------------------- indicator


@functools.lru_cache(maxsize=None)
def _jax_update():
    return jax.jit(j_ind.update)


def _sequence(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        np.linspace(0.1, 1.0, 40) + rng.normal(scale=0.02, size=40),
        1.0 + rng.normal(scale=0.005, size=60),
    ]).astype(np.float32)


@pytest.mark.parametrize("window,thr", [(5, 0.2), (15, 0.2), (10, 0.001)])
@pytest.mark.parametrize("seed", range(3))
def test_indicator_matches_jax(window, thr, seed):
    st_j = j_ind.init_state(window)
    st_t = t_ind.init_state(window)
    upd = _jax_update()
    for step, x in enumerate(_sequence(seed)):
        st_j, dec_j = upd(st_j, float(x), thr)
        st_t, dec_t = t_ind.update(st_t, torch.tensor(x), thr)
        assert bool(dec_t) == bool(dec_j), f"step {step}"
        np.testing.assert_allclose(float(st_t.ssum), float(st_j.ssum), rtol=1e-6)
        np.testing.assert_allclose(float(st_t.esum), float(st_j.esum), rtol=1e-6)
        assert int(st_t.scnt) == int(st_j.scnt)
        assert int(st_t.ecnt) == int(st_j.ecnt)
        assert int(st_t.shead) == int(st_j.shead)
        assert int(st_t.ehead) == int(st_j.ehead)


def test_indicator_decreases_on_stable_signal_like_jax():
    W, thr = 8, 0.2
    st_j, st_t = j_ind.init_state(W), t_ind.init_state(W)
    upd = _jax_update()
    fired = []
    for _ in range(3 * W):
        st_j, dj = upd(st_j, 0.5, thr)
        st_t, dt = t_ind.update(st_t, torch.tensor(0.5), thr)
        assert bool(dt) == bool(dj)
        fired.append(bool(dt))
    assert any(fired)
