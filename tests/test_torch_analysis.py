"""The port's analysis entry points and the dense streaming passes under
them against the JAX package on the CPU, on identical numpy inputs:
kernel_block_dense, association_topk(_dense) and least_square_flow
(ops/kernels.py); inner_product, function_angle (approximate and exact),
compute_association and compute_association_non_isotropic, and
record_history (models/align.py).

Values compare at rtol 1e-5 (least_square_flow, a 6x6 solve, at 1e-4).
Top-k indices compare exactly where a row's values are distinct, and as
sets among the entries above the row's last kept value otherwise: equal
values may come out of torch.topk and lax.top_k in another order. Inlier
masks compare exactly. History compares its first 20 entries at rtol 1e-4:
the trajectory is chaotic later (ROADMAP section 3).
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unified_cvo_tpu.config import CvoParams as JaxParams
from unified_cvo_tpu.ops import kernels as j_k
from unified_cvo_tpu.ops import lie as j_lie
from unified_cvo_tpu.utils.pointcloud import make_pointcloud as j_make
from unified_cvo_tpu_torch import convert
from unified_cvo_tpu_torch import models as t_models
from unified_cvo_tpu_torch.ops import kernels as t_k
from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud as t_make

from test_align import _bunnyish_cloud
from test_kernels import _random_clouds

# the packages' models/__init__ export the function `align` under the
# module's name
j_align = importlib.import_module("unified_cvo_tpu.models.align")
t_align = importlib.import_module("unified_cvo_tpu_torch.models.align")

torch.set_num_threads(1)

CHANNELS = {
    "geometry": dict(),
    "colour": dict(is_using_intensity=1, c_ell=0.5),
    "all": dict(is_using_intensity=1, is_using_semantics=1, is_using_geometric_type=1,
                c_ell=0.5, s_ell=0.5, sp_thres=1e-4),
}


def _tp(jp):
    return convert.params_from_fields(dataclasses.asdict(jp))


def _clouds(x, y, kw_x, kw_y, bucket=8):
    return (j_make(x, bucket=bucket, **kw_x), j_make(y, bucket=bucket, **kw_y),
            t_make(x, bucket=bucket, device="cpu", **kw_x),
            t_make(y, bucket=bucket, device="cpu", **kw_y))


def _assert_topk_equal(vt, it, vj, ij):
    vt, it, vj, ij = (np.asarray(a) for a in (vt, it, vj, ij))
    np.testing.assert_allclose(vt, vj, rtol=1e-5, atol=0)
    assert np.array_equal(it == -1, ij == -1) and np.array_equal(vt > 0, vj > 0)
    distinct = np.ones_like(vj, bool)
    distinct[:, 1:] &= vj[:, 1:] != vj[:, :-1]
    distinct[:, :-1] &= vj[:, :-1] != vj[:, 1:]
    assert np.array_equal(it[distinct], ij[distinct])
    for r in range(len(vj)):
        above = vj[r] > vj[r, -1]
        assert set(it[r][above].tolist()) == set(ij[r][above].tolist()), r


@pytest.mark.parametrize("channels", list(CHANNELS))
def test_kernel_block_dense_matches_jax(channels):
    """test_variants.py::test_dense_kernel_matches_oracle's clouds and
    diagonal kernel, with each channel set."""
    rng = np.random.default_rng(0)
    x, y, kw_x, kw_y = _random_clouds(rng, n=30, m=40, features=True, labels=True, geo=True)
    jp = JaxParams(**{"sp_thres": 0.002, **CHANNELS[channels]})
    Kinv = np.linalg.inv(np.diag([0.3, 0.3, 0.5])).astype(np.float32)
    jx, jy, tx, ty = _clouds(x, y, kw_x, kw_y)
    want = np.asarray(j_k.kernel_block_dense(jp, jnp.asarray(Kinv), jx, jy))
    got = t_k.kernel_block_dense(_tp(jp), torch.from_numpy(Kinv), tx, ty).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert np.array_equal(got > 0, want > 0) and (want > 0).sum() > 0


@pytest.mark.parametrize("dense", [False, True], ids=["isotropic", "non_isotropic"])
def test_association_topk_matches_jax(dense):
    """test_kernels.py::test_association_topk's clouds (k = 8, chunks of 8,
    so every chunk merges into the running top-k), and the non-isotropic
    form with test_variants.py's kernel 0.25 I."""
    rng = np.random.default_rng(0)
    x, y, _, _ = _random_clouds(rng, n=24, m=40)
    jp = JaxParams(sp_thres=0.002)
    jx, jy, tx, ty = _clouds(x, y, {}, {})
    if dense:
        Kinv = np.linalg.inv(np.eye(3, dtype=np.float32) * 0.25).astype(np.float32)
        vj, ij = j_k.association_topk_dense(jp, jnp.asarray(Kinv), jx, jy, 8, chunk=8)
        vt, it = t_k.association_topk_dense(_tp(jp), torch.from_numpy(Kinv), tx, ty, 8,
                                            chunk=8)
    else:
        vj, ij = j_k.association_topk(jp, jnp.float32(0.5), jx, jy, 8, chunk=8)
        vt, it = t_k.association_topk(_tp(jp), torch.tensor(0.5), tx, ty, 8, chunk=8)
    assert vt.shape == it.shape == (24, 8) and it.dtype == torch.int32
    _assert_topk_equal(vt, it, vj, ij)


def test_least_square_flow_matches_jax():
    """test_variants.py::test_least_square_flow_matches_brute_force's pairs."""
    rng = np.random.default_rng(0)
    x, _, _, _ = _random_clouds(rng, n=30, m=40)
    x = (0.1 * x).astype(np.float32)
    y = x + rng.normal(scale=0.03, size=x.shape).astype(np.float32)
    jp = JaxParams(sp_thres=0.002)
    jx, jy, tx, ty = _clouds(x, y, {}, {})
    wj = j_k.least_square_flow(jp, jnp.float32(0.4), jx, jy, chunk=8)
    wt = t_k.least_square_flow(_tp(jp), torch.tensor(0.4), tx, ty, chunk=8)
    for g, w in zip(wt, wj):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-7)


def _pair(n=400, seed=3):
    """test_align.py's sphere-and-plane cloud with intensity, and the same
    cloud moved by a small twist."""
    rng = np.random.default_rng(seed)
    xyz, feats = _bunnyish_cloud(rng, n=n)
    xi = np.array([0.03, -0.05, 0.04, 0.08, -0.05, 0.06], np.float32)
    R, t = (np.array(v) for v in j_lie.se3_exp(jnp.asarray(xi), 1.0))
    y = (xyz @ R.T + t).astype(np.float32)
    # the entry points move the target by the inverse of the transform
    return xyz, y, feats, np.array(j_lie.rt_to_mat44(jnp.asarray(R), jnp.asarray(t)))


@pytest.mark.parametrize("approximate", [True, False], ids=["approximate", "exact"])
@pytest.mark.parametrize("channels", ["geometry", "colour"])
def test_function_angle_matches_jax(approximate, channels):
    """function_angle at the identity and at the true transform, and
    inner_product at the true transform; the angle grows toward the truth
    on both sides."""
    xyz, y, feats, T = _pair()
    jp = JaxParams(ell_init=0.5, is_using_geometry=1, **CHANNELS[channels])
    jx, jy, tx, ty = _clouds(xyz, y, dict(features=feats), dict(features=feats), bucket=64)
    out = {}
    for name, M in (("identity", np.eye(4, dtype=np.float32)), ("truth", T)):
        cj = float(j_align.function_angle(jx, jy, jnp.asarray(M), 0.5, jp,
                                          approximate=approximate, chunk=64))
        ct = t_align.function_angle(tx, ty, M, 0.5, _tp(jp), approximate=approximate,
                                    chunk=64, device="cpu")
        assert ct.dtype == torch.float32 and ct.shape == ()
        np.testing.assert_allclose(float(ct), cj, rtol=1e-5)
        out[name] = float(ct)
    assert out["truth"] > out["identity"]
    ipj = float(j_align.inner_product(jx, jy, jnp.asarray(T), 0.5, jp, chunk=64))
    ipt = t_models.inner_product(tx, ty, T, 0.5, _tp(jp), chunk=64, device="cpu")
    np.testing.assert_allclose(float(ipt), ipj, rtol=1e-5)


@pytest.mark.parametrize("moved", [False, True], ids=["self", "moved"])
def test_compute_association_matches_jax(moved):
    """test_align.py::test_association_export_shapes's self-association
    (every valid point among its own strongest four), and the moved pair at
    its true transform."""
    xyz, y, feats, T = _pair(n=120)
    jp = JaxParams(is_using_intensity=1)
    target, M = (y, T) if moved else (xyz, np.eye(4, dtype=np.float32))
    jx, jy, tx, ty = _clouds(xyz, target, dict(features=feats), dict(features=feats),
                             bucket=64)
    vj, ij, sj, tj = j_align.compute_association(jx, jy, jnp.asarray(M), 0.1, jp, top_k=16,
                                                 chunk=64)
    vt, it, st, tt = t_models.compute_association(tx, ty, M, 0.1, _tp(jp), top_k=16,
                                                  chunk=64, device="cpu")
    assert vt.shape == it.shape == (128, 16) and st.dtype == tt.dtype == torch.bool
    _assert_topk_equal(vt, it, vj, ij)
    assert np.array_equal(st.numpy(), np.asarray(sj))
    assert np.array_equal(tt.numpy(), np.asarray(tj))
    assert st[:120].all() and not st[120:].any() and not tt[120:].any()
    if not moved:
        assert all(i in it[i, :4].tolist() for i in range(120))


def test_compute_association_non_isotropic_matches_jax():
    """A diagonal 3x3 kernel at the true transform; every channel on, so the
    forced-off geometric-type gate shows."""
    xyz, y, feats, T = _pair(n=120)
    rng = np.random.default_rng(1)
    geo = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 120)]
    jp = JaxParams(is_using_intensity=1, is_using_geometric_type=1, sp_thres=0.002)
    kw = dict(features=feats, geometric_types=geo)
    jx, jy, tx, ty = _clouds(xyz, y, kw, kw, bucket=64)
    K = np.diag([0.04, 0.04, 0.09]).astype(np.float32)
    vj, ij, sj, tj = j_align.compute_association_non_isotropic(jx, jy, jnp.asarray(T),
                                                               jnp.asarray(K), jp, top_k=16,
                                                               chunk=64)
    vt, it, st, tt = t_models.compute_association_non_isotropic(
        tx, ty, T, K, _tp(jp), top_k=16, chunk=64, device="cpu")
    _assert_topk_equal(vt, it, vj, ij)
    assert np.array_equal(st.numpy(), np.asarray(sj))
    assert np.array_equal(tt.numpy(), np.asarray(tj))
    assert int(st.sum()) > 0


@pytest.mark.parametrize("backend", ["jnp", "ell"])
def test_record_history_matches_jax(backend):
    """The six [max_iter] history arrays, zero past the last iteration,
    against JAX's on its 'jnp' backend and on 'ell' (JAX's jnp consume)."""
    xyz, y, feats, T = _pair(n=512, seed=5)
    jp = JaxParams(ell_init=0.4, max_step=0.05, ell_decay_start=5, is_using_geometry=1)
    jx, jy, tx, ty = _clouds(xyz, y, dict(features=feats), dict(features=feats), bucket=64)
    kw = dict(max_iter=60, chunk=64, backend=backend)
    if backend == "ell":
        kw.update(nl_k=64, nl_builder="scan")
    _, _, ij = j_align.align(jx, jy, jnp.eye(4), jp, record_history=True, **kw)
    _, _, it = t_align.align(tx, ty, np.eye(4, dtype=np.float32), _tp(jp), device="cpu",
                             record_history=True, **kw)
    _, _, plain = t_align.align(tx, ty, np.eye(4, dtype=np.float32), _tp(jp), device="cpu",
                                **kw)
    assert plain.history is None and it.history is not None
    assert set(it.history) == set(ij.history) == set(t_align.HISTORY_KEYS)
    k = it.iterations
    assert k > 20
    for name, h in it.history.items():
        assert h.shape == (60,) and h.dtype == torch.float32
        assert not h[k:].any(), name
        np.testing.assert_allclose(h[:20].numpy(), np.asarray(ij.history[name])[:20],
                                   rtol=1e-4, atol=1e-7, err_msg=name)
    assert torch.equal(it.history["nonzeros"][:k], it.history["nonzeros"][:k].round())
