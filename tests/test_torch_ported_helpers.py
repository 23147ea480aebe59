"""Small public helpers of the JAX package and their port, on the same numpy
inputs: ops/lie.py's `orthogonalize` and `transform_points` (the calls of
test_lie.py), ops/neighbors.py's exact Verlet trigger `drift_exceeded`
(targets moved just inside and just past the skin, by a translation and by
a rotation), and utils/pointcloud.py's `concatenate` (with and without
features, labels and geometric types).

Tolerances: lie atol 1e-6 (the same float32 products in the same order);
the drift decision equal; concatenation equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from unified_cvo_tpu.config import CvoParams as JaxParams
from unified_cvo_tpu.ops import lie as j_lie
from unified_cvo_tpu.ops import neighbors as j_nbr
from unified_cvo_tpu.utils import pointcloud as j_pc
from unified_cvo_tpu_torch import convert
from unified_cvo_tpu_torch.ops import lie as t_lie
from unified_cvo_tpu_torch.ops import neighbors as t_nbr
from unified_cvo_tpu_torch.utils import pointcloud as t_pc

torch.set_num_threads(1)


def test_orthogonalize_matches_jax():
    """test_lie.py:95's call: a rotation with 1e-3 noise."""
    R = Rotation.from_rotvec([0.3, -0.2, 0.9]).as_matrix().astype(np.float32)
    noisy = R + 1e-3 * np.random.default_rng(3).normal(size=(3, 3)).astype(np.float32)
    got = t_lie.orthogonalize(torch.from_numpy(noisy)).numpy()
    want = np.asarray(j_lie.orthogonalize(jnp.array(noisy)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got @ got.T, np.eye(3), atol=1e-5)


def test_orthogonalize_batched_matches_jax():
    noisy = (np.eye(3, dtype=np.float32)[None]
             + 1e-3 * np.random.default_rng(5).normal(size=(4, 3, 3)).astype(np.float32))
    np.testing.assert_allclose(t_lie.orthogonalize(torch.from_numpy(noisy)).numpy(),
                               np.asarray(j_lie.orthogonalize(jnp.array(noisy))),
                               atol=1e-6, rtol=0)


def test_transform_points_matches_jax():
    """test_lie.py:103's call."""
    pts = np.random.default_rng(4).normal(size=(10, 3)).astype(np.float32)
    xi = np.array([0.1, 0.2, -0.1, 1.0, 0.0, 2.0], np.float32)
    R, t = (np.array(v) for v in j_lie.se3_exp(jnp.array(xi), 1.0))
    got = t_lie.transform_points(torch.from_numpy(R), torch.from_numpy(t),
                                 torch.from_numpy(pts)).numpy()
    want = np.asarray(j_lie.transform_points(jnp.asarray(R), jnp.asarray(t), jnp.array(pts)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, pts @ R.T + t, atol=1e-6)


def _lists(skin):
    """Both packages' grid lists of a 400-point scene (512 rows: padded
    targets) built at a pose."""
    rng = np.random.default_rng(8)
    xyz = np.stack([rng.uniform(-12, 12, 400), rng.uniform(-2, 2, 400),
                    rng.uniform(2, 50, 400)], axis=1).astype(np.float32)
    base = dict(ell_init=0.4, sp_thres=0.0006, is_using_geometry=1)
    jp = JaxParams(**base)
    tp = convert.params_from_fields(dataclasses.asdict(jp))
    R, T = (np.array(v) for v in j_lie.se3_exp(
        jnp.asarray([0.004, -0.006, 0.003, 0.02, -0.01, 0.03]), 1.0))
    jt = j_pc.make_pointcloud(xyz, bucket=512)
    tt = t_pc.make_pointcloud(xyz, bucket=512, device="cpu")
    nl_j = j_nbr.build_neighbor_list(jp, jnp.float32(0.4), jt, jt, jnp.asarray(R),
                                     jnp.asarray(T), skin=skin)
    nl_t = t_nbr.build_neighbor_list(tp, torch.tensor(0.4), tt, tt, torch.from_numpy(R),
                                     torch.from_numpy(T), skin=skin)
    return (nl_j, jt), (nl_t, tt), R, T


@pytest.mark.parametrize("move", ["translation", "rotation"])
@pytest.mark.parametrize("side", [0.97, 1.03], ids=["inside", "past"])
def test_drift_exceeded_matches_jax(move, side):
    """Every valid target moved by `side` x skin at most: the exact trigger
    fires past the skin only, in both packages; the padded targets (mask
    0) never count."""
    skin = 0.3
    (nl_j, jt), (nl_t, tt), R, T = _lists(skin)
    if move == "translation":
        R2, T2 = R, (T + np.float32([side * skin, 0.0, 0.0])).astype(np.float32)
    else:
        # a rotation about the origin: the farthest valid target moves most
        r_max = float(np.max(np.linalg.norm(np.asarray(tt.xyz)[:400] @ R.T + T, axis=1)))
        dR = Rotation.from_rotvec([0.0, 2 * np.arcsin(side * skin / (2 * r_max)), 0.0])
        dR = dR.as_matrix().astype(np.float32)
        R2, T2 = (dR @ R).astype(np.float32), (dR @ T).astype(np.float32)
    got = bool(t_nbr.drift_exceeded(nl_t, tt, torch.from_numpy(R2), torch.from_numpy(T2),
                                    skin))
    want = bool(j_nbr.drift_exceeded(nl_j, jt, jnp.asarray(R2), jnp.asarray(T2), skin))
    assert got == want == (side > 1.0)


@pytest.mark.parametrize("fields", ["xyz_only", "features", "all"])
def test_concatenate_matches_jax(fields):
    """Fields both clouds have are joined; one missing from either cloud
    is None: features on neither side ("xyz_only") or both, labels on one
    side only ("all"), geometric types on one side only ("xyz_only";
    make_pointcloud fills them otherwise)."""
    rng = np.random.default_rng(9)

    def cloud(n, with_labels):
        kw = {}
        if fields in ("features", "all"):
            kw["features"] = rng.uniform(0, 1, (n, 5)).astype(np.float32)
        if fields == "all" and with_labels:
            kw["labels"] = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
            kw["geometric_types"] = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
        return rng.normal(size=(n, 3)).astype(np.float32), kw

    (xa, ka), (xb, kb) = cloud(100, True), cloud(70, fields == "all")
    if fields == "all":
        kb.pop("labels")                   # labels on one side only: dropped
    ja, jb = j_pc.make_pointcloud(xa, bucket=128, **ka), j_pc.make_pointcloud(xb, bucket=96, **kb)
    ta = t_pc.make_pointcloud(xa, bucket=128, device="cpu", **ka)
    tb = t_pc.make_pointcloud(xb, bucket=96, device="cpu", **kb)
    if fields == "xyz_only":
        jb, tb = jb._replace(geometric_types=None), dataclasses.replace(tb, geometric_types=None)
    j, t = j_pc.concatenate(ja, jb), t_pc.concatenate(ta, tb)
    assert t.capacity == 224
    assert (t.geometric_types is None) == (fields == "xyz_only")
    for name in ("xyz", "mask", "features", "labels", "geometric_types"):
        a, b = getattr(j, name), getattr(t, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert t.labels is None and (t.features is None) == (fields == "xyz_only")
