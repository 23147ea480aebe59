"""The port's Morton sort and tile culling (unified_cvo_tpu_torch/ops/morton.py)
against the JAX package's (unified_cvo_tpu/ops/morton.py) on identical numpy
clouds: codes bit-equal, the same permutation (padding rows included), and
equal tile boxes, per-tile supports and cull masks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unified_cvo_tpu.config import CvoParams as JaxParams
from unified_cvo_tpu.ops import lie as j_lie
from unified_cvo_tpu.ops import morton as j_morton
from unified_cvo_tpu.utils.pointcloud import make_pointcloud as j_make
from unified_cvo_tpu_torch.config import CvoParams
from unified_cvo_tpu_torch.ops import morton as t_morton
from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud as t_make

torch.set_num_threads(1)

TILE = 128


def _xyz(case):
    """KITTI-like extents; padding rows; duplicate points (tied codes); a
    flat cloud (one axis of zero span)."""
    rng = np.random.default_rng({"full": 0, "padded": 1, "ties": 2, "flat": 3}[case])
    n = {"full": 1024, "padded": 700, "ties": 900, "flat": 1000}[case]
    xyz = np.stack([rng.uniform(-12, 12, n), rng.uniform(-2, 3, n),
                    rng.uniform(2, 55, n)], axis=1).astype(np.float32)
    if case == "ties":
        xyz[::3] = xyz[0]
    if case == "flat":
        xyz[:, 1] = -1.7
    return xyz


def _clouds(case, cap=1024):
    xyz = _xyz(case)
    feats = np.abs(np.sin(1.7 * xyz)).astype(np.float32)
    return (j_make(xyz, features=feats, bucket=cap),
            t_make(xyz, features=feats, bucket=cap, device="cpu"))


CASES = ["full", "padded", "ties", "flat"]


@pytest.mark.parametrize("case", CASES)
def test_morton_codes_bit_equal(case):
    jc, tc = _clouds(case)
    want = np.asarray(j_morton.morton_codes(jc.xyz, jc.mask)).astype(np.int64)
    got = t_morton.morton_codes(tc.xyz, tc.mask)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", CASES)
def test_sort_cloud_same_permutation(case):
    jc, tc = _clouds(case)
    js, jperm = j_morton.sort_cloud(jc)
    ts, tperm = t_morton.sort_cloud(tc)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    for name in ("xyz", "mask", "features", "geometric_types"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    # padding rows sort last and sit at the far sentinel
    n_valid = int(tc.num_valid)
    assert torch.all(ts.mask[:n_valid] == 1) and torch.all(ts.mask[n_valid:] == 0)
    assert torch.all(ts.xyz[n_valid:] == t_morton._FAR)


@pytest.mark.parametrize("case", CASES)
def test_tile_boxes_supports_and_cull_mask_equal(case):
    jc, tc = _clouds(case)
    js, _ = j_morton.sort_cloud(jc)
    ts, _ = t_morton.sort_cloud(tc)
    jx_lo, jx_hi = j_morton.tile_aabbs(js.xyz, js.mask, TILE)
    tx_lo, tx_hi = t_morton.tile_aabbs(ts.xyz, ts.mask, TILE)
    np.testing.assert_array_equal(tx_lo.numpy(), np.asarray(jx_lo))
    np.testing.assert_array_equal(tx_hi.numpy(), np.asarray(jx_hi))
    # the target: the same cloud moved by a small rigid motion, 256-point tiles
    xi = jnp.asarray(np.array([0.01, -0.02, 0.01, 0.3, -0.1, 1.0], np.float32))
    R, T = j_lie.se3_exp(xi, 1.0)
    jy = js._replace(xyz=js.xyz @ R.T + T)
    ty_xyz = torch.from_numpy(np.array(jy.xyz))
    jy_lo, jy_hi = j_morton.tile_aabbs(jy.xyz, jy.mask, 2 * TILE)
    ty_lo, ty_hi = t_morton.tile_aabbs(ty_xyz, ts.mask, 2 * TILE)
    np.testing.assert_array_equal(ty_lo.numpy(), np.asarray(jy_lo))
    for ell, range_ell in ((0.5, 0), (0.2, 1)):
        jp = JaxParams(ell_init=ell, is_using_range_ell=range_ell)
        tp = CvoParams(ell_init=ell, is_using_range_ell=range_ell)
        jd = j_morton.tile_d2max(jp, jnp.float32(ell), js.xyz, js.mask, TILE)
        td = t_morton.tile_d2max(tp, torch.tensor(ell, dtype=torch.float32), ts.xyz,
                                 ts.mask, TILE)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        jm = j_morton.tile_cull_mask(jx_lo, jx_hi, jd, jy_lo, jy_hi)
        tm = t_morton.tile_cull_mask(tx_lo, tx_hi, td, ty_lo, ty_hi)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        assert 0 < float(tm.sum()) < tm.numel()   # the mask really culls
