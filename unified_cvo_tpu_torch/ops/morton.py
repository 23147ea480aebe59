"""Morton (Z-order) spatial sorting and tile AABB culling masks (port of
unified_cvo_tpu/ops/morton.py).

Both clouds are sorted once per alignment by Morton code so that the dense
backend's tiles are spatially compact; each iteration then culls the
(source tile x target tile) pairs whose bounding boxes lie farther apart
than the source tile's kernel support d2_thres = -2 l^2 log(sp_thres /
sigma^2). Rigid motion keeps tiles compact, so the sort is done once while
the mask is recomputed per iteration from the moved target's tile boxes.

Codes are held in int64 (PyTorch's uint32 support is partial); the values
are the JAX package's uint32 codes, padding rows 0xFFFFFFFF.

The tile functions take leading lane axes (the batched dense loop culls
every lane's pairs at once: [B, nI, nJ] masks); a lane's values are those
of the call on that lane alone.
"""

from __future__ import annotations

import dataclasses

import torch

from unified_cvo_tpu_torch.ops.kernels import geometric_constants, range_ell
from unified_cvo_tpu_torch.utils.pointcloud import PointCloud

_FAR = 1.0e5  # sentinel position for padding rows: sorts last, culls cheaply
PAD_CODE = 0xFFFFFFFF


def _spread_bits10(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits of v so there are two zero bits between each."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[N] int64 Morton codes over the valid-point AABB; padding rows get
    the maximum code so they sort to the tail."""
    big = 3.0e38
    valid = (mask > 0)[:, None]
    lo = torch.amin(torch.where(valid, xyz, torch.full_like(xyz, big)), dim=0)
    hi = torch.amax(torch.where(valid, xyz, torch.full_like(xyz, -big)), dim=0)
    span = torch.clamp(hi - lo, min=1e-6)
    # values are >= 0 after the clip, so truncation matches astype(uint32)
    q = torch.clamp((xyz - lo) / span * 1023.0, 0.0, 1023.0).to(torch.int64)
    code = (_spread_bits10(q[:, 0]) | (_spread_bits10(q[:, 1]) << 1)
            | (_spread_bits10(q[:, 2]) << 2))
    return torch.where(mask > 0, code, torch.full_like(code, PAD_CODE))


def sort_cloud(pc: PointCloud):
    """Morton-sort a cloud; returns (sorted cloud, permutation). Padding rows
    move to the tail and their xyz is pushed to a far sentinel so whole
    padding tiles cull against everything. The sort is stable, as
    jnp.argsort is: padding rows share one code and keep their order."""
    perm = torch.argsort(morton_codes(pc.xyz, pc.mask), stable=True)

    def take(a):
        return None if a is None else a[perm]

    s = PointCloud(xyz=take(pc.xyz), mask=take(pc.mask), features=take(pc.features),
                   labels=take(pc.labels), geometric_types=take(pc.geometric_types))
    far = torch.where((s.mask > 0)[:, None], s.xyz, torch.full_like(s.xyz, _FAR))
    return dataclasses.replace(s, xyz=far), perm


def tile_aabbs(xyz: torch.Tensor, mask: torch.Tensor, tile: int):
    """Per-tile (lo [..., T, 3], hi [..., T, 3]) over valid rows of xyz
    [..., N, 3]; empty tiles get far-away boxes."""
    lead = xyz.shape[:-2]
    T = xyz.shape[-2] // tile
    x = xyz.reshape(*lead, T, tile, 3)
    m = (mask > 0).reshape(*lead, T, tile, 1)
    lo = torch.amin(torch.where(m, x, torch.full_like(x, _FAR)), dim=-2)
    hi = torch.amax(torch.where(m, x, torch.full_like(x, -_FAR)), dim=-2)
    return lo, hi


def tile_cull_mask(x_lo, x_hi, x_d2max, y_lo, y_hi) -> torch.Tensor:
    """[..., nI, nJ] float32 mask: 1.0 where the least box-to-box squared
    distance is within the source tile's kernel support x_d2max [..., nI]."""
    gap = torch.clamp(torch.maximum(x_lo[..., :, None, :] - y_hi[..., None, :, :],
                                    y_lo[..., None, :, :] - x_hi[..., :, None, :]), min=0.0)
    d2 = torch.sum(gap * gap, dim=-1)
    return (d2 <= x_d2max[..., :, None]).to(torch.float32)


def tile_d2max(params, ell, xyz: torch.Tensor, mask: torch.Tensor, tile: int):
    """Per-source-tile largest geometric gate threshold (range-scaled ell):
    [..., nI] from xyz [..., N, 3] and ell [...] (one ell a lane)."""
    log_term = geometric_constants(params)[2]
    p = torch.where((mask > 0)[..., None], xyz, torch.zeros_like(xyz))
    ell = torch.as_tensor(ell, dtype=xyz.dtype, device=xyz.device)
    l_i = range_ell(ell[..., None], torch.sqrt(torch.sum(p * p, dim=-1)))
    d2 = -2.0 * l_i * l_i * log_term
    d2 = torch.where(mask > 0, d2, torch.zeros_like(d2))
    return torch.amax(d2.reshape(*d2.shape[:-1], -1, tile), dim=-1)
