"""Carry state from the JAX package into the port.

CVO learns nothing, so its state is the parameters, the clouds and the
neighbor list. These take the JAX package's state as plain numpy arrays and
dicts (the caller converts with `numpy.asarray` and `dataclasses.asdict`),
so this module imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from unified_cvo_tpu_torch.config import CvoParams
from unified_cvo_tpu_torch.device import resolve_device
from unified_cvo_tpu_torch.ops.neighbors import NeighborList
from unified_cvo_tpu_torch.utils.pointcloud import PointCloud

_PARAM_FIELDS = {f.name for f in dataclasses.fields(CvoParams)}


def params_from_fields(fields: Mapping) -> CvoParams:
    """CvoParams from `dataclasses.asdict` of the JAX CvoParams."""
    unknown = set(fields) - _PARAM_FIELDS
    if unknown:
        raise ValueError(f"unknown CvoParams fields: {sorted(unknown)}")
    return CvoParams(**dict(fields))


def _t(a, dtype, device):
    return None if a is None else torch.from_numpy(
        np.array(a)).to(dtype).to(device)


def pointcloud_from_numpy(xyz, mask, features=None, labels=None,
                          geometric_types=None, device=None) -> PointCloud:
    """A port PointCloud holding exactly the given padded arrays
    (`device=None` means the card)."""
    device = resolve_device(device)
    f32 = torch.float32
    return PointCloud(xyz=_t(xyz, f32, device), mask=_t(mask, f32, device),
                      features=_t(features, f32, device),
                      labels=_t(labels, f32, device),
                      geometric_types=_t(geometric_types, f32, device))


def neighbor_list_from_numpy(idx, valid, y_xyz, y_t_build, overflow,
                             pose_build=None, r_max_t=None, ell_build=None,
                             k_lin=None, chan: Optional[np.ndarray] = None,
                             device=None) -> NeighborList:
    """A port NeighborList from the JAX list's fields (K-major layout;
    `device=None` means the card)."""
    device = resolve_device(device)
    f32 = torch.float32
    return NeighborList(
        idx=_t(idx, torch.int32, device), valid=_t(valid, torch.bool, device),
        y_xyz=_t(y_xyz, f32, device), chan=_t(chan, f32, device),
        y_t_build=_t(y_t_build, f32, device),
        overflow=_t(overflow, torch.int32, device),
        pose_build=_t(pose_build, f32, device), r_max_t=_t(r_max_t, f32, device),
        ell_build=_t(ell_build, f32, device), k_lin=_t(k_lin, f32, device))
