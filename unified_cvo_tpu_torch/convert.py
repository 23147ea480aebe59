"""Carry state from the JAX package into the port.

CVO learns nothing, so its state is the parameters, the clouds, the
neighbor list and the camera calibration. These take the JAX package's state as plain numpy arrays and
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
from unified_cvo_tpu_torch.frontend.calibration import Calibration
from unified_cvo_tpu_torch.ops.neighbors import NeighborList
from unified_cvo_tpu_torch.utils.pointcloud import PointCloud

_PARAM_FIELDS = {f.name for f in dataclasses.fields(CvoParams)}


def params_from_fields(fields: Mapping) -> CvoParams:
    """CvoParams from `dataclasses.asdict` of the JAX CvoParams."""
    unknown = set(fields) - _PARAM_FIELDS
    if unknown:
        raise ValueError(f"unknown CvoParams fields: {sorted(unknown)}")
    return CvoParams(**dict(fields))


def calibration_from_fields(intrinsic, baseline: float = 0.0, depth_scale: float = 1.0,
                            cols: int = 0, rows: int = 0) -> Calibration:
    """The port's Calibration from the JAX Calibration's fields (intrinsic
    [3, 3] as numpy, baseline, depth_scale, cols, rows)."""
    K = np.array(intrinsic, np.float32)
    if K.shape != (3, 3):
        raise ValueError(f"intrinsic must be [3, 3], got {K.shape}")
    return Calibration(K, baseline=float(baseline), depth_scale=float(depth_scale),
                       cols=int(cols), rows=int(rows))


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


def irls_state_from_numpy(xyz, mask, init_poses, edges, pivot_flags, features=None,
                          device=None):
    """The inputs of models/irls.py::irls_solve from the JAX package's: the
    stacked clouds' padded arrays ([F, N, 3] xyz and [F, N] mask, as
    numpy.asarray gives them from irls.stack_clouds), the [F, 3, 4] poses,
    the edges ([E, 2] or pairs) and the pivot flags. Returns (clouds,
    init_poses [F, 3, 4] float32 numpy, edges as a list of int pairs,
    pivot flags as a list of bools)."""
    device = resolve_device(device)
    f32 = torch.float32
    clouds = PointCloud(xyz=_t(xyz, f32, device), mask=_t(mask, f32, device),
                        features=_t(features, f32, device))
    poses = np.asarray(init_poses, np.float32)
    if poses.ndim != 3 or poses.shape[1:] != (3, 4) or poses.shape[0] != clouds.xyz.shape[0]:
        raise ValueError(f"init_poses must be [F, 3, 4] for F = {clouds.xyz.shape[0]} frames, "
                         f"got {poses.shape}")
    pairs = [(int(i), int(j)) for i, j in np.asarray(edges).reshape(-1, 2)]
    return clouds, poses, pairs, [bool(f) for f in np.asarray(pivot_flags).reshape(-1)]


IRLS_CHECKPOINT_KEYS = ("poses", "ell", "iter", "last_nonzeros")


def irls_checkpoint_from_npz(path: str) -> dict:
    """The outer-loop state in a checkpoint written by either package's
    host engine (irls_solve with checkpoint_path, numpy.savez): poses
    [F, 3, 4], ell, iter, last_nonzeros and world_center [3] (None when a
    snapshot has none, as JAX allows). models/irls.py::irls_solve reads its
    resume state through this. Raises ValueError when a key is missing."""
    with np.load(path) as snap:
        missing = [k for k in IRLS_CHECKPOINT_KEYS if k not in snap]
        if missing:
            raise ValueError(f"{path}: not an IRLS checkpoint, missing {missing}")
        out = {k: np.array(snap[k]) for k in IRLS_CHECKPOINT_KEYS}
        out["world_center"] = np.array(snap["world_center"]) if "world_center" in snap else None
    return out
