"""Fixed-capacity padded point clouds (port of unified_cvo_tpu/utils/pointcloud.py).

A cloud is `xyz [N,3]` plus optional `features [N,F]`, `labels [N,C]`,
`geometric_types [N,2]` and a validity `mask [N]`. N is rounded up to a
bucket size; padding rows have xyz = 0 and mask = 0, and every consumer
masks them out explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from unified_cvo_tpu_torch.device import resolve_device


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """Padded point cloud. Invalid (padding) rows have mask == 0."""

    xyz: torch.Tensor                               # [N, 3] float32
    mask: torch.Tensor                              # [N] float32, 1 valid / 0 pad
    features: Optional[torch.Tensor] = None         # [N, F] float32
    labels: Optional[torch.Tensor] = None           # [N, C] float32
    geometric_types: Optional[torch.Tensor] = None  # [N, 2] float32

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def num_valid(self) -> torch.Tensor:
        return torch.sum(self.mask)

    @property
    def feature_dim(self) -> int:
        return 0 if self.features is None else self.features.shape[-1]

    @property
    def num_classes(self) -> int:
        return 0 if self.labels is None else self.labels.shape[-1]

    def transformed(self, R: torch.Tensor, t: torch.Tensor) -> "PointCloud":
        """Rigid transform of positions only (reference
        transform_pointcloud_thrust, CvoGPU_impl.cu:164-173)."""
        return dataclasses.replace(self, xyz=self.xyz @ R.transpose(-1, -2) + t)

    def map(self, fn) -> "PointCloud":
        """fn applied to every field the cloud has (None stays None)."""
        return PointCloud(*(None if a is None else fn(a) for a in (
            self.xyz, self.mask, self.features, self.labels, self.geometric_types)))

    def to(self, device) -> "PointCloud":
        def mv(a):
            return None if a is None else a.to(device)

        return PointCloud(mv(self.xyz), mv(self.mask), mv(self.features),
                          mv(self.labels), mv(self.geometric_types))


def make_pointcloud(
    xyz: np.ndarray,
    features: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
    geometric_types: Optional[np.ndarray] = None,
    bucket: int = 256,
    capacity: Optional[int] = None,
    device=None,
) -> PointCloud:
    """Build a padded PointCloud from host arrays (same bucket and padding
    rules as the JAX package's make_pointcloud)."""
    dev = resolve_device(device)
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    cap = capacity if capacity is not None else max(round_up(n, bucket), bucket)
    if cap < n:
        raise ValueError(f"capacity {cap} < num points {n}")

    def pad(a):
        a = np.asarray(a, np.float32).reshape(n, -1)
        out = np.zeros((cap, a.shape[1]), np.float32)
        out[:n] = a
        return torch.from_numpy(out).to(dev)

    mask = np.zeros((cap,), np.float32)
    mask[:n] = 1.0
    if geometric_types is None:
        # reference default for plain/colored clouds: surface type (0, 1)
        # (CvoPointCloud.cpp:590-592)
        geometric_types = np.tile(np.array([[0.0, 1.0]], np.float32), (n, 1))
    return PointCloud(
        xyz=pad(xyz),
        mask=torch.from_numpy(mask).to(dev),
        features=None if features is None else pad(features),
        labels=None if labels is None else pad(labels),
        geometric_types=pad(geometric_types),
    )


def concatenate(a: PointCloud, b: PointCloud) -> PointCloud:
    """The two clouds' rows one after the other (the reference's operator+,
    CvoPointCloud.cpp:916-962); an optional field is None unless both
    clouds have it."""

    def cat(x, y):
        return None if x is None or y is None else torch.cat([x, y], dim=0)

    return PointCloud(xyz=torch.cat([a.xyz, b.xyz], dim=0),
                      mask=torch.cat([a.mask, b.mask], dim=0),
                      features=cat(a.features, b.features),
                      labels=cat(a.labels, b.labels),
                      geometric_types=cat(a.geometric_types, b.geometric_types))


def to_numpy_valid(pc: PointCloud):
    """Strip padding; returns a dict of numpy arrays for IO and the host
    side of the mapping back end (`xyz`, and `features`, `labels`,
    `geometric_types` where the cloud has them)."""
    mask = pc.mask.detach().cpu().numpy() > 0.5
    out = {"xyz": pc.xyz.detach().cpu().numpy()[mask]}
    for name in ("features", "labels", "geometric_types"):
        v = getattr(pc, name)
        if v is not None:
            out[name] = v.detach().cpu().numpy()[mask]
    return out
