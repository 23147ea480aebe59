"""Hash-grid voxel downsampling (reference VoxelMap, utils/VoxelMap.hpp:80-157).

The reference keeps one representative point per voxel (`sample_points`,
VoxelMap_impl.hpp). Vectorized here with np.unique over quantized coords;
the representative is the first-inserted point, like the reference's
per-voxel vector front.

A copy of unified_cvo_tpu/utils/voxel.py (numpy, on the host), kept here so
that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def voxel_downsample_indices(xyz: np.ndarray, voxel_size: float) -> np.ndarray:
    """Indices of one representative point per occupied voxel (stable order)."""
    if voxel_size <= 0 or len(xyz) == 0:
        return np.arange(len(xyz))
    q = np.floor(np.asarray(xyz, np.float64) / voxel_size).astype(np.int64)
    # unique with first-occurrence representative
    _, first = np.unique(q, axis=0, return_index=True)
    return np.sort(first)


def voxel_downsample(xyz: np.ndarray, voxel_size: float, *extras):
    idx = voxel_downsample_indices(xyz, voxel_size)
    out = [xyz[idx]] + [None if e is None else e[idx] for e in extras]
    return out if extras else out[0]
