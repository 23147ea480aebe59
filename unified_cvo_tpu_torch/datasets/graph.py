"""Co-visibility graph file IO (reference graph_defs/ format).

Format (read_graph_file, main_multi_frame_irls_tum.cpp:27-69):
  num_frames num_edges
  <num_frames frame indices>
  <num_edges (i, j) pairs, indices into the frame list's *dataset* ids>
  [optional: num_frames rows of 12 floats = 3x4 row-major init poses]

A copy of unified_cvo_tpu/datasets/graph.py, kept here so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def read_graph_file(path: str):
    with open(path) as f:
        toks = f.read().split()
    it = iter(toks)
    num_frames = int(next(it))
    num_edges = int(next(it))
    frame_inds = [int(next(it)) for _ in range(num_frames)]
    edges_raw = [(int(next(it)), int(next(it))) for _ in range(num_edges)]
    # edges reference dataset frame ids; remap to local 0..F-1
    id2local = {fid: k for k, fid in enumerate(frame_inds)}
    edges = [(id2local[a], id2local[b]) for a, b in edges_raw]
    poses: Optional[np.ndarray] = None
    rest = list(it)
    if len(rest) >= 12 * num_frames:
        poses = np.asarray(
            [float(v) for v in rest[: 12 * num_frames]], np.float64
        ).reshape(num_frames, 3, 4)
    return frame_inds, edges, poses


def write_graph_file(path: str, frame_inds, edges, poses: Optional[np.ndarray] = None):
    with open(path, "w") as f:
        f.write(f"{len(frame_inds)} {len(edges)}\n")
        f.write(" ".join(str(i) for i in frame_inds) + "\n")
        local2id = {k: fid for k, fid in enumerate(frame_inds)}
        for a, b in edges:
            f.write(f"{local2id[a]} {local2id[b]}\n")
        if poses is not None:
            for T in poses:
                f.write(" ".join(f"{v:.9g}" for v in np.asarray(T)[:3, :4].ravel()) + "\n")
