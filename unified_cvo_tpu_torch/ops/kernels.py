"""Kernel helpers shared by the ELL passes (port of the parts of
unified_cvo_tpu/ops/kernels.py that the frame-to-frame slice runs).

The dense N x M twins (kernel_block, flow_stats, step_coeffs, ...) belong to
the dense backend and are not ported yet (ROADMAP queue 1, item 3).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from unified_cvo_tpu_torch.utils.pointcloud import PointCloud


def geometric_constants(params):
    """(sigma^2, sp_thres, log(sp_thres / sigma^2)) rounded to float32 as
    the JAX package computes them, returned as Python floats (exact f32
    values) so that no host-to-device copy is needed to use them."""
    sigma2 = torch.tensor(params.sigma, dtype=torch.float32) ** 2
    sp = torch.tensor(params.sp_thres, dtype=torch.float32)
    return float(sigma2), float(sp), float(torch.log(sp / sigma2))


def range_ell(ell, dist_to_sensor):
    """compute_range_ell (reference CvoGPU.cu:87-90)."""
    return (dist_to_sensor / 500.0 + 1.0) * ell


def pad_cloud_to_multiple(pc: PointCloud, multiple: int) -> PointCloud:
    """Zero-pad (mask = 0) a cloud so capacity % multiple == 0."""
    n = pc.capacity
    extra = ((n + multiple - 1) // multiple) * multiple - n
    if extra == 0:
        return pc

    def pad(a):
        return None if a is None else F.pad(a, (0, 0) * (a.dim() - 1) + (0, extra))

    return dataclasses.replace(
        pc, xyz=pad(pc.xyz), mask=pad(pc.mask), features=pad(pc.features),
        labels=pad(pc.labels), geometric_types=pad(pc.geometric_types))


class FlowStats(NamedTuple):
    row_sum: torch.Tensor    # [N]   s_i = sum_j A_ij
    row_wy: torch.Tensor     # [N,3] w_i = sum_j A_ij y_j
    nonzeros: torch.Tensor   # scalar count of A_ij > sp_thres
    a_sum: torch.Tensor      # scalar sum of A (the RKHS inner product value)


def flow_from_stats(params, x: PointCloud, stats: FlowStats):
    """se(3) gradient flow (reference compute_flow, CvoGPU.cu:729-848).

    Returns (unit_twist [6], joint_norm): [omega, v] jointly normalized, and
    the pre-normalization magnitude used for the degeneracy test."""
    omega = torch.sum(torch.linalg.cross(x.xyz, stats.row_wy, dim=-1), dim=0) / params.c
    v = torch.sum(stats.row_wy - stats.row_sum[:, None] * x.xyz, dim=0) / params.d
    joint = torch.cat([omega, v])
    jn = torch.linalg.vector_norm(joint)
    unit = joint / torch.where(jn < 1e-30, torch.ones_like(jn), jn)
    return unit, jn
