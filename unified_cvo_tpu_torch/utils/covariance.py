"""Per-point neighbourhood covariance and its eigenvalues (port of
unified_cvo_tpu/utils/covariance.py).

Reference: src/utils/CvoPointCovariance.cu:122-233, a 3x3 covariance over
each point's K nearest neighbours (K = KDTREE_K_SIZE = 32) with its
eigenvalues, for the dense (Mahalanobis) kernel variant and for ellipse
display. Two forms:

- `point_covariances`: on the host (cKDTree K-nearest search and a batched
  eigh), used when a cloud is made, as in the reference. A copy of the JAX
  package's numpy and scipy function, kept here so that the port imports
  nothing of that package.
- `point_covariances_device`: in torch on any device, the counterpart of
  JAX's `point_covariances_tpu`: a blocked brute-force K-nearest search
  (`torch.topk` over [block, N] distance tiles) and closed-form symmetric
  3x3 eigenvalues.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.spatial import cKDTree


def point_covariances(xyz: np.ndarray, k: int = 32):
    """Returns (cov [N, 3, 3], eigenvalues [N, 3] ascending, degenerate [N]).
    Degenerate: fewer than 4 neighbours or near-zero spread (the
    reference's is_cov_degenerate flag). A copy of the JAX package's
    function."""
    xyz = np.asarray(xyz, np.float64).reshape(-1, 3)
    n = len(xyz)
    if n == 0:
        return np.zeros((0, 3, 3)), np.zeros((0, 3)), np.zeros(0, bool)
    k = min(k, n)
    _, idx = cKDTree(xyz).query(xyz, k=k)
    nbrs = xyz[idx.reshape(n, k)]                          # [N, k, 3]
    centered = nbrs - nbrs.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered) / max(k - 1, 1)
    eigvals = np.linalg.eigvalsh(cov)                      # ascending
    degenerate = (eigvals[:, 2] < 1e-10) | (k < 4)
    return cov.astype(np.float32), eigvals.astype(np.float32), degenerate


def point_covariances_device(xyz, mask, k: int = 32, block: int = 256):
    """Per-point K-nearest covariance on the tensors' device, the
    counterpart of JAX's point_covariances_tpu (CvoPointCovariance.cu's
    compute_covariance with cuKdTree K = 32, :122-233): [block, N] distance
    tiles and torch.topk, batched covariance, closed-form eigenvalues.
    Masked points get a zero covariance and are degenerate.

    xyz [N, 3] float32 (padded), mask [N] {0, 1}. Returns (cov [N, 3, 3],
    eigvals [N, 3] ascending, degenerate [N] bool)."""
    xyz = torch.as_tensor(xyz, dtype=torch.float32)
    mask = torch.as_tensor(mask, dtype=torch.float32).to(xyz.device)
    n = xyz.shape[0]
    k = min(k, n)
    sq = torch.sum(xyz * xyz, dim=-1)
    covs, cnts = [], []
    for lo in range(0, n, block):
        xb = xyz[lo:lo + block]
        d2 = torch.sum(xb * xb, -1)[:, None] + sq[None, :] - 2.0 * (xb @ xyz.T)
        d2 = torch.where(mask[None, :] > 0, d2, torch.full_like(d2, math.inf))
        neg, idx = torch.topk(-d2, k, dim=1)                # [block, k]
        w = torch.isfinite(neg).to(torch.float32)[..., None]
        nb = xyz[idx]                                      # [block, k, 3]
        cnt = torch.clamp(torch.sum(w, dim=1), min=1.0)    # [block, 1]
        mean = torch.sum(nb * w, dim=1, keepdim=True) / cnt[:, None]
        cen = (nb - mean) * w
        covs.append(torch.einsum("bki,bkj->bij", cen, cen)
                    / torch.clamp(cnt - 1.0, min=1.0)[..., None])
        cnts.append(torch.sum(w[..., 0], dim=1))
    cov = torch.cat(covs) * mask[:, None, None]
    eig = sym3_eigenvalues(cov)
    degenerate = (eig[:, 2] < 1e-10) | (torch.cat(cnts) < 4) | (mask <= 0)
    return cov, eig, degenerate


def sym3_eigenvalues(A):
    """Closed-form ascending eigenvalues of symmetric 3x3 matrices [..., 3, 3]
    (the trigonometric method, Smith 1961)."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    B = A - q[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    r = torch.clamp(torch.linalg.det(B) / (2.0 * p ** 3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    eig = torch.stack([e3, e2, e1], dim=-1)
    # exactly isotropic matrices (p ~ 0): every eigenvalue is q
    return torch.where((p2 < 1e-24)[..., None], torch.stack([q, q, q], dim=-1), eig)
