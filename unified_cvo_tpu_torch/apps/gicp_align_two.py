"""Generalized-ICP baseline on two PCD files — the gicp_align_two twin (port
of unified_cvo_tpu/apps/gicp_align_two.py).

The reference builds a PCL-GICP binary as an external cross-check on the same
two-cloud input as the CVO demo (src/experiments/main_gicp_align_two_pcd.cpp,
CMakeLists.txt:729-735). This is a from-scratch plane-to-plane GICP
(Segal et al., RSS'09): per-point covariances regularized to disk shape
(eigenvalues -> (1, 1, eps)), NN correspondences, and a Gauss-Newton step on
se(3) minimizing sum d^T (C_b + R C_a R^T)^{-1} d. Everything is float64
(JAX's numpy keeps a float32 cloud's covariances in float32; the CLI's PCDs
are float32).
The nearest-neighbour queries run on the host (scipy's cKDTree, as in JAX);
the covariances and each iteration's normal equations (JAX's loop over the
correspondences, one batched einsum here) run on `device`, the card unless
the caller asks for another.

Usage:
    python -m unified_cvo_tpu_torch.apps.gicp_align_two SOURCE.pcd TARGET.pcd \
        [--max-iter N] [--k K] [--max-corr DIST]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from unified_cvo_tpu_torch.datasets.pcd import read_pcd
from unified_cvo_tpu_torch.device import resolve_device

F64 = torch.float64


def _covariances(xyz: np.ndarray, dev, k: int = 20, eps: float = 1e-3) -> torch.Tensor:
    """Disk-regularized neighborhood covariances (GICP sec. III-B), [N, 3, 3]
    on `dev`; the neighbours from a cKDTree on the host."""
    from scipy.spatial import cKDTree

    _, idx = cKDTree(xyz).query(xyz, k=min(k, len(xyz)))
    nb = torch.from_numpy(xyz[idx]).to(dev, F64)                   # [N,k,3]
    cen = nb - nb.mean(dim=1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", cen, cen) / max(k - 1, 1)
    _, v = torch.linalg.eigh(cov)                                 # ascending
    w_reg = torch.tensor([eps, 1.0, 1.0], dtype=F64, device=dev)
    return torch.einsum("nij,j,nkj->nik", v, w_reg, v)


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def _skew_batch(p: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(p[:, 0])
    x, y, w = p.unbind(1)
    return torch.stack([z, -w, y, w, z, -x, -y, x, z], dim=1).reshape(-1, 3, 3)


def gicp_align(
    source: np.ndarray,
    target: np.ndarray,
    max_iter: int = 50,
    k: int = 20,
    max_corr: float = 2.0,
    tol: float = 1e-6,
    device=None,
):
    """Align target onto source; returns (T [4,4] float64 numpy, n_iters,
    rmse).

    Convention matches CvoGPU::align's result: T maps target-frame points
    into the source frame.
    """
    from scipy.spatial import cKDTree

    dev = resolve_device(device)
    source = np.asarray(source, np.float64)
    target = np.asarray(target, np.float64)
    cov_s = _covariances(source, dev, k)
    cov_t = _covariances(target, dev, k)
    src = torch.from_numpy(source).to(dev)
    tgt = torch.from_numpy(target).to(dev)
    tree = cKDTree(source)
    eye3 = torch.eye(3, dtype=F64, device=dev)
    R = np.eye(3)
    t = np.zeros(3)
    rmse = np.inf
    for it in range(max_iter):
        Rk = torch.from_numpy(R).to(dev)
        ty = tgt @ Rk.T + torch.from_numpy(t).to(dev)
        d, idx = tree.query(ty.cpu().numpy())
        keep = d < max_corr
        if keep.sum() < 6:
            break
        kk = torch.from_numpy(np.nonzero(keep)[0]).to(dev)
        ik = torch.from_numpy(idx[keep]).to(dev)
        Ca = Rk @ cov_t[kk] @ Rk.T
        W = torch.linalg.inv(Ca + cov_s[ik])
        pts = ty[kk]
        res = pts - src[ik]                                       # [M,3]
        J = torch.cat([-_skew_batch(pts), eye3.expand(len(pts), 3, 3)], dim=2)  # [M,3,6]
        JW = torch.einsum("mki,mkl->mil", J, W)                   # J^T W, [M,6,3]
        A = torch.einsum("mil,mlj->ij", JW, J).cpu().numpy()
        b = torch.einsum("mil,ml->i", JW, res).cpu().numpy()
        delta = np.linalg.solve(A + 1e-9 * np.eye(6), -b)
        w, v = delta[:3], delta[3:]
        th = np.linalg.norm(w)
        if th < 1e-12:
            dR = np.eye(3)
        else:
            K = _skew(w / th)
            dR = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
        R = dR @ R
        t = dR @ t + v
        new_rmse = float(torch.sqrt(torch.mean(torch.sum(res ** 2, dim=1))))
        if abs(rmse - new_rmse) < tol:
            rmse = new_rmse
            break
        rmse = new_rmse
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T, it + 1, rmse


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("source")
    ap.add_argument("target")
    ap.add_argument("--max-iter", type=int, default=50)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--max-corr", type=float, default=2.0)
    args = ap.parse_args(argv)

    sx, _ = read_pcd(args.source)
    tx, _ = read_pcd(args.target)
    print(f"GICP baseline: {len(sx)} fixed, {len(tx)} moving")
    t0 = time.time()
    T, iters, rmse = gicp_align(sx, tx, args.max_iter, args.k, args.max_corr, device=device)
    print(f"converged in {iters} iters, rmse {rmse:.4f}, {time.time()-t0:.2f} s")
    print("Transform is\n", T)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
