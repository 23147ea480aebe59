"""K-nearest candidate selection of the neighbor-list build.

`select` replaces the TPU kernel unified_cvo_tpu/ops/pallas_select.py::
_select_kernel. On a CUDA tensor it launches csrc/select.cu, one kernel a
call, by one of two routes its dispatch picks from the shapes: the align
list (P = 8, K <= 32) gathers a point's whole pool into registers
branch-free and ranks the kept candidates by counting; every other shape
(the IRLS list: P = 32, K = 128) streams the pool a candidate a lane,
reading coordinates only behind a live index, keeps the kept candidates in
a list in shared memory, picks the K nearest by a bitwise search for the
K-th d2 and ranks those K by counting. Both stage the [K, points] output
tile in shared memory and store slot rows in whole sectors. On a CPU
tensor it runs `select_plain`, the sort path of the JAX grid builder
(neighbors.py:348-396): exact filter, a stable sort on the squared distance
carrying the candidate position, first K. The kernel breaks ties by pool
position too, so both give the same slots in the same order.

Contract (both versions): for source point n and its 27-cell pool (cells
in dx, dy, dz order, P slots each), keep candidates with index >= 0 and
|x_n - (R_inv y + T_inv)|^2 <= r2_n; return the K nearest as
idx [K, N] int32 (-1 on dead slots), y_xyz [3, K, N] raw target xyz
(DEAD_COORD on dead slots) and kept [N] int32, the exact in-support count.

`select_lanes` is route 1 with a lane axis: the builds of L lists in one
launch (lane = blockIdx.y), every input and output [L, ...], each lane's
outputs those of `select` on its inputs bit for bit. It is the counterpart
of _select_kernel under the JAX package's jax.vmap of align
(parallel/batch_align.py:51-55), where the batch becomes a grid axis; its
plain version `select_lanes_plain` runs `select_plain` lane by lane. Route 2
(the IRLS list, P = 32, K = 128) has no lane axis: no JAX path vmaps the
IRLS list.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from unified_cvo_tpu_torch.ops import cuda_lib

DEAD_COORD = 1e9
ROUTE1_P = 8         # route 1's pool width (csrc/select.cu P_FAST): the lane axis's
ROUTE1_MAX_K = 32    # and its largest K (K_STAGE)


def pool_cells(cbase: torch.Tensor, grid_dims) -> torch.Tensor:
    """[N, n_off] cell ids of each source point's neighbourhood in dx, dy,
    dz order; cells outside the grid map to the empty sentinel row. A
    single-cell axis covers its whole span, so it takes no +-1 offsets."""
    gx, gy, gz = grid_dims
    nx, ny, nz = (3 if g > 1 else 1 for g in grid_dims)
    o = torch.arange(nx * ny * nz, dtype=torch.int32, device=cbase.device)
    off = [o // (nz * ny), (o // nz) % ny, o % nz]
    inside = None
    cell = []
    for a, (n_a, g) in enumerate(zip((nx, ny, nz), grid_dims)):
        ca = cbase[:, a:a + 1] + (off[a][None, :] - 1 if n_a == 3 else 0)
        ok = (ca >= 0) & (ca < g)
        inside = ok if inside is None else inside & ok
        cell.append(ca)
    cid = (cell[0] * gy + cell[1]) * gz + cell[2]
    return torch.where(inside, cid, gx * gy * gz)


def select_plain(tab, cbase, xr2, pose, k: int, p: int, grid_dims
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the select kernel (see module docstring)."""
    N = cbase.shape[0]
    cid = pool_cells(cbase, grid_dims)                       # [N, n_off]
    pool = tab[cid.long()]                                   # [N, n_off, 4P]
    comp = [pool[:, :, c * p:(c + 1) * p].reshape(N, -1) for c in range(4)]
    cand = comp[3].to(torch.int32)                           # -1 = empty slot
    R, T = pose[:9], pose[9:]
    yt = [comp[0] * R[3 * c] + comp[1] * R[3 * c + 1] + comp[2] * R[3 * c + 2]
          + T[c] for c in range(3)]
    d2 = ((xr2[:, 0:1] - yt[0]) ** 2 + (xr2[:, 1:2] - yt[1]) ** 2
          + (xr2[:, 2:3] - yt[2]) ** 2)
    keep = (cand >= 0) & (d2 <= xr2[:, 3:4])
    key = torch.where(keep, d2, torch.full_like(d2, float("inf")))
    if key.shape[1] < k:   # fewer candidates than slots: pad with dead ones
        pad = k - key.shape[1]
        key = torch.nn.functional.pad(key, (0, pad), value=float("inf"))
        comp = [torch.nn.functional.pad(c, (0, pad), value=-1.0) for c in comp]
    key_s, order = torch.sort(key, dim=1, stable=True)
    order = order[:, :k]
    valid = torch.isfinite(key_s[:, :k]).T                   # [K, N]
    take = [torch.gather(c, 1, order).T for c in comp]      # [K, N] each
    idx = torch.where(valid, take[3].to(torch.int32), -1)
    y_xyz = torch.where(valid[None], torch.stack(take[:3]), DEAD_COORD)
    kept = keep.sum(dim=1, dtype=torch.int32)
    return idx, y_xyz.contiguous(), kept


def select(tab, cbase, xr2, pose, k: int, p: int, grid_dims):
    """K nearest in-support candidates per source point: the CUDA kernel on
    a CUDA tensor, `select_plain` on a CPU tensor."""
    if tab.device.type == "cpu":
        return select_plain(tab, cbase, xr2, pose, k, p, grid_dims)
    if tab.device.type != "cuda":
        raise ValueError(f"select: unsupported device {tab.device}")
    dev = tab.device
    N = cbase.shape[0]
    gx, gy, gz = grid_dims
    for t, name, dtype, shape in ((tab, "tab", torch.float32, (gx * gy * gz + 1, 4 * p)),
                                  (cbase, "cbase", torch.int32, (N, 3)),
                                  (xr2, "xr2", torch.float32, (N, 4)),
                                  (pose, "pose", torch.float32, (12,))):
        cuda_lib.check_tensor(t, name, dtype, shape, dev, "select")
    lib = _lib()
    n_off = 1
    for g in grid_dims:
        n_off *= 3 if g > 1 else 1
    if n_off * p > lib.cvo_select_max_pool():
        raise ValueError(f"select: pool of {n_off * p} candidates per point "
                         f"exceeds the kernel's {lib.cvo_select_max_pool()}")
    idx = torch.empty((k, N), dtype=torch.int32, device=dev)
    y_xyz = torch.empty((3, k, N), dtype=torch.float32, device=dev)
    kept = torch.empty((N,), dtype=torch.int32, device=dev)
    err = lib.cvo_select(
        tab.data_ptr(), cbase.data_ptr(), xr2.data_ptr(), pose.data_ptr(),
        idx.data_ptr(), y_xyz.data_ptr(), kept.data_ptr(), N, k, p, gx, gy,
        gz, torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, "select kernel launch")
    select.launches += 1
    return idx, y_xyz, kept


select.launches = 0


def select_lanes_plain(tab, cbase, xr2, pose, k: int, p: int, grid_dims):
    """Plain version of the lane-axis select: `select_plain` on each lane."""
    outs = [select_plain(tab[l], cbase[l], xr2[l], pose[l], k, p, grid_dims)
            for l in range(tab.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def select_lanes(tab, cbase, xr2, pose, k: int, p: int, grid_dims):
    """`select` for L lanes at once: tab [L, cells + 1, 4P], cbase [L, N, 3],
    xr2 [L, N, 4], pose [L, 12] -> idx [L, K, N], y_xyz [L, 3, K, N], kept
    [L, N]. One CUDA launch (route 1: P = 8, K <= 32) on a CUDA tensor,
    `select_lanes_plain` on a CPU tensor."""
    if tab.device.type == "cpu":
        return select_lanes_plain(tab, cbase, xr2, pose, k, p, grid_dims)
    if tab.device.type != "cuda":
        raise ValueError(f"select_lanes: unsupported device {tab.device}")
    dev = tab.device
    L, N = cbase.shape[0], cbase.shape[1]
    gx, gy, gz = grid_dims
    for t, name, dtype, shape in ((tab, "tab", torch.float32, (L, gx * gy * gz + 1, 4 * p)),
                                  (cbase, "cbase", torch.int32, (L, N, 3)),
                                  (xr2, "xr2", torch.float32, (L, N, 4)),
                                  (pose, "pose", torch.float32, (L, 12))):
        cuda_lib.check_tensor(t, name, dtype, shape, dev, "select_lanes")
    if p != ROUTE1_P or not 0 < k <= ROUTE1_MAX_K:
        raise ValueError(f"select_lanes: the lane axis is route 1's (P = {ROUTE1_P}, "
                         f"K <= {ROUTE1_MAX_K}); got P = {p}, K = {k}")
    lib = _lib()
    idx = torch.empty((L, k, N), dtype=torch.int32, device=dev)
    y_xyz = torch.empty((L, 3, k, N), dtype=torch.float32, device=dev)
    kept = torch.empty((L, N), dtype=torch.int32, device=dev)
    err = lib.cvo_select_lanes(
        tab.data_ptr(), cbase.data_ptr(), xr2.data_ptr(), pose.data_ptr(),
        idx.data_ptr(), y_xyz.data_ptr(), kept.data_ptr(), L, N, k, p, gx, gy, gz,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, "select_lanes kernel launch")
    select_lanes.launches += 1
    return idx, y_xyz, kept


select_lanes.launches = 0


def _lib():
    """The package's build of csrc/select.cu, its C interface declared."""
    lib = cuda_lib.load("select")
    if not getattr(lib, "_argtypes_set", False):
        P = ctypes.c_void_p
        I = ctypes.c_int
        lib.cvo_select.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, P]
        lib.cvo_select.restype = I
        lib.cvo_select_lanes.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P]
        lib.cvo_select_lanes.restype = I
        lib.cvo_select_max_pool.argtypes = []
        lib.cvo_select_max_pool.restype = I
        lib._argtypes_set = True
    return lib
