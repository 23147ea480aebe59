"""The two hand kernels of the lidar frontend's LeGO-LOAM selection, each
beside its plain PyTorch version (csrc/lidar.cu says what each computes).

Neither replaces a Pallas kernel: the JAX package runs both stages on the
host. `components` replaces segment_range_image's scipy
connected_components (unified_cvo_tpu/frontend/lidar.py:245-251);
`loam_features` replaces _loam_extract_features' per-ring loop
(lidar.py:280-337). On a CUDA tensor each launches its kernel and counts
the launch (`launches`); on a CPU tensor it runs its plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from unified_cvo_tpu_torch.ops import cuda_lib

N_SECTORS = 6            # sectors a ring (LeGO-LOAM's extractFeatures)
MAX_CORNERS = 20         # corners a sector
CURV_HALF = 5            # the +-5 curvature window
REST, EDGE = 1, 2        # `kind` codes (0: not in a processed sector)


# ---------------------------------------------------------------- L1


def components_plain(link_v: torch.Tensor, link_h: torch.Tensor, link_dr=None,
                     link_dl=None) -> torch.Tensor:
    """Connected components of the [rows, cols] grid with vertical links
    `link_v` [rows - 1, cols] ((r, c)-(r + 1, c)) and wrapped horizontal
    links `link_h` [rows, cols] ((r, c)-(r, (c + 1) % cols)), and where
    given the diagonal links `link_dr` [rows - 1, cols] ((r, c)-(r + 1,
    c + 1), its last column False) and `link_dl` [rows - 1, cols] ((r, c)-
    (r + 1, c - 1), its first column False). Returns int32 labels [rows,
    cols]: the smallest cell id of each cell's component. Min-label
    propagation over the links, then pointer jumping, until nothing
    changes."""
    rows, cols = link_h.shape
    dev = link_h.device
    ids = torch.arange(rows * cols, device=dev).view(rows, cols)
    a = [ids[:-1][link_v], ids[link_h]]
    b = [ids[1:][link_v], ids.roll(-1, 1)[link_h]]
    if link_dr is not None:
        a += [ids[:-1][link_dr], ids[:-1][link_dl]]
        b += [ids[1:].roll(-1, 1)[link_dr], ids[1:].roll(1, 1)[link_dl]]
    a, b = torch.cat(a), torch.cat(b)
    lab = ids.reshape(-1).clone()
    while True:
        low = torch.minimum(lab[a], lab[b])
        new = lab.scatter_reduce(0, a, low, "amin").scatter_reduce_(0, b, low, "amin")
        while True:
            jumped = new[new]
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, lab):
            return lab.to(torch.int32).view(rows, cols)
        lab = new


def components(link_v: torch.Tensor, link_h: torch.Tensor) -> torch.Tensor:
    """Labels as `components_plain` gives them: the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if link_h.device.type == "cpu":
        return components_plain(link_v, link_h)
    if link_h.device.type != "cuda":
        raise ValueError(f"components: unsupported device {link_h.device}")
    dev = link_h.device
    rows, cols = link_h.shape
    lv, lh = link_v.contiguous(), link_h.contiguous()   # bool: one byte, 0 or 1
    cuda_lib.check_tensor(lv, "link_v", torch.bool, (rows - 1, cols), dev, "components")
    cuda_lib.check_tensor(lh, "link_h", torch.bool, (rows, cols), dev, "components")
    labels = torch.empty((rows, cols), dtype=torch.int32, device=dev)
    err = _lib().cvo_lidar_components(lv.data_ptr(), lh.data_ptr(), labels.data_ptr(), rows,
                                      cols, torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, "components kernel launch")
    components.launches += 1
    return labels


components.launches = 0


# ---------------------------------------------------------------- L2


def sector_bounds(m: int):
    """`np.linspace(0, m, 7).astype(int)`: i * (m / 6) in float64,
    truncated, the last one m."""
    return [int(s * (m / 6.0)) for s in range(N_SECTORS)] + [m]


def _window_sums(r: torch.Tensor) -> torch.Tensor:
    """numpy's pairwise float32 sum of every 11-wide window of `r`:
    ((a0+a1)+(a2+a3))+((a4+a5)+(a6+a7)), then +a8, +a9, +a10."""
    w = r.unfold(0, 2 * CURV_HALF + 1, 1)
    s = ((w[:, 0] + w[:, 1]) + (w[:, 2] + w[:, 3])) + ((w[:, 4] + w[:, 5]) + (w[:, 6] + w[:, 7]))
    return ((s + w[:, 8]) + w[:, 9]) + w[:, 10]


def loam_features_plain(range_img: torch.Tensor, keep: torch.Tensor,
                        edge_threshold: float = 0.1):
    """LOAM corner picks on each ring of the segmented range image: per
    ring, over its kept columns in order, the +-5 curvature, the occlusion
    and parallel-beam marks, and in each of 6 sectors up to 20 corners by
    descending curvature (ties to the later column) with +-5 suppression
    that stops at column gaps > 10. Rings with fewer than 12 kept columns
    are skipped. Returns kind [rows, cols] uint8 (0 not in a processed
    sector, 1 rest, 2 edge) and rest_counts [rows, 6] int32."""
    rows, cols = range_img.shape
    dev = range_img.device
    kind = torch.zeros((rows, cols), dtype=torch.uint8, device=dev)
    rest_counts = torch.zeros((rows, N_SECTORS), dtype=torch.int32, device=dev)
    for i, m in enumerate(keep.sum(1).tolist()):
        if m < 12:
            continue
        ci = torch.nonzero(keep[i]).squeeze(1)
        r = range_img[i, ci]
        curv = torch.full((m,), math.nan, dtype=torch.float32, device=dev)
        d = _window_sums(r) - 11 * r[CURV_HALF:m - CURV_HALF]
        curv[CURV_HALF:m - CURV_HALF] = d * d
        picked = torch.zeros(m, dtype=torch.bool, device=dev)
        picked[:CURV_HALF] = True
        picked[m - CURV_HALF:] = True
        step = r[1:] - r[:-1]
        k = torch.arange(CURV_HALF, m - 6, device=dev)
        near = (ci[k + 1] - ci[k]).abs() < 10
        for ks, offs in ((k[near & (step[k] < -0.3)], range(-5, 1)),
                         (k[near & (step[k] > 0.3)], range(1, 7))):
            for o in offs:
                picked[ks + o] = True
        dp = torch.zeros_like(r)
        dn = torch.zeros_like(r)
        dp[1:] = step.abs()
        dn[:-1] = step.abs()
        lim = 0.02 * r
        picked |= (dp > lim) & (dn > lim)

        cv, pk, cl = curv.tolist(), picked.tolist(), ci.tolist()
        edge = [False] * m
        bounds = sector_bounds(m)
        done = []
        for s in range(N_SECTORS):
            sp, ep = bounds[s], bounds[s + 1]
            if ep - sp < 2:
                continue
            cand = [q for q in range(sp, ep) if math.isfinite(cv[q]) and cv[q] > edge_threshold]
            cand.sort(key=lambda q: (cv[q], q), reverse=True)
            n_corner = 0
            for q in cand:
                if pk[q]:
                    continue
                edge[q] = True
                pk[q] = True
                n_corner += 1
                for l in range(q + 1, min(q + 6, m)):
                    if abs(cl[l] - cl[l - 1]) > 10:
                        break
                    pk[l] = True
                for l in range(q - 1, max(q - 6, -1), -1):
                    if abs(cl[l] - cl[l + 1]) > 10:
                        break
                    pk[l] = True
                if n_corner >= MAX_CORNERS:
                    break
            rest_counts[i, s] = (ep - sp) - sum(edge[sp:ep])
            done.append((sp, ep))
        code = torch.zeros(m, dtype=torch.uint8, device=dev)
        for sp, ep in done:
            code[sp:ep] = REST
        code[torch.tensor(edge, device=dev)] = EDGE
        kind[i, ci] = code
    return kind, rest_counts


def loam_features(range_img: torch.Tensor, keep: torch.Tensor, edge_threshold: float = 0.1):
    """(kind, rest_counts) as `loam_features_plain` gives them: the kernel
    on a CUDA tensor, the plain version on a CPU tensor.

    The kernel runs one block a ring (csrc/lidar.cu). It resolves each
    sector's greedy walk in parallel rounds: a live candidate that outranks
    the neighbours it would mark becomes a corner, and the live neighbours
    of corners drop. Marking is symmetric, so this gives the walk's corners,
    and its j-th corner is decided by round j: at most 20 rounds a sector,
    then the 20 corners that fewer than 20 others outrank are kept. Its time
    is its slowest ring's serial chain (the prologue, then two
    barrier-separated phases a round), not the bytes it moves."""
    if range_img.device.type == "cpu":
        return loam_features_plain(range_img, keep, edge_threshold)
    if range_img.device.type != "cuda":
        raise ValueError(f"loam_features: unsupported device {range_img.device}")
    dev = range_img.device
    rows, cols = range_img.shape
    lib = _lib()
    if cols > lib.cvo_lidar_max_cols():
        raise ValueError(f"loam_features: {cols} columns exceed the kernel's "
                         f"{lib.cvo_lidar_max_cols()}")
    kp = keep.contiguous()                              # bool: one byte, 0 or 1
    cuda_lib.check_tensor(range_img, "range_img", torch.float32, (rows, cols), dev,
                          "loam_features")
    cuda_lib.check_tensor(kp, "keep", torch.bool, (rows, cols), dev, "loam_features")
    kind = torch.empty((rows, cols), dtype=torch.uint8, device=dev)
    rest_counts = torch.empty((rows, N_SECTORS), dtype=torch.int32, device=dev)
    err = lib.cvo_lidar_loam_features(range_img.data_ptr(), kp.data_ptr(), kind.data_ptr(),
                                      rest_counts.data_ptr(), rows, cols, float(edge_threshold),
                                      torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, "loam_features kernel launch")
    loam_features.launches += 1
    return kind, rest_counts


loam_features.launches = 0


def reset_launches() -> None:
    components.launches = 0
    loam_features.launches = 0


def _lib():
    lib = cuda_lib.load("lidar")
    if not getattr(lib, "_argtypes_set", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.cvo_lidar_components.argtypes = [P, P, P, I, I, P]
        lib.cvo_lidar_components.restype = I
        lib.cvo_lidar_loam_features.argtypes = [P, P, P, P, I, I, ctypes.c_double, P]
        lib.cvo_lidar_loam_features.restype = I
        lib.cvo_lidar_max_cols.argtypes = []
        lib.cvo_lidar_max_cols.restype = I
        lib._argtypes_set = True
    return lib
