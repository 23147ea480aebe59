"""Census / semi-global stereo matching in torch ops (port of
unified_cvo_tpu/ops/sgm.py): the stereo frontend's disparity on the device.

census -> hamming cost volume -> 6-path SGM aggregation (two batched
scans) -> WTA + uniqueness + subpixel -> left/right consistency -> 3x3
valid-median -> density speckle test, with the JAX package's semantics
(which transcribe native/cvo_native.cpp):
  - 5x5 edge-clamped census, 24-bit signature
  - cost(y,x,d) = popcount(cl[y,x] ^ cr[y,x-d]), 24 where x-d < 0
  - per-direction recurrence Lc = c + min(Lp[d], Lp[d+-1]+P1, minprev+P2)
    - minprev over dirs {(1,0),(-1,0),(0,1),(0,-1),(1,1),(-1,-1)}
  - WTA first-min, uniqueness test vs second-best outside |d-best|<=1,
    parabolic subpixel
  - right disparity from the same volume: argmin_d agg[y, x+d, d]
  - LR check: keep d >= 0.5 with |disp_r[x - round(d)] - d| <= 1.5
  - 3x3 median over valid neighbors when self valid and n >= 5
  - speckle: a valid pixel needs `speckle_density` valid neighbours within
    |Delta d| <= 2 in its 9x9 window

Every cost and aggregate is int32, as in JAX: the census signature has 24
bits, so it fits an int32 and its popcount is a SWAR sum of bytes. Every
float step rounds as JAX's does (float32 throughout, ties broken at the
first minimum by `argmin`), so a disparity agrees with JAX's to f32
division and with the same call on another device exactly.

The two scans (`_sgm_scan`, JAX's `lax.scan`) run on the card as one
launch each of the hand kernel in csrc/sgm.cu: a warp a scanline or
diagonal, the step loop inside the kernel. On a CPU tensor they run
`sgm_scan_plain`, a Python loop of torch ops over the steps.

`sgm_disparity_native` is the host frontend's disparity: the C++ census-SGM
of native/cvo_native.cpp (JAX's `native.sgm_disparity`) bit for bit. The
stages to the median are the same arithmetic (its uint16 path costs never
reach their 60000 cap at the default penalties, and its subpixel values
are integers in float32 until one division and one add); it differs in
`1.0f + uniqueness` rounded in float32 and in its speckle rule, a region
flood fill, which `speckle_regions` computes as connected components.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from unified_cvo_tpu_torch.ops import cuda_lib, lidar

INF = 1 << 28
INT32_MAX = (1 << 31) - 1
MAX_COST = 24          # 24-bit census: hamming <= 24


def _clamped(n: int, pad: int, device) -> torch.Tensor:
    return torch.clamp(torch.arange(-pad, n + pad, device=device), 0, n - 1)


def census_5x5(gray: torch.Tensor) -> torch.Tensor:
    """[H, W] integer-valued -> int32 24-bit census signature (bit set where
    the edge-clamped neighbour is darker, neighbours in row-major order)."""
    g = torch.as_tensor(gray).to(torch.int32)
    h, w = g.shape
    p = g.index_select(0, _clamped(h, 2, g.device)).index_select(1, _clamped(w, 2, g.device))
    sig = torch.zeros_like(g)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            if dy == 0 and dx == 0:
                continue
            bit = (p[2 + dy:2 + dy + h, 2 + dx:2 + dx + w] < g).to(torch.int32)
            sig = (sig << 1) | bit
    return sig


def _popcount24(x: torch.Tensor) -> torch.Tensor:
    """Set bits of non-negative int32 values below 2**24 (SWAR: pairs,
    nibbles, bytes, then the three bytes summed)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x & 0xFF) + ((x >> 8) & 0xFF) + ((x >> 16) & 0xFF)


def _cost_volume(cl: torch.Tensor, cr: torch.Tensor, D: int) -> torch.Tensor:
    """[H, W, D] int32 hamming costs; 24 where the right pixel is off-frame."""
    h, w = cl.shape
    xd = (torch.arange(w, device=cl.device)[:, None]
          - torch.arange(D, device=cl.device)[None, :])        # [W, D]: x - d
    crd = F.pad(cr, (D, 0))[:, xd + D]                          # [H, W, D]
    ham = _popcount24(cl[:, :, None] ^ crd)
    return torch.where(xd >= 0, ham, MAX_COST)


def _shift_lines(a: torch.Tensor, fill: int) -> torch.Tensor:
    """a [g, L, X] moved one line along L (line l takes line l - 1), `fill`
    in line 0."""
    return F.pad(a[:, :-1], (0, 0, 1, 0), value=fill)


def sgm_scan_plain(costs: torch.Tensor, has_prev_masks, n_shift: int,
                   P1: int, P2: int, cap=None) -> torch.Tensor:
    """Batched SGM recurrence, a step of torch ops at a time (the plain
    version of csrc/sgm.cu).

    costs: [S, G, L, D] int32, contiguous: S scan steps of G direction
    members over L lines. has_prev_masks: [G, L] bool, lines whose in-step
    predecessor exists (applied from step 1; step 0 always starts a
    scanline), or None when every line has one. The last `n_shift`
    members shift their state +1 along L between steps (the diagonal
    directions: the predecessor is one line over). `cap` saturates Lc (None:
    no cap). Returns the per-step Lc volume [S, G, L, D] int32."""
    S, G, L, D = costs.shape
    out = torch.empty_like(costs)
    out[0] = costs[0]
    Lp = costs[0]
    minprev = Lp.amin(-1, keepdim=True)
    hp = None if has_prev_masks is None else has_prev_masks[:, :, None]
    for s in range(1, S):
        if n_shift:
            k = G - n_shift
            Lp = torch.cat([Lp[:k], _shift_lines(Lp[k:], INF)])
            minprev = torch.cat([minprev[:k], _shift_lines(minprev[k:], 0)])
        pd = F.pad(Lp, (1, 1), value=INF)
        best = torch.minimum(
            Lp, torch.minimum(torch.minimum(pd[..., :-2], pd[..., 2:]) + P1,
                              minprev + P2))
        Lc = costs[s] + best - minprev
        if cap is not None:
            Lc = torch.clamp(Lc, max=cap)
        if hp is not None:
            Lc = torch.where(hp, Lc, costs[s])
        out[s] = Lc
        Lp = Lc
        minprev = Lc.amin(-1, keepdim=True)
    return out


def _sgm_scan(costs: torch.Tensor, has_prev_masks, n_shift: int,
              P1: int, P2: int, cap=None) -> torch.Tensor:
    """The recurrence as `sgm_scan_plain` computes it: the kernel of
    csrc/sgm.cu on a CUDA tensor (one launch, counted in
    `_sgm_scan.launches`), the plain version on a CPU tensor."""
    if costs.device.type == "cpu":
        return sgm_scan_plain(costs, has_prev_masks, n_shift, P1, P2, cap)
    if costs.device.type != "cuda":
        raise ValueError(f"sgm_scan: unsupported device {costs.device}")
    dev = costs.device
    if costs.dim() != 4:
        raise ValueError(f"sgm_scan: costs must be [S, G, L, D]; got {tuple(costs.shape)}")
    S, G, L, D = costs.shape
    cuda_lib.check_tensor(costs, "costs", torch.int32, (S, G, L, D), dev, "sgm_scan")
    hp = None
    if has_prev_masks is not None:
        hp = has_prev_masks.contiguous()                # bool: one byte, 0 or 1
        cuda_lib.check_tensor(hp, "has_prev_masks", torch.bool, (G, L), dev, "sgm_scan")
    cap = INT32_MAX if cap is None else int(cap)       # min(Lc, INT32_MAX) is Lc
    if not (0 <= n_shift <= G and all(-INT32_MAX - 1 <= v <= INT32_MAX for v in (P1, P2, cap))):
        raise ValueError(f"sgm_scan: n_shift {n_shift} must lie in [0, {G}] and P1 {P1}, "
                         f"P2 {P2}, cap {cap} in int32")
    lib = _lib()
    if min(S, G, L) <= 0 or not 0 < D <= lib.cvo_sgm_max_d():
        raise ValueError(f"sgm_scan: shape {tuple(costs.shape)} needs S, G, L > 0 and "
                         f"0 < D <= {lib.cvo_sgm_max_d()}")
    out = torch.empty_like(costs)
    err = lib.cvo_sgm_scan(costs.data_ptr(), out.data_ptr(), None if hp is None else hp.data_ptr(),
                           S, G, L, D, n_shift, int(P1), int(P2), cap,
                           torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, "sgm_scan kernel launch")
    _sgm_scan.launches += 1
    return out


_sgm_scan.launches = 0


def reset_launches() -> None:
    _sgm_scan.launches = 0


def _lib():
    lib = cuda_lib.load("sgm")
    if not getattr(lib, "_argtypes_set", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.cvo_sgm_scan.argtypes = [P, P, P, I, I, I, I, I, I, I, I, P]
        lib.cvo_sgm_scan.restype = I
        lib.cvo_sgm_max_d.argtypes = []
        lib.cvo_sgm_max_d.restype = I
        lib._argtypes_set = True
    return lib


def _aggregate(cost: torch.Tensor, max_disp: int, p1: int, p2: int,
               cap=None) -> torch.Tensor:
    """Sum of the six path costs, [H, W, D] int32 (each path cost saturated
    at `cap` where given)."""
    h, w, D = cost.shape
    # ---- horizontal scan over x: members (1,0) and (-1,0) (x-flipped)
    xs = torch.stack([cost, cost.flip(1)]).permute(2, 0, 1, 3).contiguous()  # [W,2,H,D]
    out_h = _sgm_scan(xs, None, 0, p1, p2, cap)
    agg = torch.empty_like(cost)
    torch.add(out_h[:, 0].permute(1, 0, 2), out_h[:, 1].flip(0).permute(1, 0, 2), out=agg)
    del out_h, xs
    # ---- vertical/diagonal scan over y: members (0,1), (0,-1) (y-flip),
    # (1,1) (x-shift), (-1,-1) (y+x flip, x-shift)
    ys = torch.stack([cost, cost.flip(0), cost, cost.flip(0, 1)], 1)      # [H,4,W,D]
    xcols = torch.arange(w, device=cost.device)
    hp = torch.stack([torch.ones_like(xcols, dtype=torch.bool)] * 2 + [xcols >= 1] * 2)
    out_v = _sgm_scan(ys, hp, 2, p1, p2, cap)
    agg += out_v[:, 0]
    agg += out_v[:, 1].flip(0)
    agg += out_v[:, 2]
    agg += out_v[:, 3].flip(0, 1)
    return agg


# optimal 9-element sorting network (25 compare-exchanges)
_MEDIAN9 = ((0, 1), (3, 4), (6, 7), (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7),
            (0, 3), (3, 6), (0, 3), (1, 4), (4, 7), (1, 4), (2, 5), (5, 8), (2, 5),
            (1, 3), (5, 7), (2, 6), (4, 6), (2, 4), (2, 3), (5, 6))


def _windows(a: torch.Tensor, r: int, fill: float) -> torch.Tensor:
    """[(2r+1)^2, H, W]: a's (2r+1)x(2r+1) neighbourhoods, `fill` outside,
    offsets in row-major order (dy outer, dx inner)."""
    h, w = a.shape
    p = F.pad(a, (r, r, r, r), value=fill)
    return p.unfold(0, h, 1).unfold(1, w, 1).reshape(-1, h, w)


def _sgm_until_median(left, right, max_disp: int, p1: int, p2: int,
                      uniqueness_factor, cap=None) -> torch.Tensor:
    """The stages both SGM variants share, census to the 3x3 median: left
    disparity [H, W] float32, -1 where invalid. `uniqueness_factor` is the
    float32 scalar the best cost is multiplied by before it is compared with
    the second best; `cap` saturates every path cost (None: no cap)."""
    f32 = torch.float32
    cl = census_5x5(left)
    cr = census_5x5(right)
    dev = cl.device
    D = max_disp
    agg = _aggregate(_cost_volume(cl, cr, D), D, p1, p2, cap)            # [H, W, D]
    h, w = cl.shape

    # ---- WTA (first minimum) + uniqueness + subpixel
    bc, best = agg.amin(-1), agg.argmin(-1)
    rel = torch.arange(D, device=dev) - best[..., None]
    second = torch.where(rel.abs() <= 1, INF, agg).amin(-1)
    c1 = bc.to(f32)
    ambiguous = (second < INF) & (c1 * torch.tensor(uniqueness_factor, dtype=f32)
                                  > second.to(f32))
    c0 = agg.gather(-1, (best - 1).clamp(min=0)[..., None])[..., 0].to(f32)
    c2 = agg.gather(-1, (best + 1).clamp(max=D - 1)[..., None])[..., 0].to(f32)
    c0 = torch.where(best > 0, c0, 0.0)
    c2 = torch.where(best < D - 1, c2, 0.0)
    denom = c0 - 2.0 * c1 + c2
    interior = (best > 0) & (best < D - 1) & (denom > 1e-6)
    disp_l = best.to(f32) + torch.where(
        interior, 0.5 * (c0 - c2) / torch.where(denom > 1e-6, denom, 1.0), 0.0)
    disp_l = torch.where(ambiguous, -1.0, disp_l)

    # ---- right disparity from the same volume: argmin_d agg[y, x+d, d],
    # read through a sheared view of the volume padded with INF past W
    aggp = F.pad(agg, (0, 0, 0, D), value=INF)                          # [H, W+D, D]
    sheared = aggp.as_strided((h, w, D), ((w + D) * D, D, D + 1))
    disp_r = sheared.argmin(-1).to(f32)
    disp_r = torch.where(sheared.amin(-1) >= INF, -1.0, disp_r)
    del aggp, sheared

    # ---- LR consistency
    xr = torch.arange(w, device=dev)[None, :] - torch.floor(disp_l + 0.5).to(torch.int64)
    dr = disp_r.gather(1, xr.clamp(0, w - 1))
    keep = (disp_l >= 0.5) & (xr >= 0) & (dr >= 0) & ((dr - disp_l).abs() <= 1.5)
    disp = torch.where(keep, disp_l, -1.0)

    # ---- 3x3 median over valid neighbors (self valid and n >= 5)
    neigh = _windows(disp, 1, -1.0)
    n = (neigh > 0).sum(0)
    vals = list(torch.where(neigh > 0, neigh, 1e9).unbind(0))
    for a, b in _MEDIAN9:
        vals[a], vals[b] = torch.minimum(vals[a], vals[b]), torch.maximum(vals[a], vals[b])
    med = torch.stack(vals).gather(0, (n // 2)[None])[0]
    return torch.where((disp > 0) & (n >= 5), med, disp)


def sgm_disparity_device(left, right, max_disp: int = 128, p1: int = 10,
                         p2: int = 120, uniqueness: float = 0.1,
                         speckle_density: int = 12) -> torch.Tensor:
    """Left disparity [H, W] float32 on the inputs' device; <= 0 where
    invalid. left/right: [H, W] integer-valued grayscale tensors. The
    device frontend's variant (JAX ops/sgm.py): the density speckle test."""
    f32 = torch.float32
    disp = _sgm_until_median(left, right, max_disp, p1, p2, np.float32(1.0 + uniqueness))
    v = disp > 0
    nb = _windows(torch.where(v, disp, 0.0), 4, 0.0)
    nv = _windows(v.to(f32), 4, 0.0) > 0
    cnt = (nv & ((nb - disp).abs() <= 2.0)).sum(0)
    return torch.where(v & (cnt < speckle_density), -1.0, disp)


# ---------------------------------------------------------------- native/


NATIVE_PATH_CAP = 60000     # cvo_native.cpp's uint16 path costs saturate here
NATIVE_SPECKLE_MIN = 120    # its kSpeckleMin


def speckle_regions(disp: torch.Tensor, min_size: int = NATIVE_SPECKLE_MIN,
                    max_diff: float = 1.0) -> torch.Tensor:
    """cvo_native.cpp's speckle removal: the 4-connected regions of valid
    pixels (> 0) whose neighbours differ by at most `max_diff` (in float32)
    are set to -1 where they hold fewer than `min_size` pixels. The regions
    are the connected components of those links (ops/lidar.py::components:
    the L1 kernel on the card, its plain version on the CPU), with no
    horizontal link out of the last column, so nothing wraps."""
    labels = lidar.components(*speckle_links(disp, max_diff)).reshape(-1).to(torch.int64)
    size = torch.bincount(labels, minlength=labels.numel())[labels].view_as(disp)
    return torch.where((disp > 0) & (size < min_size), -1.0, disp)


def speckle_links(disp: torch.Tensor, max_diff: float = 1.0):
    """(link_v [H - 1, W], link_h [H, W]) of speckle_regions: neighbours
    both valid and within `max_diff`, no link out of the last column."""
    v = disp > 0
    link_v = v[:-1] & v[1:] & ((disp[1:] - disp[:-1]).abs() <= max_diff)
    link_h = torch.zeros_like(v)
    link_h[:, :-1] = v[:, :-1] & v[:, 1:] & ((disp[:, 1:] - disp[:, :-1]).abs() <= max_diff)
    return link_v, link_h


def sgm_disparity_native(left, right, max_disp: int = 128, p1: int = 10, p2: int = 120,
                         uniqueness: float = 0.1) -> torch.Tensor:
    """native/cvo_native.cpp's cvo_sgm_disparity (the JAX package's
    `native.sgm_disparity`, compute_disparity's backend on a machine without
    OpenCV) bit for bit, on the inputs' device: the shared stages to the
    median with the C++'s float32 `1.0f + uniqueness` and its uint16 path
    costs (saturating at 60000; a cap that binds only where p2 > 59976),
    then the region speckle. left/right: [H, W] uint8-valued grey images.
    Raises RuntimeError where the C++ returns -1."""
    h, w = left.shape[-2:]
    if tuple(right.shape) != tuple(left.shape) or left.dim() != 2:
        raise ValueError(f"sgm_disparity_native: left {tuple(left.shape)} and right "
                         f"{tuple(right.shape)} must be one [H, W] shape")
    if h <= 0 or w <= 0 or max_disp <= 0 or max_disp > 256:
        raise RuntimeError(f"cvo_sgm_disparity failed: -1 (h {h}, w {w}, max_disp {max_disp})")
    if not (0 <= p1 <= 0xFFFF and 0 <= p2 <= 0xFFFF):
        raise ValueError(f"sgm_disparity_native: p1 {p1} and p2 {p2} must fit the C++'s "
                         f"uint16 costs")
    cap = NATIVE_PATH_CAP if p2 + MAX_COST > NATIVE_PATH_CAP else None
    disp = _sgm_until_median(left, right, max_disp, p1, p2,
                             np.float32(1.0) + np.float32(uniqueness), cap)
    return speckle_regions(disp)
