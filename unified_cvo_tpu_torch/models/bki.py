"""Semantic Bayesian-Kernel-Inference occupancy mapping, the L7 module, on
the device (port of unified_cvo_tpu/models/bki.py).

Reference: src/mapping/{bkioctomap,bkiblock,bkioctree}.cpp (SemanticBKIOctoMap,
insert_pointcloud_csm, bkioctomap.h:31-140): per-voxel Dirichlet
concentration vectors alpha over semantic classes (class 0 = free) updated
by sparse-kernel-weighted evidence from measured points, plus ray-cast
free-space samples.

The sparse BKI kernel (Melkumyan & Ramos; used by S-BKI):
  k(d) = sigma0 * [ (2 + cos(2 pi d/l)) (1 - d/l) / 3 + sin(2 pi d/l)/(2 pi) ]
for d < l, else 0.

Design. The map is two device tensors: `keys` (sorted int64 packed global
voxel coordinates, 21 bits a coordinate, JAX's _KEY_BIAS / _KEY_BITS) and
`alpha` ([V, C+1] float32). An insert generates every (point, candidate
voxel) pair of the pruned kernel cube (chunked only so that the [n, m]
intermediates stay bounded), keeps those of positive weight, sorts them by
key, sums each voxel's contributions exactly in int64 fixed point (2^-36,
finer than float32 there), and merges the sums into the map by sort and
unique. Integer sums do not depend on order, so two inserts of the same
data are bit-equal and the card and the CPU agree bit for bit.
JAX's uint32 key pair, 10-bit chunk-local keys and Morton chunk walk
(bki.py:121-165, 335-400) exist for the TPU and are not needed here.

Voxel floors take float32 positions over the float32 resolution, as JAX's
device floor does. The kernel weight is JAX's float32 formula with cos and
sin evaluated from IEEE adds and multiplies (Cody-Waite reduction, Cephes
polynomials) and the distance's root taken in float64, identical on the
card and the CPU: near the support edge the
weight is the cancellation of two O(1 - d/l) terms, so a last-bit change of
a library cos decides whether an edge voxel exists at all.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from unified_cvo_tpu_torch.device import resolve_device

# key packing: 21 bits per signed voxel coordinate
_KEY_BIAS = 1 << 20
_KEY_BITS = 21
_KEY_MASK = (1 << _KEY_BITS) - 1
# (point, candidate voxel) pairs per chunk: bounds the [n, m] intermediates
_CAND_BUDGET = 1 << 22

# Cody-Waite split of pi/2 (each piece times a quadrant index <= 4 is exact)
# and the Cephes sinf / cosf minimax polynomials on [-pi/4, pi/4]
_PIO2 = (1.5703125, 4.837512969970703125e-4, 7.54978995489188216e-8)
_SIN_POLY = (-1.9515295891e-4, 8.3321608736e-3, -1.6666654611e-1)
_COS_POLY = (2.443315711809948e-5, -1.388731625493765e-3, 4.166664568298827e-2)


def sparse_kernel(d: np.ndarray, ell: float, sigma0: float) -> np.ndarray:
    """NumPy twin of the device kernel (kept for tests / host callers)."""
    r = np.clip(d / ell, 0.0, 1.0)
    k = sigma0 * ((2.0 + np.cos(2 * np.pi * r)) * (1.0 - r) / 3.0
                  + np.sin(2 * np.pi * r) / (2 * np.pi))
    return np.where(d < ell, np.maximum(k, 0.0), 0.0)


def pack_keys(vox: torch.Tensor) -> torch.Tensor:
    """[..., 3] integer voxel coords -> sorted-comparable int64 keys."""
    v = vox.to(torch.int64) + _KEY_BIAS
    return (v[..., 0] << (2 * _KEY_BITS)) | (v[..., 1] << _KEY_BITS) | v[..., 2]


def unpack_keys(keys: torch.Tensor) -> torch.Tensor:
    """int64 keys -> [V, 3] int64 voxel coords."""
    return torch.stack([(keys >> (2 * _KEY_BITS)) - _KEY_BIAS,
                        ((keys >> _KEY_BITS) & _KEY_MASK) - _KEY_BIAS,
                        (keys & _KEY_MASK) - _KEY_BIAS], dim=-1)


@functools.lru_cache(maxsize=None)
def _kernel_offsets(reach: int, res_q: float, ell_q: float) -> np.ndarray:
    """Static candidate-voxel offsets: the cube [-reach, reach]^3 pruned to
    offsets whose minimum possible point-to-centre distance is < ell (JAX
    bki.py:72-80). Exact: every pruned offset has kernel weight 0."""
    offs = np.arange(-reach, reach + 1)
    grid = np.stack(np.meshgrid(offs, offs, offs, indexing="ij"), -1).reshape(-1, 3)
    dmin = np.linalg.norm(np.maximum(np.abs(grid) - 0.5, 0.0) * res_q, axis=1)
    return np.ascontiguousarray(grid[dmin < ell_q].astype(np.int64))


def _const(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def cos_sin(x: torch.Tensor):
    """(cos x, sin x) of float32 x in [0, 2 pi] from IEEE float32 adds and
    multiplies only, so every device gives the same bits (a library cosf
    differs between the CPU and CUDA in the last bit)."""
    c = functools.partial(_const, like=x)
    j = torch.floor(x * c(2.0 / np.pi) + c(0.5))
    z = ((x - j * c(_PIO2[0])) - j * c(_PIO2[1])) - j * c(_PIO2[2])
    z2 = z * z
    s = ((c(_SIN_POLY[0]) * z2 + c(_SIN_POLY[1])) * z2 + c(_SIN_POLY[2])) * z2 * z + z
    co = ((c(_COS_POLY[0]) * z2 + c(_COS_POLY[1])) * z2 + c(_COS_POLY[2])) * z2 * z2
    co = (co - c(0.5) * z2) + c(1.0)
    q = j.to(torch.int64) % 4
    cos_x = torch.where(q == 0, co, torch.where(q == 1, -s, torch.where(q == 2, -co, s)))
    sin_x = torch.where(q == 0, s, torch.where(q == 1, co, torch.where(q == 2, -s, -co)))
    return cos_x, sin_x


def _kernel_weights(pts: torch.Tensor, offsets: torch.Tensor, res: float, ell: float,
                    sigma0: float):
    """JAX's _chunk_weights in global coordinates: float32 points [n, 3] ->
    (keys [n, m] int64, weights [n, m] float32) over the candidate offsets."""
    c = functools.partial(_const, like=pts)
    res_t, ell_t = c(res), c(ell)
    base = torch.floor(pts / res_t).to(torch.int64)              # [n, 3]
    vox = base[:, None, :] + offsets[None, :, :]                 # [n, m, 3]
    diff = (vox.to(torch.float32) + c(0.5)) * res_t - pts[:, None, :]
    # CUDA's float32 sqrt is not correctly rounded; float64's is, and its
    # rounding to float32 is the correctly rounded float32 root
    d = torch.sqrt(((diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
                    + diff[..., 2] * diff[..., 2]).to(torch.float64)).to(torch.float32)
    r = torch.clamp(d / ell_t, 0.0, 1.0)
    cos_x, sin_x = cos_sin(c(2 * np.pi) * r)
    k = c(sigma0) * ((c(2.0) + cos_x) * (c(1.0) - r) / c(3.0) + sin_x / c(2 * np.pi))
    w = torch.where(d < ell_t, torch.clamp(k, min=0.0), 0.0)
    return pack_keys(vox), w


def _exact_sums(seg: torch.Tensor, n: int, rows: torch.Tensor, scale_log2: int):
    """Per-segment sums of float rows as exact int64 fixed point (units of
    2^-scale_log2): integer adds are exact in any order, so the sums are the
    same bits on every device and every run, with no atomics of floats.
    Returns float64 sums."""
    scale = float(2 ** scale_log2)
    bound = float(rows.to(torch.float64).abs().sum()) * scale
    if bound >= 2.0 ** 62:
        raise ValueError(f"BKI evidence too large for the fixed-point sum ({bound:.3g})")
    q = torch.round(rows.to(torch.float64) * scale).to(torch.int64)
    out = torch.zeros((n,) + tuple(rows.shape[1:]), dtype=torch.int64, device=rows.device)
    return out.index_add_(0, seg, q).to(torch.float64) / scale


def _segment_sums(keys: torch.Tensor, rows: torch.Tensor):
    """Per-key sums of float32 `rows` ([L] or [L, K]): keys sorted and made
    unique, each voxel's contributions summed exactly in fixed
    point at 2^-36 (below every float32 contribution's last bit down to
    2^-13, an absolute 7e-12 below that), rounded to float32. Returns
    (unique keys sorted, sums)."""
    ukeys, seg = torch.unique(keys, sorted=True, return_inverse=True)
    return ukeys, _exact_sums(seg, ukeys.shape[0], rows, 36).to(torch.float32)


@dataclasses.dataclass
class SemanticBKIMap:
    """Flat-voxel semantic BKI map. Class 0 is free space; classes 1..C are
    semantic categories (reference convention, bkioctree_node semantics).
    The map lives on `device` (None means the card): `keys` [V] sorted
    int64, `alpha` [V, C+1] float32 Dirichlet concentrations."""

    resolution: float = 0.1
    num_classes: int = 19          # semantic classes (excluding free)
    ell: float = 0.3               # BKI kernel support
    sigma0: float = 1.0
    prior: float = 0.001           # Dirichlet prior per class
    free_resolution: float = 0.5   # spacing of free-space ray samples
    device: Optional[object] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.keys = torch.zeros((0,), dtype=torch.int64, device=self.device)
        self.alpha = torch.zeros((0, self.num_classes + 1), dtype=torch.float32,
                                 device=self.device)

    def __len__(self):
        return int(self.keys.shape[0])

    # ---------------------------------------------------------------- insert

    def _contributions(self, positions: torch.Tensor):
        """(keys [L], weights [L] float32, point index [L]) of every
        (point, voxel) pair of positive kernel weight, point-major."""
        reach = int(np.ceil(self.ell / self.resolution))
        offsets = torch.from_numpy(
            _kernel_offsets(reach, float(self.resolution), float(self.ell))).to(self.device)
        pos32 = positions.to(torch.float32)
        chunk = max(1, _CAND_BUDGET // offsets.shape[0])
        keys, ws, idx = [], [], []
        for lo in range(0, pos32.shape[0], chunk):
            k, w = _kernel_weights(pos32[lo:lo + chunk], offsets, self.resolution,
                                   self.ell, self.sigma0)
            p, o = torch.nonzero(w > 0, as_tuple=True)
            keys.append(k[p, o])
            ws.append(w[p, o])
            idx.append(p + lo)
        return torch.cat(keys), torch.cat(ws), torch.cat(idx)

    def _merge(self, ukeys: torch.Tensor, sums: torch.Tensor):
        """Fold per-voxel evidence sums into the map: existing voxels add
        them, new voxels take them plus the Dirichlet prior; the merged keys
        stay sorted and unique."""
        V = self.keys.shape[0]
        pos = torch.searchsorted(self.keys, ukeys)
        hit = torch.zeros_like(ukeys, dtype=torch.bool)
        if V:
            hit = self.keys[pos.clamp(max=V - 1)] == ukeys
        alpha = self.alpha.clone()
        alpha[pos[hit]] = alpha[pos[hit]] + sums[hit]
        new = ~hit
        keys = torch.cat([self.keys, ukeys[new]])
        alpha = torch.cat([alpha, sums[new] + torch.tensor(
            self.prior, dtype=torch.float32, device=self.device)])
        keys, order = torch.sort(keys)
        self.keys, self.alpha = keys, alpha[order]

    def _accumulate(self, positions: torch.Tensor, evidence: torch.Tensor):
        """Scatter kernel-weighted evidence [N, C+1] from points onto all
        voxels within the kernel support."""
        if positions.shape[0] == 0:
            return
        keys, w, p = self._contributions(positions)
        self._merge(*_segment_sums(keys, w[:, None] * evidence.to(torch.float32)[p]))

    def _accumulate_scalar(self, positions: torch.Tensor, scale: torch.Tensor,
                           evec: np.ndarray):
        """Rank-1 evidence: every point contributes scale[p] * evec; the
        reduction is a scalar a voxel, expanded at unique-voxel count."""
        if positions.shape[0] == 0:
            return
        keys, w, p = self._contributions(positions)
        ukeys, s = _segment_sums(keys, scale.to(torch.float32)[p] * w)
        ev = torch.as_tensor(np.asarray(evec, np.float32), device=self.device)
        self._merge(ukeys, s[:, None] * ev[None, :])

    def _as_f64(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device, torch.float64)
        return torch.as_tensor(np.asarray(a, np.float64), device=self.device)

    def insert_pointcloud(self, xyz, labels=None, origin=None, max_range: float = -1.0):
        """The insert_pointcloud_csm equivalent (bkioctomap.h:89): occupied
        evidence from the measured points (their label distribution over
        classes 1..C) and free evidence sampled along the sensor rays.
        Inputs are numpy arrays or tensors; positions are float64 until the
        kernel takes them in float32, as in JAX."""
        xyz = self._as_f64(xyz).reshape(-1, 3)
        if labels is not None:
            labels = self._as_f64(labels).reshape(xyz.shape[0], -1)
        if origin is not None:
            origin = self._as_f64(origin).reshape(3)
        if max_range > 0 and origin is not None:
            rel = xyz - origin
            keep = torch.sqrt((rel[:, 0] * rel[:, 0] + rel[:, 1] * rel[:, 1])
                              + rel[:, 2] * rel[:, 2]) < max_range
            xyz = xyz[keep]
            labels = None if labels is None else labels[keep]
        n = xyz.shape[0]
        c1 = self.num_classes + 1
        if labels is None:
            # occupied, unknown class -> class 1 (rank-1 path)
            e1 = np.zeros(c1)
            e1[1] = 1.0
            self._accumulate_scalar(xyz, torch.ones(n, dtype=torch.float64,
                                                    device=self.device), e1)
        else:
            ev = torch.zeros((n, c1), dtype=torch.float64, device=self.device)
            ev[:, 1:1 + labels.shape[1]] = labels
            self._accumulate(xyz, ev)
        if origin is not None and n:
            self._insert_free(xyz, origin)

    def _insert_free(self, xyz: torch.Tensor, origin: torch.Tensor):
        """Free-space samples every free_resolution along each ray, folded
        per voxel into one count-weighted sample at their mean (the
        reference's ds_resolution downsampling of free training points,
        bkioctomap.cpp get_training_data); float64, as JAX's host code."""
        f64 = torch.float64
        rays = xyz - origin
        dist = torch.sqrt((rays[:, 0] * rays[:, 0] + rays[:, 1] * rays[:, 1])
                          + rays[:, 2] * rays[:, 2])
        smax = int(np.floor((float(dist.max()) - 1e-9) / self.free_resolution))
        if smax < 1:
            return
        t = torch.arange(1, smax + 1, dtype=f64, device=self.device) * self.free_resolution
        ok = t[None, :] <= dist[:, None] - 1e-9
        frac = t[None, :] / torch.clamp(dist[:, None], min=1e-12)
        fpos = (origin[None, None, :] + rays[:, None, :] * frac[..., None])[ok]
        q = torch.floor(fpos / torch.tensor(self.resolution, dtype=f64, device=self.device))
        ukeys, seg, counts = torch.unique(pack_keys(q), sorted=True, return_inverse=True,
                                          return_counts=True)
        # exact fixed-point sums (2^-32 m), the same bits on every device
        mean_pos = _exact_sums(seg, ukeys.shape[0], fpos, 32) / counts[:, None].to(f64)
        e0 = np.zeros(self.num_classes + 1)
        e0[0] = 1.0
        self._accumulate_scalar(mean_pos, counts.to(f64), e0)

    # ----------------------------------------------------------------- query

    def _lookup(self, vox: torch.Tensor):
        """[Q, 3] voxel coords -> (row index into alpha, found mask)."""
        q = pack_keys(vox)
        V = self.keys.shape[0]
        if V == 0:
            return torch.zeros_like(q), torch.zeros_like(q, dtype=torch.bool)
        idx = torch.searchsorted(self.keys, q).clamp(max=V - 1)
        return idx, self.keys[idx] == q

    def query(self, xyz):
        """Per-query-point (state, semantics) as numpy arrays: state 1
        occupied / -1 free / 0 unknown; semantics = argmax class (0 if
        free/unknown)."""
        xyz = self._as_f64(xyz).reshape(-1, 3)
        vox = torch.floor(xyz / torch.tensor(self.resolution, dtype=torch.float64,
                                             device=self.device))
        idx, found = self._lookup(vox)
        states = torch.zeros(xyz.shape[0], dtype=torch.int8, device=self.device)
        sems = torch.zeros(xyz.shape[0], dtype=torch.int32, device=self.device)
        if self.keys.shape[0]:
            a = self.alpha[idx]
            known = found & (a.sum(1) >= self.num_classes * self.prior * 2)
            cls = torch.argmax(a, dim=1)
            occ = known & (cls != 0)
            states[known & (cls == 0)] = -1
            states[occ] = 1
            sems = torch.where(occ, cls, 0).to(torch.int32)
        return states.cpu().numpy(), sems.cpu().numpy()

    def export_occupied(self):
        """(xyz [V,3] voxel centres float64, semantics [V] int32, alpha
        [V, C+1] float32) of occupied voxels as numpy arrays,
        Frame::export_points_from_map's source."""
        if self.keys.shape[0] == 0:
            return (np.zeros((0, 3)), np.zeros((0,), np.int32),
                    np.zeros((0, self.num_classes + 1)))
        cls = torch.argmax(self.alpha, dim=1)
        occ = cls != 0
        vox = unpack_keys(self.keys[occ]).to(torch.float64)
        centers = (vox + 0.5) * self.resolution
        return (centers.cpu().numpy(), cls[occ].to(torch.int32).cpu().numpy(),
                self.alpha[occ].cpu().numpy())
