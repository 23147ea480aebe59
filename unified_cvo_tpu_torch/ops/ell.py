"""Consume passes of the ELL hot loop: the flow pass that computes the
kernel matrix A and reduces the flow moments, and the step pass that reads
A back and reduces the quartic step coefficients B..E.

`flow_reduce` replaces unified_cvo_tpu/ops/pallas_ell.py::_flow_reduce_kernel
(flow_twist_ell_fused with emit_a=True) and `step_cached` replaces
_step_kernel_cached with _step_tail (step_coeffs_ell_fused_cached). On a
CUDA tensor each launches its kernel in csrc/ell.cu; on a CPU tensor each
runs its plain PyTorch version below, which is also the oracle the card's
kernels are held against.

Inputs are the JAX package's packed layout: `pack_x` [6, N] per-point rows
for the current ell and `pack_scalars` [32] pose and twist scalars, built on
the device so that no value crosses to the host.
"""

from __future__ import annotations

import ctypes

import torch

from unified_cvo_tpu_torch.ops import cuda_lib
from unified_cvo_tpu_torch.ops import lie
from unified_cvo_tpu_torch.ops.kernels import geometric_constants, range_ell
from unified_cvo_tpu_torch.utils.pointcloud import PointCloud

# x-pack rows
X0, X1, X2, THRES, NEGI2L2, COEF = range(6)
# scalar-block layout (pallas_ell.py:69-84)
S_RINV, S_TINV, S_SIGMA2, S_SP, S_OM2, S_VV = 0, 9, 12, 13, 14, 15
S_OMEGA, S_V, S_WV, S_C2 = 16, 19, 22, 25
S_VWV, S_WV2, S_VC2, S_VOM, S_LEN = 28, 29, 30, 31, 32


def pack_x(params, ell, x: PointCloud) -> torch.Tensor:
    """[6, N] per-point rows for the current ell: coords, distance-gate
    threshold (-1 for masked points), -1/(2 l_i^2), step coef 1/(2 l^2)."""
    l_i = range_ell(ell, torch.sqrt(torch.sum(x.xyz * x.xyz, dim=-1)))
    two_l2 = 2.0 * l_i * l_i
    log_term = geometric_constants(params)[2]
    thres = -two_l2 * log_term
    thres = torch.where(x.mask > 0, thres, torch.full_like(thres, -1.0))
    step_l = l_i if params.is_using_range_ell else ell * torch.ones_like(l_i)
    coef = 1.0 / (2.0 * step_l * step_l)
    return torch.stack([x.xyz[:, 0], x.xyz[:, 1], x.xyz[:, 2], thres,
                        -1.0 / two_l2, coef], dim=0)


def pack_scalars(params, R_inv, T_inv, twist=None) -> torch.Tensor:
    """[32] f32 scalar block: pose, kernel constants, and the twist's
    Taylor vectors (zeros when no twist is given)."""
    f = torch.float32
    sigma2, sp, _ = geometric_constants(params)
    parts = [R_inv.reshape(9).to(f), T_inv.to(f),
             R_inv.new_full((1,), sigma2, dtype=f),
             R_inv.new_full((1,), sp, dtype=f)]
    if twist is None:
        parts.append(R_inv.new_zeros((S_LEN - 14,), dtype=f))
    else:
        omega, v = twist[:3].to(f), twist[3:].to(f)
        W = lie.skew(omega)
        Wv = W @ v
        c2 = W @ Wv
        parts += [
            torch.stack([torch.dot(omega, omega), torch.dot(v, v)]),
            omega, v, Wv, c2,
            torch.stack([torch.dot(v, Wv), torch.dot(Wv, Wv),
                         torch.dot(v, c2), torch.dot(v, omega)]),
        ]
    return torch.cat(parts)


def _y_t(y_xyz, scal):
    """Raw slot coordinates moved by (R_inv, T_inv): 3 x [K, N]."""
    R = scal[S_RINV:S_RINV + 9]
    T = scal[S_TINV:S_TINV + 3]
    return [y_xyz[0] * R[3 * c] + y_xyz[1] * R[3 * c + 1]
            + y_xyz[2] * R[3 * c + 2] + T[c] for c in range(3)]


def flow_reduce_plain(xp, y_xyz, scal, c: float, d: float):
    """Plain version of the flow kernel: (unit twist [6], joint_norm,
    nonzeros, a_sum, A [K, N]) as pallas_ell.flow_twist_ell_fused returns
    them with emit_a=True."""
    x = [xp[r:r + 1] for r in range(6)]                     # [1, N] rows
    yt = _y_t(y_xyz, scal)
    d2 = (x[X0] - yt[0]) ** 2 + (x[X1] - yt[1]) ** 2 + (x[X2] - yt[2]) ** 2
    kgeo = scal[S_SIGMA2] * torch.exp(d2 * x[NEGI2L2])
    # dead slots carry DEAD_COORD coordinates: the gate is false there
    a = torch.where((d2 < x[THRES]) & (kgeo > scal[S_SP]), kgeo,
                    torch.zeros_like(kgeo))
    s = torch.sum(a, dim=0)
    wy = [torch.sum(a * yt[i], dim=0) for i in range(3)]
    xr = [xp[i] for i in range(3)]
    om = [xr[(i + 1) % 3] * wy[(i + 2) % 3] - xr[(i + 2) % 3] * wy[(i + 1) % 3]
          for i in range(3)]
    v = [wy[i] - s * xr[i] for i in range(3)]
    t = torch.stack([torch.sum(r) for r in om + v])
    joint = torch.cat([t[:3] / c, t[3:] / d])
    jn = torch.linalg.vector_norm(joint)
    unit = joint / torch.where(jn < 1e-30, torch.ones_like(jn), jn)
    nz = torch.sum(a > 0).to(torch.int32)
    return unit, jn, nz, torch.sum(s), a


def step_cached_plain(xp, y_xyz, a, scal) -> torch.Tensor:
    """Plain version of the step kernel: [4] = (B, C, D, E) from the cached
    kernel matrix `a` (pallas_ell._step_kernel_cached + _step_tail)."""
    x = [xp[r:r + 1] for r in range(6)]
    # zero y_t where A == 0: dead slots carry DEAD_COORD and beta^4 of a
    # 1e9-scale value is inf, which 0 * inf would turn into NaN
    y = [torch.where(a > 0, yc, torch.zeros_like(yc)) for yc in _y_t(y_xyz, scal)]
    S = scal
    om = [S[S_OMEGA + i] for i in range(3)]
    om2 = S[S_OM2]
    t = y[0] * om[0] + y[1] * om[1] + y[2] * om[2]
    yy = y[0] * y[0] + y[1] * y[1] + y[2] * y[2]
    uu = om2 * yy - t * t                                    # |W y|^2

    def ydot(base):
        return y[0] * S[base] + y[1] * S[base + 1] + y[2] * S[base + 2]

    def xdot(base):
        return x[X0] * S[base] + x[X1] * S[base + 1] + x[X2] * S[base + 2]

    yv, ywv, yc2 = ydot(S_V), ydot(S_WV), ydot(S_C2)
    u = [y[(i + 2) % 3] * om[(i + 1) % 3] - y[(i + 1) % 3] * om[(i + 2) % 3]
         for i in range(3)]                                  # u = W y
    xu = x[X0] * u[0] + x[X1] * u[1] + x[X2] * u[2]
    xy = x[X0] * y[0] + x[X1] * y[1] + x[X2] * y[2]
    d1 = xu + (xdot(S_V) - yv)                               # diff . xiz
    dw = xdot(S_OMEGA) * t - om2 * xy + uu                   # diff . W^2 y
    d2 = dw + (xdot(S_WV) - ywv)                             # diff . xi2z
    d3 = -om2 * xu + (xdot(S_C2) - yc2)                      # diff . xi3z
    d4 = -om2 * d2                                           # xi4z = -om2 xi2z
    normxiz2 = uu - 2.0 * ywv + S[S_VV]
    vw = S[S_VOM] * t - om2 * yv                             # v . W^2 y
    xdx2 = yc2 - vw - S[S_VWV]
    epsc = -om2 * uu + 2.0 * om2 * ywv + S[S_WV2] + 2.0 * S[S_VC2]
    coef = x[COEF]
    beta = -2.0 * coef * d1
    gamma = -coef * (normxiz2 + 2.0 * d2)
    delta = 2.0 * coef * (xdx2 - d3)
    epsil = -coef * (epsc + 2.0 * d4)
    b2 = beta * beta
    return torch.stack([
        torch.sum(a * beta),
        torch.sum(a * (gamma + 0.5 * b2)),
        torch.sum(a * (delta + beta * gamma + b2 * beta / 6.0)),
        torch.sum(a * (epsil + beta * delta + 0.5 * b2 * gamma
                       + 0.5 * gamma * gamma + b2 * b2 / 24.0)),
    ])


def _common_checks(xp, y_xyz, scal, who):
    if y_xyz.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {y_xyz.device}")
    dev = y_xyz.device
    K, N = y_xyz.shape[1], y_xyz.shape[2]
    cuda_lib.check_tensor(y_xyz, "y_xyz", torch.float32, (3, K, N), dev, who)
    cuda_lib.check_tensor(xp, "xp", torch.float32, (6, N), dev, who)
    cuda_lib.check_tensor(scal, "scal", torch.float32, (S_LEN,), dev, who)
    return dev, K, N


def flow_reduce(xp, y_xyz, scal, c: float, d: float):
    """Flow pass: (unit twist [6], joint_norm, nonzeros, a_sum, A [K, N]).
    The CUDA kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if y_xyz.device.type == "cpu":
        return flow_reduce_plain(xp, y_xyz, scal, c, d)
    dev, K, N = _common_checks(xp, y_xyz, scal, "flow_reduce")
    lib = _lib()
    nb = lib.cvo_ell_blocks(N)
    A = torch.empty((K, N), dtype=torch.float32, device=dev)
    part = torch.empty((nb, 7), dtype=torch.float32, device=dev)
    part_cnt = torch.empty((nb,), dtype=torch.int32, device=dev)
    out = torch.empty((8,), dtype=torch.float32, device=dev)
    nz = torch.empty((1,), dtype=torch.int32, device=dev)
    err = lib.cvo_flow_reduce(
        xp.data_ptr(), y_xyz.data_ptr(), scal.data_ptr(), A.data_ptr(),
        part.data_ptr(), part_cnt.data_ptr(), out.data_ptr(), nz.data_ptr(),
        N, K, float(c), float(d), torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, "flow_reduce kernel launch")
    flow_reduce.launches += 1
    return out[:6], out[6], nz[0], out[7], A


flow_reduce.launches = 0


def step_cached(xp, y_xyz, a, scal) -> torch.Tensor:
    """Step pass from the cached kernel matrix: [4] = (B, C, D, E).
    The CUDA kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if y_xyz.device.type == "cpu":
        return step_cached_plain(xp, y_xyz, a, scal)
    dev, K, N = _common_checks(xp, y_xyz, scal, "step_cached")
    cuda_lib.check_tensor(a, "a", torch.float32, (K, N), dev, "step_cached")
    lib = _lib()
    part = torch.empty((lib.cvo_ell_blocks(N), 4), dtype=torch.float32, device=dev)
    out = torch.empty((4,), dtype=torch.float32, device=dev)
    err = lib.cvo_step_cached(
        xp.data_ptr(), y_xyz.data_ptr(), a.data_ptr(), scal.data_ptr(),
        part.data_ptr(), out.data_ptr(), N, K,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, "step_cached kernel launch")
    step_cached.launches += 1
    return out


step_cached.launches = 0


def _lib():
    lib = cuda_lib.load("ell")
    if not getattr(lib, "_argtypes_set", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.cvo_ell_blocks.argtypes = [I]
        lib.cvo_ell_blocks.restype = I
        lib.cvo_flow_reduce.argtypes = [P, P, P, P, P, P, P, P, I, I, F, F, P]
        lib.cvo_flow_reduce.restype = I
        lib.cvo_step_cached.argtypes = [P, P, P, P, P, P, I, I, P]
        lib.cvo_step_cached.restype = I
        lib._argtypes_set = True
    return lib
