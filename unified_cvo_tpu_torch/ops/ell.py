"""Consume passes of the ELL hot loop and their entry points: the flow pass
that computes the kernel matrix A and reduces the flow moments, the step
pass that reads A back and reduces the quartic step coefficients B..E, and
the two passes that recompute A themselves (per-point flow rows, uncached
step).

  `flow_reduce`   replaces unified_cvo_tpu/ops/pallas_ell.py::
                  _flow_reduce_kernel (flow_twist_ell_fused, emit_a=True);
  `step_cached`   replaces _step_kernel_cached with _step_tail
                  (step_coeffs_ell_fused_cached);
  `flow_rows`     replaces _flow_kernel (flow_stats_ell_fused);
  `step_uncached` replaces _step_kernel with reduced=True
                  (step_coeffs_ell_fused).

On a CUDA tensor each launches its kernel in csrc/ell.cu; on a CPU tensor
each runs its plain PyTorch version below, which is also the oracle the
card's kernels are held against. The passes that evaluate A come in the
three variants of pallas_ell._transform_and_a: geometry only ("geo"),
geometry times the channel factor ("geo_chan") and the channel factor
alone ("chan", from a scan list built without geometry). Each wrapper
counts its launches in total (`launches`) and per variant
(`variant_launches`).

Inputs are the JAX package's packed layout: `pack_x` [6, N] per-point rows
for the current ell and `pack_scalars` [32] pose and twist scalars, built on
the device so that no value crosses to the host. `step_cached` also takes
the flow's unit twist as a device tensor and builds the block's twist part
(`twist_scalars`) in the kernel, so the loop builds one block per iteration.

Every pass runs as one launch: the last block to finish sums the per-block
partials and resets a ticket counter. The counters (`finish_counters`, one
int32 per kernel and lane) are allocated once per device and assume one
stream per device, as the port runs.

`flow_reduce_lanes` and `step_cached_lanes` are the flow and step passes
with a lane axis: B independent pairs in one launch, every input and output
[B, ...] (`pack_x` and `pack_scalars` take the same leading axis). They are
the counterparts of the Pallas kernels under the JAX package's
`jax.vmap(align)` (parallel/batch_align.py), where the batch becomes a grid
axis. Each lane's result equals the unbatched launch's on that lane's
inputs, bit for bit; their plain versions are flow_reduce_plain and
step_cached_plain, which take the same leading axis.
"""

from __future__ import annotations

import ctypes

import torch

from unified_cvo_tpu_torch.ops import cuda_lib
from unified_cvo_tpu_torch.ops.kernels import FlowStats, geometric_constants, range_ell
from unified_cvo_tpu_torch.utils.pointcloud import PointCloud

# x-pack rows
X0, X1, X2, THRES, NEGI2L2, COEF = range(6)
# scalar-block layout (pallas_ell.py:69-84)
S_RINV, S_TINV, S_SIGMA2, S_SP, S_OM2, S_VV = 0, 9, 12, 13, 14, 15
S_OMEGA, S_V, S_WV, S_C2 = 16, 19, 22, 25
S_VWV, S_WV2, S_VC2, S_VOM, S_LEN = 28, 29, 30, 31, 32
# kernel variants, in the order of csrc/ell.cu's variant codes
VARIANTS = ("geo", "geo_chan", "chan")


def variant(chan, use_geometry: bool) -> str:
    """The variant of the A evaluation for this channel factor and switch."""
    if use_geometry:
        return "geo" if chan is None else "geo_chan"
    if chan is None:
        raise ValueError("an ELL pass needs the geometric channel or a channel "
                         "factor to evaluate the kernel")
    return "chan"


def pack_x(params, ell, x: PointCloud) -> torch.Tensor:
    """[6, N] per-point rows for the current ell: coords, distance-gate
    threshold (-1 for masked points), -1/(2 l_i^2), step coef 1/(2 l^2).
    With a lane axis (x.xyz [B, N, 3], ell [B]): [B, 6, N]."""
    if x.xyz.dim() == 3:
        ell = ell[..., None]
    l_i = range_ell(ell, torch.sqrt(torch.sum(x.xyz * x.xyz, dim=-1)))
    two_l2 = 2.0 * l_i * l_i
    log_term = geometric_constants(params)[2]
    thres = -two_l2 * log_term
    thres = torch.where(x.mask > 0, thres, torch.full_like(thres, -1.0))
    step_l = l_i if params.is_using_range_ell else ell * torch.ones_like(l_i)
    coef = 1.0 / (2.0 * step_l * step_l)
    return torch.stack([x.xyz[..., 0], x.xyz[..., 1], x.xyz[..., 2], thres,
                        -1.0 / two_l2, coef], dim=-2)


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(w, u):
    return torch.stack([w[..., 1] * u[..., 2] - w[..., 2] * u[..., 1],
                        w[..., 2] * u[..., 0] - w[..., 0] * u[..., 2],
                        w[..., 0] * u[..., 1] - w[..., 1] * u[..., 0]], dim=-1)


def twist_scalars(twist) -> torch.Tensor:
    """[18] f32 twist part of the scalar block (S_OM2 .. S_VOM) from the
    unit twist (omega, v): |omega|^2, |v|^2, omega, v, W v, W^2 v, v.Wv,
    |Wv|^2, v.W^2 v, v.omega with W = skew(omega). W v and W^2 v are cross
    products with omega and every dot sums left to right, one rounding per
    operation: csrc/ell.cu::twist_scalars does the same operations in the
    same order. A leading lane axis ([B, 6] -> [B, 18]) is kept."""
    f = torch.float32
    omega, v = twist[..., :3].to(f), twist[..., 3:].to(f)
    Wv = _cross(omega, v)
    c2 = _cross(omega, Wv)
    return torch.cat([
        torch.stack([_dot3(omega, omega), _dot3(v, v)], dim=-1), omega, v, Wv, c2,
        torch.stack([_dot3(v, Wv), _dot3(Wv, Wv), _dot3(v, c2), _dot3(v, omega)], dim=-1),
    ], dim=-1)


def pack_scalars(params, R_inv, T_inv, twist=None) -> torch.Tensor:
    """[32] f32 scalar block: pose, kernel constants, and the twist's
    Taylor vectors (`twist_scalars`; zeros when no twist is given). With a
    lane axis (R_inv [B, 3, 3], T_inv [B, 3]): [B, 32]."""
    f = torch.float32
    sigma2, sp, _ = geometric_constants(params)
    lead = tuple(R_inv.shape[:-2])
    parts = [R_inv.reshape(lead + (9,)).to(f), T_inv.to(f),
             R_inv.new_full(lead + (1,), sigma2, dtype=f),
             R_inv.new_full(lead + (1,), sp, dtype=f)]
    if twist is None:
        parts.append(R_inv.new_zeros(lead + (S_LEN - S_OM2,), dtype=f))
    else:
        parts.append(twist_scalars(twist))
    return torch.cat(parts, dim=-1)


def _sc(scal, i):
    """Scalar i of the block: a 0-d tensor, or [B, 1, 1] with a lane axis."""
    return scal[i] if scal.dim() == 1 else scal[..., i, None, None]


def _y_t(y_xyz, scal):
    """Raw slot coordinates moved by (R_inv, T_inv): 3 x [(B,) K, N]."""
    def R(i):
        return _sc(scal, S_RINV + i)

    return [y_xyz[..., 0, :, :] * R(3 * c) + y_xyz[..., 1, :, :] * R(3 * c + 1)
            + y_xyz[..., 2, :, :] * R(3 * c + 2) + _sc(scal, S_TINV + c) for c in range(3)]


def _kernel_a(x, yt, scal, chan, use_geometry: bool):
    """Gated kernel values A [K, N] from [1, N] x rows and 3 x [K, N]
    moved slots (pallas_ell._transform_and_a): ok = chan > 0, a = chan;
    under geometry a = a * kgeo and ok &= d2 < thres; then A = a where
    ok and a > sp, else 0. Dead slots carry DEAD_COORD coordinates, so the
    distance gate is false there and kgeo underflows to 0; without geometry
    the channel factor (built with the slots' validity folded in) is 0
    there."""
    variant(chan, use_geometry)
    ok, a = None, None
    if chan is not None:
        ok, a = chan > 0, chan
    if use_geometry:
        d2 = (x[X0] - yt[0]) ** 2 + (x[X1] - yt[1]) ** 2 + (x[X2] - yt[2]) ** 2
        kgeo = _sc(scal, S_SIGMA2) * torch.exp(d2 * x[NEGI2L2])
        gate = d2 < x[THRES]
        ok = gate if ok is None else ok & gate
        a = kgeo if a is None else a * kgeo
    return torch.where(ok & (a > _sc(scal, S_SP)), a, torch.zeros_like(a))


def _total(x, axes: int):
    """Sum over the last `axes` axes; with a lane axis, lane by lane, each
    as the unbatched full sum (one batched reduction may split its work
    over threads differently and round differently)."""
    if x.dim() == axes:
        return torch.sum(x)
    return torch.stack([torch.sum(v) for v in x])


def _rows(xp):
    return [xp[..., r:r + 1, :] for r in range(6)]         # [(B,) 1, N] rows


def flow_reduce_plain(xp, y_xyz, scal, c: float, d: float, chan=None,
                      use_geometry: bool = True):
    """Plain version of the flow kernel: (unit twist [6], joint_norm,
    nonzeros, a_sum, A [K, N]) as pallas_ell.flow_twist_ell_fused returns
    them with emit_a=True. With a lane axis (xp [B, 6, N], y_xyz [B, 3, K,
    N], scal [B, 32], chan [B, K, N]) every output takes it too."""
    yt = _y_t(y_xyz, scal)
    a = _kernel_a(_rows(xp), yt, scal, chan, use_geometry)
    s = torch.sum(a, dim=-2)
    wy = [torch.sum(a * yt[i], dim=-2) for i in range(3)]
    xr = [xp[..., i, :] for i in range(3)]
    om = [xr[(i + 1) % 3] * wy[(i + 2) % 3] - xr[(i + 2) % 3] * wy[(i + 1) % 3]
          for i in range(3)]
    v = [wy[i] - s * xr[i] for i in range(3)]
    t = torch.stack([_total(r, 1) for r in om + v], dim=-1)
    joint = torch.cat([t[..., :3] / c, t[..., 3:] / d], dim=-1)
    jn = torch.linalg.vector_norm(joint, dim=-1)
    unit = joint / torch.where(jn < 1e-30, torch.ones_like(jn), jn)[..., None]
    nz = torch.sum(a > 0, dim=(-2, -1)).to(torch.int32)
    return unit, jn, nz, _total(s, 1), a


def flow_rows_plain(xp, y_xyz, scal, chan=None, use_geometry: bool = True):
    """Plain version of the row-flow kernel (pallas_ell._flow_kernel): per
    point s [N] = sum_k A, wy [3, N] = sum_k A y_t and cnt [N] int32 of
    A > 0, then nonzeros (int32) and a_sum over the points."""
    yt = _y_t(y_xyz, scal)
    a = _kernel_a(_rows(xp), yt, scal, chan, use_geometry)
    s = torch.sum(a, dim=0)
    wy = torch.stack([torch.sum(a * yt[i], dim=0) for i in range(3)])
    cnt = torch.sum(a > 0, dim=0).to(torch.int32)
    return s, wy, cnt, torch.sum(cnt).to(torch.int32), torch.sum(s)


def step_cached_plain(xp, y_xyz, a, scal, twist=None) -> torch.Tensor:
    """Plain version of the step kernel: [4] = (B, C, D, E) from the cached
    kernel matrix `a` (pallas_ell._step_kernel_cached + _step_tail). Given
    the unit `twist` [6], the twist part of `scal` is `twist_scalars(twist)`
    and scal's own is ignored. With a lane axis (as flow_reduce_plain, twist
    [B, 6]): [B, 4]."""
    if twist is not None:
        scal = torch.cat([scal[..., :S_OM2], twist_scalars(twist)], dim=-1)
    x = _rows(xp)
    # zero y_t where A == 0: dead slots carry DEAD_COORD and beta^4 of a
    # 1e9-scale value is inf, which 0 * inf would turn into NaN
    y = [torch.where(a > 0, yc, torch.zeros_like(yc)) for yc in _y_t(y_xyz, scal)]

    def S(i):
        return _sc(scal, i)

    om = [S(S_OMEGA + i) for i in range(3)]
    om2 = S(S_OM2)
    t = y[0] * om[0] + y[1] * om[1] + y[2] * om[2]
    yy = y[0] * y[0] + y[1] * y[1] + y[2] * y[2]
    uu = om2 * yy - t * t                                    # |W y|^2

    def ydot(base):
        return y[0] * S(base) + y[1] * S(base + 1) + y[2] * S(base + 2)

    def xdot(base):
        return x[X0] * S(base) + x[X1] * S(base + 1) + x[X2] * S(base + 2)

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
    normxiz2 = uu - 2.0 * ywv + S(S_VV)
    vw = S(S_VOM) * t - om2 * yv                             # v . W^2 y
    xdx2 = yc2 - vw - S(S_VWV)
    epsc = -om2 * uu + 2.0 * om2 * ywv + S(S_WV2) + 2.0 * S(S_VC2)
    coef = x[COEF]
    beta = -2.0 * coef * d1
    gamma = -coef * (normxiz2 + 2.0 * d2)
    delta = 2.0 * coef * (xdx2 - d3)
    epsil = -coef * (epsc + 2.0 * d4)
    b2 = beta * beta
    return torch.stack([
        _total(a * beta, 2),
        _total(a * (gamma + 0.5 * b2), 2),
        _total(a * (delta + beta * gamma + b2 * beta / 6.0), 2),
        _total(a * (epsil + beta * delta + 0.5 * b2 * gamma
                    + 0.5 * gamma * gamma + b2 * b2 / 24.0), 2),
    ], dim=-1)


def step_uncached_plain(xp, y_xyz, scal, chan=None, use_geometry: bool = True):
    """Plain version of the uncached step kernel (pallas_ell._step_kernel,
    reduced): A recomputed as the flow pass computes it, then the step tail
    of `step_cached_plain`."""
    a = _kernel_a(_rows(xp), _y_t(y_xyz, scal), scal, chan, use_geometry)
    return step_cached_plain(xp, y_xyz, a, scal)


def _common_checks(xp, y_xyz, scal, chan, who, lanes: bool = False):
    """Device, K and N of a launch, after checking every input's dtype,
    shape ([B, ...] with B = y_xyz.shape[0] when `lanes`), device and
    layout."""
    if y_xyz.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {y_xyz.device}")
    dev = y_xyz.device
    lead = tuple(y_xyz.shape[:1]) if lanes else ()
    if y_xyz.dim() != len(lead) + 3:
        raise ValueError(f"{who}: y_xyz has shape {tuple(y_xyz.shape)}")
    K, N = y_xyz.shape[-2], y_xyz.shape[-1]
    cuda_lib.check_tensor(y_xyz, "y_xyz", torch.float32, lead + (3, K, N), dev, who)
    cuda_lib.check_tensor(xp, "xp", torch.float32, lead + (6, N), dev, who)
    cuda_lib.check_tensor(scal, "scal", torch.float32, lead + (S_LEN,), dev, who)
    if chan is not None:
        cuda_lib.check_tensor(chan, "chan", torch.float32, lead + (K, N), dev, who)
    return dev, K, N


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


# finish counters, one row per kernel, one column per lane, per device: row
# index in the counter tensor (the lane-axis launches use their kernel's row)
FLOW_REDUCE, STEP_CACHED, STEP_UNCACHED, FLOW_ROWS = range(4)
_counters = {}


def finish_counters(dev, lanes: int = 1) -> torch.Tensor:
    """The int32 [4, L] ticket counters of flow_reduce, step_cached,
    step_uncached and flow_rows on device `dev`, one per lane (L >= lanes),
    0 between launches. Allocated once per device and widened, all zero,
    when a launch has more lanes; the kernels assume one stream per device,
    as the port runs."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    t = _counters.get(dev)
    if t is None or t.shape[1] < lanes:
        t = _counters[dev] = torch.zeros((4, lanes), dtype=torch.int32, device=dev)
    return t


def _counter(dev, which, lanes: int = 1):
    t = finish_counters(dev, lanes)
    return t.data_ptr() + 4 * which * t.shape[1]


def _counted(fn, v=None):
    fn.launches += 1
    if v is not None:
        fn.variant_launches[v] += 1


def reset_launches():
    """Set every launch count of this module to 0."""
    for fn in (flow_reduce, step_cached, flow_rows, step_uncached, flow_reduce_lanes,
               step_cached_lanes):
        fn.launches = 0
    for fn in (flow_reduce, flow_rows, step_uncached, flow_reduce_lanes):
        fn.variant_launches = dict.fromkeys(VARIANTS, 0)


def flow_reduce(xp, y_xyz, scal, c: float, d: float, chan=None,
                use_geometry: bool = True):
    """Flow pass: (unit twist [6], joint_norm, nonzeros, a_sum, A [K, N]).
    The CUDA kernel on a CUDA tensor, the plain version on a CPU tensor."""
    v = variant(chan, use_geometry)
    if y_xyz.device.type == "cpu":
        return flow_reduce_plain(xp, y_xyz, scal, c, d, chan, use_geometry)
    dev, K, N = _common_checks(xp, y_xyz, scal, chan, "flow_reduce")
    lib = _lib()
    nb = lib.cvo_ell_blocks(N)
    A = torch.empty((K, N), dtype=torch.float32, device=dev)
    part = torch.empty((nb, 7), dtype=torch.float32, device=dev)
    part_cnt = torch.empty((nb,), dtype=torch.int32, device=dev)
    out = torch.empty((8,), dtype=torch.float32, device=dev)
    nz = torch.empty((1,), dtype=torch.int32, device=dev)
    err = lib.cvo_flow_reduce(
        xp.data_ptr(), y_xyz.data_ptr(), _ptr(chan), scal.data_ptr(), A.data_ptr(),
        part.data_ptr(), part_cnt.data_ptr(), _counter(dev, FLOW_REDUCE), out.data_ptr(),
        nz.data_ptr(), N, K, float(c), float(d), VARIANTS.index(v), _stream(dev))
    cuda_lib.check(err, "flow_reduce kernel launch")
    _counted(flow_reduce, v)
    return out[:6], out[6], nz[0], out[7], A


def step_cached(xp, y_xyz, a, scal, twist=None) -> torch.Tensor:
    """Step pass from the cached kernel matrix: [4] = (B, C, D, E). Channels
    entered through A, so none is taken here (as _step_kernel_cached).
    Given the flow's unit `twist` [6] on the same device, the twist part of
    the scalar block is built from it (on the card, by the kernel) and
    scal's own twist part is ignored. The CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if y_xyz.device.type == "cpu":
        return step_cached_plain(xp, y_xyz, a, scal, twist)
    dev, K, N = _common_checks(xp, y_xyz, scal, None, "step_cached")
    cuda_lib.check_tensor(a, "a", torch.float32, (K, N), dev, "step_cached")
    if twist is not None:
        cuda_lib.check_tensor(twist, "twist", torch.float32, (6,), dev, "step_cached")
    lib = _lib()
    part = torch.empty((lib.cvo_ell_blocks(N), 4), dtype=torch.float32, device=dev)
    out = torch.empty((4,), dtype=torch.float32, device=dev)
    err = lib.cvo_step_cached(
        xp.data_ptr(), y_xyz.data_ptr(), a.data_ptr(), scal.data_ptr(), _ptr(twist),
        part.data_ptr(), _counter(dev, STEP_CACHED), out.data_ptr(), N, K, _stream(dev))
    cuda_lib.check(err, "step_cached kernel launch")
    _counted(step_cached)
    return out


def flow_reduce_lanes(xp, y_xyz, scal, c: float, d: float, chan=None,
                      use_geometry: bool = True):
    """Flow pass with a lane axis: xp [B, 6, N], y_xyz [B, 3, K, N], scal
    [B, 32], chan [B, K, N] -> (unit twist [B, 6], joint_norm [B],
    nonzeros [B], a_sum [B], A [B, K, N]), each lane as flow_reduce on its
    inputs. The CUDA kernel (one launch for all lanes) on a CUDA tensor, the
    plain version on a CPU tensor."""
    v = variant(chan, use_geometry)
    if y_xyz.device.type == "cpu":
        return flow_reduce_plain(xp, y_xyz, scal, c, d, chan, use_geometry)
    dev, K, N = _common_checks(xp, y_xyz, scal, chan, "flow_reduce_lanes", lanes=True)
    B = y_xyz.shape[0]
    lib = _lib()
    nb = lib.cvo_ell_blocks(N)
    A = torch.empty((B, K, N), dtype=torch.float32, device=dev)
    part = torch.empty((B, nb, 7), dtype=torch.float32, device=dev)
    part_cnt = torch.empty((B, nb), dtype=torch.int32, device=dev)
    out = torch.empty((B, 8), dtype=torch.float32, device=dev)
    nz = torch.empty((B,), dtype=torch.int32, device=dev)
    err = lib.cvo_flow_reduce_lanes(
        xp.data_ptr(), y_xyz.data_ptr(), _ptr(chan), scal.data_ptr(), A.data_ptr(),
        part.data_ptr(), part_cnt.data_ptr(), _counter(dev, FLOW_REDUCE, B), out.data_ptr(),
        nz.data_ptr(), N, K, float(c), float(d), VARIANTS.index(v), B, _stream(dev))
    cuda_lib.check(err, "flow_reduce_lanes kernel launch")
    _counted(flow_reduce_lanes, v)
    return out[:, :6], out[:, 6], nz, out[:, 7], A


def step_cached_lanes(xp, y_xyz, a, scal, twist=None) -> torch.Tensor:
    """Step pass from the cached kernel matrices with a lane axis: a [B, K,
    N], twist [B, 6] (or None), the rest as flow_reduce_lanes -> [B, 4],
    each lane as step_cached on its inputs. The CUDA kernel (one launch for
    all lanes) on a CUDA tensor, the plain version on a CPU tensor."""
    if y_xyz.device.type == "cpu":
        return step_cached_plain(xp, y_xyz, a, scal, twist)
    dev, K, N = _common_checks(xp, y_xyz, scal, None, "step_cached_lanes", lanes=True)
    B = y_xyz.shape[0]
    cuda_lib.check_tensor(a, "a", torch.float32, (B, K, N), dev, "step_cached_lanes")
    ld = 6
    if twist is not None:
        # rows of the flow's [B, 8] output are taken as they lie (stride 8)
        if twist.dtype != torch.float32 or twist.device != dev or tuple(twist.shape) != (B, 6) \
                or twist.stride(-1) != 1:
            raise ValueError(f"step_cached_lanes: twist must be a float32 [{B}, 6] tensor on "
                             f"{dev} with unit stride along its rows; got {twist.dtype} "
                             f"{tuple(twist.shape)} on {twist.device}, strides {twist.stride()}")
        ld = twist.stride(0)
    lib = _lib()
    part = torch.empty((B, lib.cvo_ell_blocks(N), 4), dtype=torch.float32, device=dev)
    out = torch.empty((B, 4), dtype=torch.float32, device=dev)
    err = lib.cvo_step_cached_lanes(
        xp.data_ptr(), y_xyz.data_ptr(), a.data_ptr(), scal.data_ptr(), _ptr(twist), ld,
        part.data_ptr(), _counter(dev, STEP_CACHED, B), out.data_ptr(), N, K, B, _stream(dev))
    cuda_lib.check(err, "step_cached_lanes kernel launch")
    _counted(step_cached_lanes)
    return out


def flow_rows(xp, y_xyz, scal, chan=None, use_geometry: bool = True):
    """Row-flow pass: (s [N], wy [3, N], cnt [N] int32, nonzeros, a_sum).
    The CUDA kernel on a CUDA tensor, the plain version on a CPU tensor."""
    v = variant(chan, use_geometry)
    if y_xyz.device.type == "cpu":
        return flow_rows_plain(xp, y_xyz, scal, chan, use_geometry)
    dev, K, N = _common_checks(xp, y_xyz, scal, chan, "flow_rows")
    lib = _lib()
    nb = lib.cvo_ell_blocks(N)
    s = torch.empty((N,), dtype=torch.float32, device=dev)
    wy = torch.empty((3, N), dtype=torch.float32, device=dev)
    cnt = torch.empty((N,), dtype=torch.int32, device=dev)
    part = torch.empty((nb,), dtype=torch.float32, device=dev)
    part_cnt = torch.empty((nb,), dtype=torch.int32, device=dev)
    asum = torch.empty((1,), dtype=torch.float32, device=dev)
    nz = torch.empty((1,), dtype=torch.int32, device=dev)
    err = lib.cvo_flow_rows(
        xp.data_ptr(), y_xyz.data_ptr(), _ptr(chan), scal.data_ptr(), s.data_ptr(),
        wy.data_ptr(), cnt.data_ptr(), part.data_ptr(), part_cnt.data_ptr(),
        _counter(dev, FLOW_ROWS), asum.data_ptr(), nz.data_ptr(), N, K,
        VARIANTS.index(v), _stream(dev))
    cuda_lib.check(err, "flow_rows kernel launch")
    _counted(flow_rows, v)
    return s, wy, cnt, nz[0], asum[0]


def step_uncached(xp, y_xyz, scal, chan=None, use_geometry: bool = True) -> torch.Tensor:
    """Uncached step pass: A recomputed, then [4] = (B, C, D, E).
    The CUDA kernel on a CUDA tensor, the plain version on a CPU tensor."""
    v = variant(chan, use_geometry)
    if y_xyz.device.type == "cpu":
        return step_uncached_plain(xp, y_xyz, scal, chan, use_geometry)
    dev, K, N = _common_checks(xp, y_xyz, scal, chan, "step_uncached")
    lib = _lib()
    part = torch.empty((lib.cvo_ell_blocks(N), 4), dtype=torch.float32, device=dev)
    out = torch.empty((4,), dtype=torch.float32, device=dev)
    err = lib.cvo_step_uncached(
        xp.data_ptr(), y_xyz.data_ptr(), _ptr(chan), scal.data_ptr(), part.data_ptr(),
        _counter(dev, STEP_UNCACHED), out.data_ptr(), N, K, VARIANTS.index(v), _stream(dev))
    cuda_lib.check(err, "step_uncached kernel launch")
    _counted(step_uncached, v)
    return out


reset_launches()


def flow_stats_ell_fused(params, ell, x: PointCloud, nl, R_inv, T_inv) -> FlowStats:
    """pallas_ell.flow_stats_ell_fused's entry point: the row-flow pass on a
    neighbor list, as FlowStats (row_wy [N, 3])."""
    s, wy, _, nz, asum = flow_rows(pack_x(params, ell, x), nl.y_xyz,
                                   pack_scalars(params, R_inv, T_inv), nl.chan,
                                   bool(params.is_using_geometry))
    return FlowStats(row_sum=s, row_wy=wy.T, nonzeros=nz, a_sum=asum)


def step_coeffs_ell_fused(params, ell, x: PointCloud, nl, R_inv, T_inv, twist):
    """pallas_ell.step_coeffs_ell_fused's entry point: the uncached step
    pass on a neighbor list, as (B, C, D, E)."""
    bcde = step_uncached(pack_x(params, ell, x), nl.y_xyz,
                         pack_scalars(params, R_inv, T_inv, twist), nl.chan,
                         bool(params.is_using_geometry))
    return bcde[0], bcde[1], bcde[2], bcde[3]


_measurement_build = None

# csrc/ell.cu's design switches, in cvo_ell_design's order
DESIGN_KEYS = ("ELL_UNROLL", "ELL_FUSED_SUM")


def use_build(lib=None) -> None:
    """Route the CUDA passes through `lib`, a measurement build from
    cuda_lib.load_variant("ell", ...), or back to the package's build."""
    global _measurement_build
    _measurement_build = lib


def library_design() -> dict:
    """The loaded build's design switches."""
    out = (ctypes.c_int * len(DESIGN_KEYS))()
    _lib().cvo_ell_design(out)
    return dict(zip(DESIGN_KEYS, out))


def _lib():
    return bind(_measurement_build or cuda_lib.load("ell"))


def bind(lib):
    """Declare the C interface of a build of csrc/ell.cu."""
    if not getattr(lib, "_argtypes_set", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.cvo_ell_blocks.argtypes = [I]
        lib.cvo_ell_blocks.restype = I
        lib.cvo_ell_design.argtypes = [P]
        lib.cvo_ell_design.restype = None
        lib.cvo_flow_reduce.argtypes = [P, P, P, P, P, P, P, P, P, P, I, I, F, F, I, P]
        lib.cvo_flow_reduce.restype = I
        lib.cvo_step_cached.argtypes = [P, P, P, P, P, P, P, P, I, I, P]
        lib.cvo_step_cached.restype = I
        lib.cvo_flow_rows.argtypes = [P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, P]
        lib.cvo_flow_rows.restype = I
        lib.cvo_step_uncached.argtypes = [P, P, P, P, P, P, P, I, I, I, P]
        lib.cvo_step_uncached.restype = I
        lib.cvo_flow_reduce_lanes.argtypes = [P, P, P, P, P, P, P, P, P, P, I, I, F, F, I, I, P]
        lib.cvo_flow_reduce_lanes.restype = I
        lib.cvo_step_cached_lanes.argtypes = [P, P, P, P, P, I, P, P, P, I, I, I, P]
        lib.cvo_step_cached_lanes.restype = I
        lib._argtypes_set = True
    return lib
