"""The PyTorch port's grid neighbor-list builder (ops/neighbors.py with the
plain version of the select kernel) against the JAX package's
build_neighbor_list, with both its sort path and its Pallas select kernel
(run in interpret mode, as tests/test_neighbors.py runs it).

Lists compare as per-row SETS (tie order may differ, pallas_select.py:16-20):
the per-row index sets, the valid count per row, the raw coordinates at
matched indices (exactly) and the overflow count (exactly).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unified_cvo_tpu.config import CvoParams as JaxParams
from unified_cvo_tpu.ops import lie as j_lie
from unified_cvo_tpu.ops import neighbors as j_nbr
from unified_cvo_tpu.utils.pointcloud import make_pointcloud as j_make
from unified_cvo_tpu_torch import convert
from unified_cvo_tpu_torch.ops import neighbors as t_nbr
from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud as t_make

torch.set_num_threads(1)


def _scene(rng, n=512, spread=12.0):
    return np.stack([rng.uniform(-spread, spread, n), rng.uniform(-2, 2, n),
                     rng.uniform(2, 50, n)], axis=1).astype(np.float32)


def _params(**kw):
    base = dict(ell_init=0.4, ell_min=0.05, ell_decay_rate=0.9,
                ell_decay_start=5, indicator_window_size=5,
                indicator_stable_threshold=0.2, max_step=0.1,
                sp_thres=0.0006, is_using_geometry=1)
    base.update(kw)
    jp = JaxParams(**base)
    return jp, convert.params_from_fields(dataclasses.asdict(jp))


def _pose():
    xi = np.array([0.004, -0.006, 0.003, 0.02, -0.01, 0.03], np.float32)
    R, t = j_lie.se3_exp(jnp.asarray(xi), 1.0)
    return np.array(R), np.array(t)


def _both_lists(xyz, xyz2, bucket, select, k=32, skin=0.3, per_cell_cap=8,
                pose=None):
    jp, tp = _params()
    R, T = _pose() if pose is None else pose
    ell = jp.ell_init
    nl_j = j_nbr.build_neighbor_list(
        jp, jnp.float32(ell), j_make(xyz, bucket=bucket), j_make(xyz2, bucket=bucket),
        jnp.asarray(R), jnp.asarray(T), k=k, skin=skin, per_cell_cap=per_cell_cap,
        select=select)
    nl_t = t_nbr.build_neighbor_list(
        tp, torch.tensor(ell), t_make(xyz, bucket=bucket, device="cpu"),
        t_make(xyz2, bucket=bucket, device="cpu"), torch.from_numpy(R),
        torch.from_numpy(T), k=k, skin=skin, per_cell_cap=per_cell_cap)
    return nl_j, nl_t


def _assert_same_list(nl_j, nl_t):
    idx_j, idx_t = np.asarray(nl_j.idx), nl_t.idx.numpy()
    y_j, y_t = np.asarray(nl_j.y_xyz), nl_t.y_xyz.numpy()
    assert idx_t.dtype == np.int32 and idx_t.shape == idx_j.shape
    np.testing.assert_array_equal(nl_t.valid.numpy(), idx_t >= 0)
    np.testing.assert_array_equal((idx_t >= 0).sum(0), (idx_j >= 0).sum(0))
    # per-row sets, with the raw coordinates carried along
    oj, ot = np.argsort(idx_j, axis=0), np.argsort(idx_t, axis=0)
    np.testing.assert_array_equal(np.take_along_axis(idx_t, ot, 0),
                                  np.take_along_axis(idx_j, oj, 0))
    for c in range(3):
        np.testing.assert_array_equal(np.take_along_axis(y_t[c], ot, 0),
                                      np.take_along_axis(y_j[c], oj, 0))
    assert int(nl_t.overflow) == int(nl_j.overflow)
    np.testing.assert_array_equal(nl_t.y_t_build.numpy(), np.asarray(nl_j.y_t_build))
    np.testing.assert_allclose(nl_t.pose_build.numpy(), np.asarray(nl_j.pose_build))
    np.testing.assert_allclose(float(nl_t.r_max_t), float(nl_j.r_max_t), rtol=1e-6)
    np.testing.assert_allclose(float(nl_t.k_lin), float(nl_j.k_lin), rtol=1e-6)


@pytest.mark.parametrize("per_cell_cap", [8, 24])
@pytest.mark.parametrize("select", ["sort", "kernel_interpret"])
def test_grid_builder_matches_jax(select, per_cell_cap):
    rng = np.random.default_rng(0)
    xyz = _scene(rng)
    xyz2 = _scene(rng) + np.float32([0.15, 0.0, 0.1])
    nl_j, nl_t = _both_lists(xyz, xyz2, 512, select, per_cell_cap=per_cell_cap)
    assert int((np.asarray(nl_j.idx) >= 0).sum()) > 0
    _assert_same_list(nl_j, nl_t)


@pytest.mark.parametrize("select", ["sort", "kernel_interpret"])
def test_grid_builder_dead_slots_match_jax(select):
    """400 points in a 512 bucket: masked source rows and padded targets
    leave dead slots (-1 / DEAD_COORD) on both sides."""
    rng = np.random.default_rng(1)
    xyz = _scene(rng, n=400)
    R, t = _pose()
    xyz2 = (xyz @ R.T + t).astype(np.float32)
    Rinv, Tinv = j_lie.invert_rt(jnp.asarray(R), jnp.asarray(t))
    nl_j, nl_t = _both_lists(xyz, xyz2, 512, select, per_cell_cap=24,
                             pose=(np.array(Rinv), np.array(Tinv)))
    _assert_same_list(nl_j, nl_t)
    dead = nl_t.idx.numpy() < 0
    assert dead[:, 400:].all()
    assert (nl_t.y_xyz.numpy()[:, dead] == t_nbr.DEAD_COORD).all()


def test_grid_builder_overflow_matches_jax():
    """A dense cloud saturates both the per-cell cap and K: the overflow
    count (dropped candidates) must agree exactly."""
    rng = np.random.default_rng(2)
    xyz = rng.uniform(-0.5, 0.5, (512, 3)).astype(np.float32)
    xyz[:, 2] += 5.0
    nl_j, nl_t = _both_lists(xyz, xyz + np.float32([0.02, 0, 0]), 512, "sort",
                             k=32, per_cell_cap=4, pose=(np.eye(3, dtype=np.float32),
                                                         np.zeros(3, np.float32)))
    assert int(nl_j.overflow) > 0
    _assert_same_list(nl_j, nl_t)


@pytest.mark.parametrize("multiple", [128, 384, 512])
def test_pad_cloud_to_multiple_matches_jax(multiple):
    from unified_cvo_tpu.ops import kernels as j_k
    from unified_cvo_tpu_torch.ops import kernels as t_k

    xyz = _scene(np.random.default_rng(6), n=300)
    feats = np.random.default_rng(7).uniform(0, 1, (300, 3)).astype(np.float32)
    j_pc = j_k.pad_cloud_to_multiple(j_make(xyz, features=feats, bucket=100), multiple)
    t_pc = t_k.pad_cloud_to_multiple(
        t_make(xyz, features=feats, bucket=100, device="cpu"), multiple)
    assert t_pc.capacity == j_pc.capacity and t_pc.capacity % multiple == 0
    for name in ("xyz", "mask", "features", "geometric_types"):
        np.testing.assert_array_equal(getattr(t_pc, name).numpy(),
                                      np.asarray(getattr(j_pc, name)))
    assert t_pc.labels is None and j_pc.labels is None


@pytest.mark.parametrize("scale", [0.0, 1e-3, 1e-2, 5e-2])
def test_drift_bound_matches_jax(scale):
    rng = np.random.default_rng(3)
    xyz = _scene(rng)
    nl_j, nl_t = _both_lists(xyz, xyz, 512, "sort")
    R, T = _pose()
    xi = scale * np.array([0.5, -1.0, 0.3, 4.0, 2.0, -3.0], np.float32)
    dR, dT = j_lie.se3_exp(jnp.asarray(xi), 1.0)
    R2 = np.array(dR) @ R
    T2 = np.array(dR) @ T + np.array(dT)
    got = bool(t_nbr.drift_bound_exceeded(nl_t, torch.from_numpy(R2),
                                          torch.from_numpy(T2), 0.3))
    want = bool(j_nbr.drift_bound_exceeded(nl_j, jnp.asarray(R2), jnp.asarray(T2), 0.3))
    assert got == want
    assert got == (scale >= 1e-2)


def test_plain_consume_passes_match_jax():
    """kernel_slots / flow_stats_ell / step_coeffs_ell (the JAX package's
    jnp consume twins) on one list carried across with convert.py."""
    from unified_cvo_tpu.ops import kernels as j_k
    from unified_cvo_tpu_torch.ops import kernels as t_k

    rng = np.random.default_rng(4)
    jp, tp = _params()
    xyz = _scene(rng, n=400)
    R, t = _pose()
    xyz2 = (xyz @ R.T + t + 0.05).astype(np.float32)
    src = j_make(xyz, bucket=512)
    Rinv, Tinv = j_lie.invert_rt(jnp.asarray(R), jnp.asarray(t))
    ell = jnp.float32(jp.ell_init)
    nl = j_nbr.build_neighbor_list(jp, ell, src, j_make(xyz2, bucket=512), Rinv,
                                   Tinv, k=32, skin=0.3, per_cell_cap=24)
    nl_t = convert.neighbor_list_from_numpy(
        **{f: np.asarray(getattr(nl, f)) for f in (
            "idx", "valid", "y_xyz", "y_t_build", "overflow", "pose_build",
            "r_max_t", "ell_build", "k_lin")}, device="cpu")
    src_t = convert.pointcloud_from_numpy(np.asarray(src.xyz), np.asarray(src.mask),
                                          device="cpu")
    tR, tT = torch.from_numpy(np.array(Rinv)), torch.from_numpy(np.array(Tinv))
    st_t, a_t, yts_t = t_nbr.flow_stats_ell(tp, torch.tensor(jp.ell_init), src_t, nl_t, tR, tT)
    st_j, a_j, yts_j = j_nbr.flow_stats_ell(jp, ell, src, nl, Rinv, Tinv)
    assert int(st_t.nonzeros) == int(st_j.nonzeros) > 0
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(st_t.a_sum), float(st_j.a_sum), rtol=1e-5)
    tw_t, jn_t = t_k.flow_from_stats(tp, src_t, st_t)
    tw_j, jn_j = j_k.flow_from_stats(jp, src, st_j)
    np.testing.assert_allclose(float(jn_t), float(jn_j), rtol=1e-4)
    np.testing.assert_allclose(tw_t.numpy(), np.asarray(tw_j), atol=1e-4)
    got = t_nbr.step_coeffs_ell(tp, torch.tensor(jp.ell_init), src_t, a_t, yts_t, tw_t)
    want = j_nbr.step_coeffs_ell(jp, ell, src, a_j, yts_j, tw_j)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-3, atol=1e-4)


# ---- the select contract: select_plain against a numpy brute force (slot
# order exact) and against JAX's pool_select kernel in interpret mode
# (per-row sets, kept total exact), on inputs made by the port's
# grid_inputs

def _select_case(name):
    """(tab, cbase, xr2, pose, k, p, grid_dims) as torch CPU tensors for one
    contract case; 256 source rows (a block of pool_select). The `irls_`
    cases are at the IRLS list's shape, K = 128 and P = 32 (pool 864): kept
    well over K on a full pool, kept just over K with an exact d2 tie across
    slot K, kept under K, masked rows (chip_smoke.py's `select_irls_case`
    rebuilds them on the card)."""
    rng = np.random.default_rng(11)
    jp, tp = _params()
    k, p, dims, skin = 32, 8, (16, 8, 16), 0.3
    eye = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    R, T = _pose()
    r2 = None
    if name.startswith("irls_"):
        k, p = 128, 32
    if name == "irls_kept_over_k":
        # 20000 targets in a 3 m cube: every pool cell full, r2 4 m^2 keeps
        # 139-727 of the 864 candidates a row; two far targets on the z axis
        # keep the sources off the grid's z faces, where JAX's z-dilated pool
        # takes the cells one further in (a radius past the cell size finds
        # them)
        xyz = rng.uniform(-1.5, 1.5, (256, 3)).astype(np.float32) + np.float32([0, 0, 6])
        xyz2 = np.concatenate([
            rng.uniform(-1.5, 1.5, (20000, 3)).astype(np.float32) + np.float32([0, 0, 6]),
            np.float32([[0, 0, -4], [0, 0, 16]])])
        r2 = 4.0
    elif name == "irls_binding_tie":
        # a 6^3 integer lattice, every target 5 times: d2 0, 1, 2 and 3
        # exactly, up to 135 kept (129-134 where the table's cap drops none
        # of them), slot K inside the 40 entries at d2 = 3
        g = np.stack(np.meshgrid(*[np.arange(6.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
        xyz = (g + np.float32([0, 0, 5])).astype(np.float32)
        xyz2 = np.concatenate([xyz] * 5)
        (R, T), r2 = eye, 3.1
    elif name in ("irls_kept_under_k", "irls_masked_rows"):
        xyz = rng.uniform(-2.5, 2.5, (256, 3)).astype(np.float32) + np.float32([0, 0, 6])
        xyz2 = xyz + rng.normal(scale=0.05, size=xyz.shape).astype(np.float32)
        if name == "irls_masked_rows":
            xyz = xyz[:200]
    elif name == "equidistant":
        # integer lattice, every target twice: d2 of 0 and 1 exactly, ties
        # between duplicates and between the six lattice neighbours
        g = np.stack(np.meshgrid(*[np.arange(5.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
        xyz = (g + np.float32([0, 0, 5])).astype(np.float32)
        xyz2 = np.concatenate([xyz, xyz])
        (R, T), r2 = eye, 1.1 ** 2
    elif name in ("equidistant_binding", "kept_over_k", "per_cell_cap_24"):
        xyz = rng.uniform(-1.5, 1.5, (256, 3)).astype(np.float32) + np.float32([0, 0, 6])
        xyz2 = xyz + rng.normal(scale=0.05, size=xyz.shape).astype(np.float32)
        if name == "equidistant_binding":
            xyz = np.round(xyz).astype(np.float32)
            xyz2 = np.concatenate([xyz, xyz, xyz])
            (R, T), r2, k = eye, 1.1 ** 2, 8
        elif name == "kept_over_k":
            k = 8
        else:
            p = 24
    elif name == "kept_zero":
        # half the sources 25 m from every target: their pools are empty
        xyz = _scene(rng, 256)
        xyz[::2, 2] = 45.0 + rng.uniform(0, 5, 128).astype(np.float32)
        xyz2 = _scene(rng, 256)
        xyz2[:, 2] = np.clip(xyz2[:, 2], 2, 20)
    elif name.startswith("irls_"):
        raise ValueError(name)
    elif name in ("masked_rows", "nine_cell_pool"):
        xyz = rng.uniform(-2.5, 2.5, (256, 3)).astype(np.float32) + np.float32([0, 0, 6])
        xyz2 = xyz + rng.normal(scale=0.05, size=xyz.shape).astype(np.float32)
        if name == "masked_rows":
            xyz = xyz[:200]
        else:
            dims = (16, 1, 16)
    else:
        raise ValueError(name)
    g = t_nbr.grid_inputs(tp, torch.tensor(jp.ell_init), t_make(xyz, bucket=256, device="cpu"),
                          t_make(xyz2, bucket=max(256, len(xyz2)), device="cpu"),
                          torch.from_numpy(np.asarray(R, np.float32)),
                          torch.from_numpy(np.asarray(T, np.float32)), skin=skin,
                          per_cell_cap=p, grid_dims=dims)
    xr2 = g.xr2.clone()
    if r2 is not None:
        xr2[:, 3] = torch.where(xr2[:, 3] >= 0, torch.tensor(r2, dtype=torch.float32), -1.0)
    return g.tab, g.cbase, xr2, g.pose, k, p, dims


def _brute_select(tab, cbase, xr2, pose, k, p, dims):
    """Row by row in numpy float32 with the plain version's operation
    order: every candidate of the pool (cells in dx, dy, dz order, P slots
    each), kept when its index >= 0 and d2 <= r2, ordered by (d2, pool
    position), first k."""
    tab, cbase, xr2, pose = (t.numpy() for t in (tab, cbase, xr2, pose))
    N = cbase.shape[0]
    offs = np.array([(dx, dy, dz) for dx in ((-1, 0, 1) if dims[0] > 1 else (0,))
                     for dy in ((-1, 0, 1) if dims[1] > 1 else (0,))
                     for dz in ((-1, 0, 1) if dims[2] > 1 else (0,))])
    idx = np.full((k, N), -1, np.int32)
    y = np.full((3, k, N), t_nbr.DEAD_COORD, np.float32)
    kept = np.zeros(N, np.int32)
    for n in range(N):
        c = cbase[n] + offs
        inside = np.all((c >= 0) & (c < np.array(dims)), axis=1)
        cell = np.where(inside, (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2],
                        dims[0] * dims[1] * dims[2])
        rows = tab[cell]                                     # [n_off, 4p]
        comp = [rows[:, j * p:(j + 1) * p].reshape(-1) for j in range(4)]
        t = [comp[0] * pose[3 * j] + comp[1] * pose[3 * j + 1] + comp[2] * pose[3 * j + 2]
             + pose[9 + j] for j in range(3)]
        d2 = (xr2[n, 0] - t[0]) ** 2 + (xr2[n, 1] - t[1]) ** 2 + (xr2[n, 2] - t[2]) ** 2
        pos = np.nonzero((comp[3] >= 0) & (d2 <= xr2[n, 3]))[0]
        kept[n] = len(pos)
        pos = pos[np.lexsort((pos, d2[pos]))][:k]
        idx[:len(pos), n] = comp[3][pos].astype(np.int32)
        for j in range(3):
            y[j, :len(pos), n] = comp[j][pos]
    return idx, y, kept


SELECT_CASES = ["equidistant", "equidistant_binding", "kept_over_k", "kept_zero",
                "masked_rows", "nine_cell_pool", "per_cell_cap_24", "irls_kept_over_k",
                "irls_binding_tie", "irls_kept_under_k", "irls_masked_rows"]
# ties straddling slot K: JAX's kernel may pick other members of the tie
# (pallas_select.py:16-20)
TIE_CASES = ("equidistant_binding", "irls_binding_tie")


def _slot_d2(xr2, pose, y):
    """[K, N] float64 d2 of each slot's raw target, moved by the pose, from
    its row's source point (inf on dead slots)."""
    x, P, yv = xr2.numpy().astype(np.float64), pose.numpy().astype(np.float64), np.asarray(y)
    yv = yv.astype(np.float64)
    t = [yv[0] * P[3 * j] + yv[1] * P[3 * j + 1] + yv[2] * P[3 * j + 2] + P[9 + j]
         for j in range(3)]
    d2 = sum((x[None, :, j] - t[j]) ** 2 for j in range(3))
    return np.where(yv[0] < t_nbr.DEAD_COORD, d2, np.inf)


@pytest.mark.parametrize("name", SELECT_CASES)
def test_select_plain_matches_brute_force_order(name):
    from unified_cvo_tpu_torch.ops import select as t_sel

    args = _select_case(name)
    idx, y, kept = t_sel.select_plain(*args)
    idx_b, y_b, kept_b = _brute_select(*args)
    np.testing.assert_array_equal(kept.numpy(), kept_b)
    np.testing.assert_array_equal(idx.numpy(), idx_b)
    np.testing.assert_array_equal(y.numpy(), y_b)
    k = args[4]
    kept_b = kept_b[args[2].numpy()[:, 3] >= 0]
    if name == "equidistant_binding":
        assert (kept_b > k).any()
    if name == "kept_zero":
        assert (kept_b == 0).sum() >= 100 and (kept_b > 0).any()
    if name == "masked_rows":
        assert (kept.numpy()[200:] == 0).all() and (idx.numpy()[:, 200:] == -1).all()
    if name == "kept_over_k":
        assert (kept_b > k).sum() > 100
    if name == "irls_kept_over_k":
        assert (kept_b > k).all() and kept_b.max() > 600
    if name == "irls_binding_tie":
        # rows just over K whose slot K lies inside a tie of exact d2 = 3
        over = np.nonzero((args[2].numpy()[:, 3] >= 0) & (kept.numpy() > k))[0]
        d2 = _slot_d2(args[2], args[3], y_b)
        assert len(over) > 10 and kept.numpy()[over].max() <= k + 7
        assert (d2[k - 1, over] == 3.0).all() and (d2[k - 41, over] == 2.0).all()
    if name == "irls_kept_under_k":
        assert (kept_b <= k).all() and kept_b.max() > 10
    if name == "irls_masked_rows":
        assert (kept.numpy()[200:] == 0).all() and (idx.numpy()[:, 200:] == -1).all()


@pytest.mark.parametrize("name", [c for c in SELECT_CASES if c != "equidistant_binding"])
def test_select_plain_matches_pallas_select(name):
    """JAX's pool_select (interpret mode) fed the pool JAX's grid builder
    gathers from the same table (z-dilated rows, pallas_select.py:124):
    per-row sets equal with their raw coordinates, kept total exact. Ties
    straddling slot K may pick different members (pallas_select.py:16-20):
    on irls_binding_tie each row's slot d2s are equal as a sorted list and
    the slots below the row's largest d2 as a set; equidistant_binding is
    held against the brute force only, as before."""
    from unified_cvo_tpu.ops import pallas_select
    from unified_cvo_tpu_torch.ops import select as t_sel

    tab, cbase, xr2, pose, k, p, dims = _select_case(name)
    idx, y, kept = t_sel.select_plain(tab, cbase, xr2, pose, k, p, dims)
    gx, gy, gz = dims
    n_cells = gx * gy * gz
    tab_np, cb = tab.numpy(), cbase.numpy()
    tabz = np.concatenate([np.roll(tab_np, 1, 0), tab_np, np.roll(tab_np, -1, 0)], axis=1)
    tabz[n_cells] = -1.0
    offs2 = np.array([(dx, dy) for dx in ((-1, 0, 1) if gx > 1 else (0,))
                      for dy in ((-1, 0, 1) if gy > 1 else (0,))])
    cxy = cb[:, None, :2] + offs2[None]
    in_grid = np.all((cxy >= 0) & (cxy < np.array([gx, gy])), axis=-1)
    cid = (cxy[..., 0] * gy + cxy[..., 1]) * gz + np.clip(cb[:, 2], 1, gz - 2)[:, None]
    cid = np.where(in_grid, cid, n_cells)
    N = cb.shape[0]
    pool = tabz[cid.reshape(-1)].reshape(N, len(offs2) * 12 * p)
    pose_np = pose.numpy()
    _, co, y0, y1, y2, kept_j = pallas_select.pool_select(
        jnp.asarray(pool), jnp.asarray(xr2.numpy()), jnp.asarray(pose_np[:9].reshape(3, 3)),
        jnp.asarray(pose_np[9:]), k=k, n_win=len(offs2), p=p, blk=N, interpret=True)
    assert int(kept_j) == int(kept.sum())
    idx_j = np.asarray(co).T.astype(np.int32)                # [K, N]
    y_j = np.stack([np.asarray(v).T for v in (y0, y1, y2)])
    idx_t, y_t = idx.numpy(), y.numpy()
    if name in TIE_CASES:
        d2_t, d2_j = _slot_d2(xr2, pose, y_t), _slot_d2(xr2, pose, y_j)
        np.testing.assert_array_equal(np.sort(d2_t, axis=0), np.sort(d2_j, axis=0))
        top = np.max(np.where(np.isfinite(d2_t), d2_t, -1.0), axis=0)
        for n in range(N):
            below_t, below_j = d2_t[:, n] < top[n], d2_j[:, n] < top[n]
            assert sorted(idx_t[below_t, n]) == sorted(idx_j[below_j, n]), n
        assert (top == 3.0).sum() > 10
        return
    oj, ot = np.argsort(idx_j, axis=0), np.argsort(idx_t, axis=0)
    np.testing.assert_array_equal(np.take_along_axis(idx_t, ot, 0),
                                  np.take_along_axis(idx_j, oj, 0))
    for c in range(3):
        np.testing.assert_array_equal(np.take_along_axis(y_t[c], ot, 0),
                                      np.take_along_axis(y_j[c], oj, 0))
