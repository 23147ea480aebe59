"""The lidar frontend's port (unified_cvo_tpu_torch/frontend/lidar.py and the
plain versions of its two hand kernels, ops/lidar.py) against the JAX
package's frontend/lidar.py on the CPU.

- LOAM half (rings, edges, curvature, surfaces, the cloud with and without
  semantics, with the capacity cap): bit for bit, on test_lidar.py's
  synthetic scan and on a rendered 32-beam scan with 5 mm noise.
- LeGO-LOAM half on test_lidar.py's lego scan and on the rendered scan:
  the port bins and links in float64 where JAX uses float32 (the card and
  the CPU then agree), so its filled cells, ground and segmented cells may
  differ from JAX's in at most CELL_SHARE of the filled cells, and its edge
  and surface indices overlap JAX's with Jaccard >= OVERLAP. Fed JAX's own
  range image and segmentation, the feature loop (L2's plain version) and
  the surface draw give JAX's indices exactly.
- L1's plain version gives scipy's partition (labels canonicalised to the
  smallest cell of each component) on random link sets.
- The numpy stream splitting the surface draw relies on: one draw of the
  total equals the per-sector draws in order.
- On CPU tensors the wrappers run their plain versions and count no launch.
"""

import numpy as np
import pytest
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from test_lidar import lego_synthetic_scan, synthetic_scan
from unified_cvo_tpu.frontend import lidar as J
from unified_cvo_tpu.utils.pointcloud import to_numpy_valid as j_valid
from unified_cvo_tpu_torch.frontend import lidar as T
from unified_cvo_tpu_torch.ops import cuda_lib
from unified_cvo_tpu_torch.ops import lidar as L
from unified_cvo_tpu_torch.utils import synth
from unified_cvo_tpu_torch.utils.pointcloud import to_numpy_valid as t_valid

torch.set_num_threads(1)

CELL_SHARE = 1e-4    # filled cells whose float64 bins or links differ from JAX's float32 ones
OVERLAP = 0.99       # Jaccard overlap of LeGO-LOAM's edge and surface indices with JAX's


HDL64_FOV = (-2.0, 24.9)   # the elevations LeGO-LOAM's range image assumes


def rendered_scan(n_beams=32, n_az=720, seed=0, fov_deg=(-20.0, 8.0)):
    """test_e2e_accuracy.py's lidar room, frame `seed` of its corridor."""
    scene = synth.room_scene(11, half=8.0, floor_y=1.8, ceil_y=-3.0, n_pillars=4)
    traj = synth.corridor_trajectory(seed + 1, step=0.15, yaw_rate=0.02, bob=0.0)
    return synth.render_lidar_scan(scene, traj[seed], n_beams=n_beams, n_az=n_az,
                                   fov_deg=fov_deg, noise=0.005, seed=seed)


SCANS = {"synthetic": (synthetic_scan(), 8), "rendered": (rendered_scan(), 32)}


@pytest.fixture(scope="module", params=sorted(SCANS))
def scan(request):
    pts, beams = SCANS[request.param]
    xyz = np.ascontiguousarray(pts[:, :3], np.float32)
    inten = np.ascontiguousarray(pts[:, 3], np.float32)
    rings = J.ring_ids(xyz, beams)
    return pts.astype(np.float32), xyz, inten, rings, beams


def test_ring_ids_equal_jax(scan):
    _, xyz, _, rings, beams = scan
    assert np.array_equal(T.ring_ids(torch.from_numpy(xyz), beams).numpy(), rings)


@pytest.mark.parametrize("bounds", [(0.4, 4.0, 40.0), (0.2, 1.0, 12.0)])
def test_edge_detection_equals_jax(scan, bounds):
    _, xyz, inten, rings, _ = scan
    want = J.edge_detection(xyz, inten, rings, *bounds)
    got = T.edge_detection(torch.from_numpy(xyz), torch.from_numpy(inten),
                           torch.from_numpy(rings), *bounds).numpy()
    assert want.sum() > 0 and np.array_equal(got, want)


def test_loam_curvature_equals_jax_bit_for_bit(scan):
    _, xyz, _, rings, _ = scan
    want = J.loam_curvature(xyz, rings)
    got = T.loam_curvature(torch.from_numpy(xyz), torch.from_numpy(rings)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("num_want", [300, 1000, 10 ** 6])
def test_surface_selection_equals_jax(scan, num_want):
    _, xyz, _, rings, _ = scan
    want = J.surface_selection(xyz, rings, num_want)
    got = T.surface_selection(torch.from_numpy(xyz), torch.from_numpy(rings), num_want).numpy()
    assert want.sum() > 0 and np.array_equal(got, want)


def _clouds_equal(pc_t, pc_j):
    got, want = t_valid(pc_t), j_valid(pc_j)
    assert got.keys() == want.keys() and pc_t.capacity == int(pc_j.xyz.shape[0])
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    return len(want["xyz"])


@pytest.mark.parametrize("capacity", [None, 512])
def test_pointcloud_from_lidar_equals_jax(scan, capacity):
    pts, _, _, _, beams = scan
    kw = dict(num_want=1000, beam_num=beams, bucket=256, capacity=capacity)
    n = _clouds_equal(T.pointcloud_from_lidar(pts, device="cpu", **kw),
                      J.pointcloud_from_lidar(pts, **kw))
    assert n == (capacity or n) and n > 200


def test_pointcloud_from_lidar_semantic_equals_jax(scan):
    pts, _, _, _, beams = scan
    sem = (np.arange(len(pts)) % 23 - 2).astype(np.int32)     # -2..20: drops and clips
    kw = dict(num_want=1000, beam_num=beams, bucket=256, semantics=sem, num_classes=19,
              capacity=400)
    assert _clouds_equal(T.pointcloud_from_lidar(pts, device="cpu", **kw),
                         J.pointcloud_from_lidar(pts, **kw)) == 400


def test_pointcloud_from_lidar_takes_tensors_and_rejects_unknown_methods():
    pts = synthetic_scan().astype(np.float32)
    a = T.pointcloud_from_lidar(pts, beam_num=8, device="cpu")
    b = T.pointcloud_from_lidar(torch.from_numpy(pts), beam_num=8, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(
        (a.xyz, a.mask, a.features, a.geometric_types),
        (b.xyz, b.mask, b.features, b.geometric_types)))
    with pytest.raises(ValueError, match="method"):
        T.pointcloud_from_lidar(pts, method="nope", device="cpu")


# --------------------------------------------------------------- LeGO-LOAM


LEGO_SCANS = {"lego": lambda: lego_synthetic_scan(),
              "rendered": lambda: rendered_scan(64, 1800, fov_deg=HDL64_FOV)[:, :3]}


@pytest.fixture(scope="module", params=sorted(LEGO_SCANS))
def lego(request):
    xyz = np.ascontiguousarray(LEGO_SCANS[request.param](), np.float32)
    ri, ii = J.project_range_image(xyz)
    g = J.ground_mask_range_image(xyz, ii)
    seg = J.segment_range_image(ri, g)
    tx = torch.from_numpy(xyz)
    rt, it = T.project_range_image(tx)
    gt = T.ground_mask_range_image(tx, it)
    st = T.segment_range_image(rt, gt)
    return xyz, (ri, ii, g, seg), (rt, it, gt, st)


def test_range_image_within_cell_share(lego):
    xyz, (ri, ii, g, seg), (rt, it, gt, st) = lego
    filled = int((ii >= 0).sum())
    assert filled > 0.5 * len(xyz)
    differ = ii != it.numpy()
    assert differ.sum() <= CELL_SHARE * filled, differ.sum()
    same = ~differ
    # where the same point fills a cell, its range is JAX's to the bit
    assert np.array_equal(rt.numpy()[same], ri[same])
    assert (g != gt.numpy()).sum() <= CELL_SHARE * filled
    assert (seg != st.numpy()).sum() <= CELL_SHARE * filled
    assert seg.sum() > 0.1 * filled


def _jaccard(a, b):
    a, b = set(np.asarray(a).tolist()), set(np.asarray(b).tolist())
    return len(a & b) / max(len(a | b), 1)


def test_legoloam_select_overlaps_jax(lego):
    xyz = lego[0]
    e, s = J.legoloam_select(xyz)
    et, st = T.legoloam_select(torch.from_numpy(xyz))
    assert len(e) > 10 and len(s) > 100
    assert _jaccard(e, et.numpy()) >= OVERLAP and _jaccard(s, st.numpy()) >= OVERLAP


@pytest.mark.parametrize("seed", [0, 3])
def test_feature_loop_on_jax_inputs_equals_jax(lego, seed):
    """L2's plain version and the device-side draw, given JAX's own range
    image and segmentation: JAX's edge and surface indices, order included."""
    _, (ri, ii, g, seg), _ = lego
    e, s = J._loam_extract_features(ri, ii, seg, g, seed=seed)
    et, st = T.loam_extract_features(torch.from_numpy(ri), torch.from_numpy(ii),
                                     torch.from_numpy(seg), torch.from_numpy(g), seed=seed)
    assert len(e) > 10 and np.array_equal(et.numpy(), e) and np.array_equal(st.numpy(), s)


def test_feature_loop_has_no_curvature_ties(lego):
    """JAX's argsort is not stable; the port breaks ties among a sector's
    candidates (curvature > 0.1) to the later column. No sector of the
    fixtures holds such a tie (the noise-free lego scan has equal
    curvatures, but only in mirrored sectors), so the order cannot differ."""
    _, (ri, ii, g, seg), _ = lego
    keep = seg & (ii >= 0)
    for i in range(ri.shape[0]):
        r = ri[i, np.nonzero(keep[i])[0]]
        if len(r) < 12:
            continue
        d = np.array([r[k - 5:k + 6].sum() - 11 * r[k] for k in range(5, len(r) - 5)])
        curv = np.concatenate([np.full(5, np.nan), d * d, np.full(5, np.nan)])
        sec = np.linspace(0, len(r), 7).astype(int)
        for s in range(6):
            c = curv[sec[s]:sec[s + 1]]
            c = c[np.isfinite(c) & (c > 0.1)]
            assert len(np.unique(c)) == len(c), (i, s)


def test_pointcloud_from_lidar_legoloam_matches_jax(lego):
    xyz = lego[0]
    pts = np.concatenate(
        [xyz, np.random.default_rng(1).uniform(0, 1, (len(xyz), 1))], 1).astype(np.float32)
    want = j_valid(J.pointcloud_from_lidar(pts, method="legoloam", bucket=1024))
    got = t_valid(T.pointcloud_from_lidar(pts, method="legoloam", bucket=1024, device="cpu"))
    key = lambda d: {tuple(p) for p in d["xyz"].tolist()}
    assert len(key(got) & key(want)) >= OVERLAP * len(key(got) | key(want))
    assert np.array_equal(got["geometric_types"][:, 0], np.ones(len(got["xyz"])))


# ---------------------------------------------------------------- kernels' plain versions


def _canonical(labels):
    """Each component named by its smallest cell id."""
    flat = np.asarray(labels).ravel()
    low = np.full(flat.max() + 1, flat.size, np.int64)
    np.minimum.at(low, flat, np.arange(flat.size))
    return low[flat]


@pytest.mark.parametrize("density", [0.3, 0.55, 0.8])
def test_components_plain_gives_scipys_partition(density):
    rng = np.random.default_rng(int(density * 100))
    rows, cols = 16, 90
    link_v = rng.random((rows - 1, cols)) < density
    link_h = rng.random((rows, cols)) < density
    ids = np.arange(rows * cols).reshape(rows, cols)
    a = np.concatenate([ids[:-1][link_v], ids[link_h]])
    b = np.concatenate([ids[1:][link_v], np.roll(ids, -1, 1)[link_h]])
    _, want = connected_components(coo_matrix((np.ones(len(a)), (a, b)),
                                              shape=(rows * cols,) * 2), directed=False)
    got = L.components_plain(torch.from_numpy(link_v), torch.from_numpy(link_h))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().ravel(), _canonical(want))


def test_linspace_sector_bounds_equal_numpy():
    for m in range(12, 4000):
        assert L.sector_bounds(m) == np.linspace(0, m, 7).astype(int).tolist(), m


def test_window_sums_follow_numpys_pairwise_order():
    r = np.random.default_rng(5).uniform(1, 60, 4000).astype(np.float32)
    want = np.array([r[k - 5:k + 6].sum() for k in range(5, len(r) - 5)], np.float32)
    assert np.array_equal(L._window_sums(torch.from_numpy(r)).numpy(), want)


def test_numpy_stream_splits_into_sector_draws():
    """One draw of the total equals the sectors' draws in order (PCG64
    doubles take one 64-bit output each), so the surface draw can be one
    upload."""
    sizes = [3, 0, 17, 5, 1000, 1, 250]
    for seed in (0, 1, 12345):
        rng = np.random.default_rng(seed)
        parts = np.concatenate([rng.random(n) for n in sizes])
        assert np.array_equal(parts, np.random.default_rng(seed).random(sum(sizes)))


def test_choice_over_positions_equals_choice_over_indices():
    idx = np.sort(np.random.default_rng(2).choice(50000, 9000, replace=False))
    for seed in (0, 4):
        a = np.random.default_rng(seed).choice(idx, 1000, replace=False)
        b = idx[np.random.default_rng(seed).choice(len(idx), 1000, replace=False)]
        assert np.array_equal(a, b)


def test_wrappers_take_the_plain_path_on_cpu(monkeypatch):
    def no_build(name):
        raise AssertionError(f"a CPU call tried to load the {name} kernel")

    monkeypatch.setattr(cuda_lib, "load", no_build)
    rng = np.random.default_rng(7)
    lv = torch.from_numpy(rng.random((7, 40)) < 0.6)
    lh = torch.from_numpy(rng.random((8, 40)) < 0.6)
    ranges = torch.from_numpy(rng.uniform(2, 30, (8, 40)).astype(np.float32))
    keep = torch.from_numpy(rng.random((8, 40)) < 0.8)
    L.reset_launches()
    assert torch.equal(L.components(lv, lh), L.components_plain(lv, lh))
    got, want = L.loam_features(ranges, keep), L.loam_features_plain(ranges, keep)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    kind, rest = got
    assert kind.dtype == torch.uint8 and rest.shape == (8, L.N_SECTORS)
    assert int(rest.sum()) == int((kind == L.REST).sum())
    assert L.components.launches == L.loam_features.launches == 0
