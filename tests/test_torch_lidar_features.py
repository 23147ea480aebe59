"""L2 (`ops/lidar.py::loam_features`, csrc/lidar.cu) on the CPU, on the
adversarial rings that chip_smoke.py's phase 13a' runs on the card
(`chip_smoke.loam_rings`).

- The port's `frontend/lidar.py::loam_extract_features` (L2's plain version
  and the device-side surface draw) gives JAX's `_loam_extract_features`
  edge and surface indices, order included, on each case: dense candidates
  with the 20-corner cap binding in every sector, column steps of 9-12
  and 21 inside and at the ends of suppression runs, a corner in a
  sector's last 5 positions that marks the next sector, rings of 11-29
  kept columns, range steps just past the occlusion and parallel-beam
  thresholds, a curvature ramp, random walls, and the kernel's MAX_COLS
  (3400 columns). JAX's argsort is not stable, so each case first checks
  that no sector holds a curvature tie among its candidates.
- On a tie the plain version takes the later column first.
- The kernel's design, transcribed in Python (`round_features`: every live
  candidate that outranks its live and corner neighbours becomes a corner,
  then the live neighbours of corners drop; at most 20 rounds a sector; the
  20 corners that fewer than 20 others outrank are kept), gives the plain
  version's serial walk, kind and rest counts, on every case and on rings
  with ties; the ramp takes all 20 rounds in every sector.

`python tests/test_torch_lidar_features.py` prints the rounds the design
takes a sector on phase 13's frame 0 and on each case.
"""

import math
import sys
from pathlib import Path

if __name__ == "__main__":      # as a script: the repo root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import pytest
import torch

import chip_smoke
from unified_cvo_tpu.frontend import lidar as J
from unified_cvo_tpu_torch.frontend import lidar as T
from unified_cvo_tpu_torch.ops import lidar as L

torch.set_num_threads(1)

# (case, rows, cols): each case at a few rings; "short rings" needs 19 (one
# ring a kept count, 11-29) and ~400 columns to place them
JAX_CASES = [("dense", 3, 1800), ("gaps", 4, 1800), ("sector edge", 5, 1800),
             ("short rings", 19, 400), ("thresholds", 3, 1800), ("ramp", 2, 1800),
             ("random", 3, 1800), ("dense", 2, 3400), ("gaps", 2, 3400)]


def case_inputs(case, rows, cols):
    r, i, seg = chip_smoke.loam_rings(case, rows, cols)
    return r, i, seg, seg & (i >= 0)


def ring_curvature(r):
    """JAX's curvature of one ring's kept ranges (float32 window sums)."""
    m = len(r)
    curv = np.full(m, np.nan)
    for k in range(5, m - 5):
        d = r[k - 5:k + 6].sum() - 11 * r[k]
        curv[k] = d * d
    return curv


def candidate_ties(r):
    """Sectors of one ring whose candidates (curvature > 0.1) hold a tie."""
    if len(r) < 12:
        return []
    curv = ring_curvature(r)
    sec = np.linspace(0, len(r), 7).astype(int)
    out = []
    for s in range(6):
        c = curv[sec[s]:sec[s + 1]]
        c = c[np.isfinite(c) & (c > 0.1)]
        if len(np.unique(c)) != len(c):
            out.append(s)
    return out


def check_case_shape(case, r, keep, kind):
    """What each case is made to exercise is there."""
    rows = r.shape[0]
    kept = [np.nonzero(keep[i])[0] for i in range(rows)]
    if case == "dense":
        for i in range(rows):
            b = L.sector_bounds(len(kept[i]))
            ring_kind = kind[i, kept[i]]
            assert all((ring_kind[b[s]:b[s + 1]] == L.EDGE).sum() == L.MAX_CORNERS
                       for s in range(6)), i
    elif case == "gaps":
        steps = np.concatenate([np.diff(c) for c in kept])
        assert all((steps == d).any() for d in (9, 10, 11, 12, 21))
    elif case == "sector edge":
        offsets = set()
        for i in range(rows):
            ring_kind, m = kind[i, kept[i]], len(kept[i])
            b = L.sector_bounds(m)
            for s in range(5):
                tail = np.nonzero(ring_kind[b[s + 1] - 5:b[s + 1]] == L.EDGE)[0]
                assert len(tail), (i, s)
                offsets.add(int(4 - tail[-1]))
        assert offsets == {0, 1, 2, 3, 4}
    elif case == "short rings":
        assert sorted(len(c) for c in kept) == list(range(11, 30))
    elif case == "thresholds":
        for i in range(rows):
            rr = r[i, kept[i]]
            step = np.diff(rr)
            assert ((np.abs(step) > np.float32(0.3)) & (np.abs(step) < 0.3 + 1e-4)).any()
            assert ((np.abs(step) <= np.float32(0.3)) & (np.abs(step) > 0.3 - 1e-4)).any()
            lim = np.float32(0.02) * rr[:-1]
            rel = np.abs(step) / lim
            assert ((rel > 1) & (rel < 1 + 1e-4)).any() and ((rel <= 1) & (rel > 1 - 1e-4)).any()


@pytest.mark.parametrize("case,rows,cols", JAX_CASES,
                         ids=[f"{c}-{n}x{w}" for c, n, w in JAX_CASES])
def test_features_on_adversarial_rings_equal_jax(case, rows, cols):
    r, i, seg, keep = case_inputs(case, rows, cols)
    assert r.shape == (rows, cols) and r.dtype == np.float32
    for k in range(rows):
        assert candidate_ties(r[k, keep[k]]) == [], (case, k)
    ground = np.zeros_like(seg)
    e, s = J._loam_extract_features(r, i, seg, ground, seed=3)
    et, st = T.loam_extract_features(torch.from_numpy(r), torch.from_numpy(i),
                                     torch.from_numpy(seg), torch.from_numpy(ground), seed=3)
    assert len(e) > 0 and np.array_equal(et.numpy(), e) and np.array_equal(st.numpy(), s)
    kind, _ = L.loam_features_plain(torch.from_numpy(r), torch.from_numpy(keep))
    check_case_shape(case, r, keep, kind.numpy())


def tie_ring():
    """One ring of 60 columns at 20 m with two bumps of 0.25 m at positions
    32 and 35, both in sector 3 ([30, 40)): every sum is exact in float32,
    so their curvatures tie at 5.0625, the sector's largest."""
    r = np.full((1, 60), 20.0, np.float32)
    r[0, 32] = r[0, 35] = 20.25
    return r, np.ones((1, 60), bool)


def test_plain_breaks_a_curvature_tie_to_the_later_column():
    r, keep = tie_ring()
    curv = ring_curvature(r[0])
    assert curv[32] == curv[35] == 5.0625 == np.nanmax(curv)
    assert L.sector_bounds(60)[3:5] == [30, 40]
    kind, rest = L.loam_features_plain(torch.from_numpy(r), torch.from_numpy(keep))
    kind = kind.numpy()[0]
    # the later bump is visited first, becomes a corner and marks the earlier one
    assert kind[35] == L.EDGE and kind[32] == L.REST
    assert int(rest.sum()) == int((kind == L.REST).sum())


# ---------------------------------------------------------------- the design


def _ring_state(r, ci):
    """Curvature (float32, NaN at the ends), pre-marks and each position's
    reach (positions a corner there marks ahead and behind), as the
    kernel's prologue computes them."""
    m = len(r)
    rt = torch.from_numpy(r)
    curv = np.full(m, np.nan, np.float32)
    d = (L._window_sums(rt) - 11 * rt[5:m - 5]).numpy()
    curv[5:m - 5] = d * d
    picked = np.zeros(m, bool)
    picked[:5] = picked[m - 5:] = True
    step = (rt[1:] - rt[:-1]).numpy()
    for k in range(5, m - 6):
        if ci[k + 1] - ci[k] < 10:
            if step[k] < np.float32(-0.3):
                picked[k - 5:k + 1] = True
            elif step[k] > np.float32(0.3):
                picked[k + 1:k + 7] = True
    lim = (0.02 * rt).numpy()
    dp = np.concatenate([[0], np.abs(step)]).astype(np.float32)
    dn = np.concatenate([np.abs(step), [0]]).astype(np.float32)
    picked |= (dp > lim) & (dn > lim)
    gap = np.concatenate([[True], np.diff(ci) > 10, [True]])     # gap[l]: between l-1 and l
    ahead = [next(a for a in range(6) if a == 5 or gap[k + a + 1]) for k in range(m)]
    behind = [next(b for b in range(6) if b == 5 or gap[k - b]) for k in range(m)]
    return curv, picked, ahead, behind


def round_features(range_img, keep, edge_threshold=0.1):
    """The kernel's resolution in rounds, position by position: returns
    (kind, rest_counts, rounds a sector, block barriers a ring) as numpy
    arrays."""
    rows, cols = range_img.shape
    kind = np.zeros((rows, cols), np.uint8)
    rest = np.zeros((rows, L.N_SECTORS), np.int32)
    rounds = np.zeros((rows, L.N_SECTORS), np.int32)
    barriers = np.zeros(rows, np.int32)
    for i in range(rows):
        ci = np.nonzero(keep[i])[0]
        m = len(ci)
        if m < 12:
            continue
        curv, picked, ahead, behind = _ring_state(range_img[i, ci], ci)
        code = np.zeros(m, np.uint8)
        bounds = L.sector_bounds(m)
        barriers[i] = 5                                   # the prologue
        for s in range(L.N_SECTORS):
            sp, ep = bounds[s], bounds[s + 1]
            if ep - sp < 2:
                continue

            def near(k):
                return range(max(sp, k - behind[k]), min(ep - 1, k + ahead[k]) + 1)

            def over(l, k):
                return curv[l] > curv[k] or (curv[l] == curv[k] and l > k)

            live = {k for k in range(sp, ep) if not picked[k] and math.isfinite(curv[k])
                    and float(curv[k]) > edge_threshold}
            corners = []
            while live and rounds[i, s] < L.MAX_CORNERS:
                new = [k for k in live if not any(l != k and (l in live or l in corners)
                                                  and over(l, k) for l in near(k))]
                corners += new
                live -= set(new)
                live -= {k for k in live if any(l in corners for l in near(k))}
                rounds[i, s] += 1
            kept = [k for k in corners
                    if sum(over(l, k) for l in corners) < L.MAX_CORNERS]
            code[sp:ep] = L.REST
            for k in kept:
                code[k] = L.EDGE
                picked[k - behind[k]:k + ahead[k] + 1] = True
            rest[i, s] = (ep - sp) - len(kept)
            # the loop's test (a barrier) once more than its rounds, each round's
            # second barrier, the cap's count where it runs, the close
            barriers[i] += 2 * rounds[i, s] + 2 + (len(corners) > L.MAX_CORNERS)
        kind[i, ci] = code
    return kind, rest, rounds, barriers


ROUND_CASES = [(c, 3, 1800) for c in chip_smoke.LOAM_CASES if c != "short rings"] + [
    ("short rings", 19, 400), ("dense", 2, 3400), ("ramp", 1, 3400)]


@pytest.mark.parametrize("case,rows,cols", ROUND_CASES,
                         ids=[f"{c}-{n}x{w}" for c, n, w in ROUND_CASES])
def test_round_resolution_equals_the_serial_walk(case, rows, cols):
    r, _, _, keep = case_inputs(case, rows, cols)
    kind, rest, rounds, _ = round_features(r, keep)
    kp, rp = L.loam_features_plain(torch.from_numpy(r), torch.from_numpy(keep))
    assert np.array_equal(kind, kp.numpy()) and np.array_equal(rest, rp.numpy())
    assert rounds.max() <= L.MAX_CORNERS
    if case == "ramp":
        assert (rounds == L.MAX_CORNERS).all()


def test_round_resolution_on_a_tie_and_random_small_rings():
    r, keep = tie_ring()
    kind, rest, _, _ = round_features(r, keep)
    kp, rp = L.loam_features_plain(torch.from_numpy(r), torch.from_numpy(keep))
    assert np.array_equal(kind, kp.numpy()) and np.array_equal(rest, rp.numpy())
    rng = np.random.default_rng(19)
    for trial in range(24):
        cols = int(rng.integers(8, 120))
        r = (np.round(rng.uniform(5, 30, (2, 1))) + 0.04 * rng.integers(-4, 5, (2, cols))
             if trial % 2 else rng.uniform(1, 40, (2, cols))).astype(np.float32)
        keep = rng.random((2, cols)) < rng.uniform(0.3, 1.0)
        thr = float(rng.choice([0.0, 0.1, 1.0]))
        kind, rest, _, _ = round_features(r, keep, thr)
        kp, rp = L.loam_features_plain(torch.from_numpy(r), torch.from_numpy(keep), thr)
        assert np.array_equal(kind, kp.numpy()) and np.array_equal(rest, rp.numpy()), trial


def _phase13_frame():
    """Phase 13's frame 0 (chip_smoke.cc_inputs' lidar scan) through the
    port's LeGO-LOAM stages on the CPU: (range image, kept cells)."""
    from unified_cvo_tpu_torch.utils import synth

    traj = synth.corridor_trajectory(1, step=0.15, yaw_rate=0.02, bob=0.0)
    scene = synth.room_scene(11, half=8.0, floor_y=1.8, ceil_y=-3.0, n_pillars=4)
    scan = synth.render_lidar_scan(scene, traj[0], n_beams=chip_smoke.LIDAR_BEAMS,
                                   n_az=chip_smoke.LIDAR_AZ, fov_deg=chip_smoke.LIDAR_FOV,
                                   noise=0.005, seed=0)
    x = torch.from_numpy(np.ascontiguousarray(scan[:, :3]))
    ri, ii = T.project_range_image(x)
    keep = T.segment_range_image(ri, T.ground_mask_range_image(x, ii)) & (ii >= 0)
    return ri.numpy(), keep.numpy()


if __name__ == "__main__":
    sets = {"phase 13 frame 0 (64 x 1800)": _phase13_frame()}
    for case in chip_smoke.LOAM_CASES:
        for cols in chip_smoke.LOAM_WIDTHS:
            r, _, _, keep = case_inputs(case, 4, cols)
            sets[f"{case} (4 x {cols})"] = (r, keep)
    for name, (r, keep) in sets.items():
        _, _, rounds, barriers = round_features(r, keep)
        ring = rounds.sum(1)
        print(f"{name}: kept columns a ring max {int(keep.sum(1).max())}; rounds a sector "
              f"{int(rounds.min())}-{int(rounds.max())}, a ring max {int(ring.max())}; block "
              f"barriers a ring max {int(barriers.max())} (ring {int(barriers.argmax())})")
