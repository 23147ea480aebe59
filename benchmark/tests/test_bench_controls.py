"""Each cell's control (the reference computed in TF32 in the package's
place) comes out not correct, and so does a run with the timed path broken
underneath in each way the cell can break: a step that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced. (One card: no exchange between chips to leave out.) CPU, tiny
sizes; the card's readings at the cells' own sizes come from
benchmark/calibrate.py."""

import importlib

import pytest
import torch

import bench_tiny
import calibrate


@pytest.mark.parametrize("cell,seed", [("geo16k-fleet32", 11), ("geo16k-fleet32", 12),
                                       ("stereo-frontend", 13)])
def test_control_fails_a_limit(cell, seed):
    r = calibrate.readings(cell, seed, device="cpu", **bench_tiny.TINY[cell])
    assert all(v <= r["limits"][n] for n, v in r["program"].items()), r["program"]
    assert any(v > r["limits"][n] for n, v in r["control"].items()), r["control"]


def _mod(name):
    return importlib.import_module(name)


def _fleet_state_unchanged(mp):
    sched = _mod("unified_cvo_tpu_torch.models.align")._Schedule
    mp.setattr(sched, "advance_lanes",
               lambda st, k, active, *a, **kw: torch.zeros_like(active))


def _fleet_half_batch(mp):
    ell = _mod("unified_cvo_tpu_torch.ops.ell")
    orig = ell.flow_reduce_lanes

    def half(*a, **kw):
        unit, jn, nz, asum, A = orig(*a, **kw)
        h = unit.shape[0] // 2
        jn, unit = jn.clone(), unit.clone()
        jn[h:] = jn[:h].mean()
        unit[h:] = unit[:h].mean(0)
        return unit, jn, nz, asum, A

    mp.setattr(ell, "flow_reduce_lanes", half)


def _fleet_answer_altered(mp):
    ba = _mod("unified_cvo_tpu_torch.parallel.batch_align")
    orig = ba.align_batch

    def altered(*a, **kw):
        T, ret, info = orig(*a, **kw)
        T = T.clone()
        T[0, 0, 3] += 0.1
        return T, ret, info

    mp.setattr(ba, "align_batch", altered)


def _stereo_state_unchanged(mp):
    pipe = _mod("unified_cvo_tpu_torch.frontend.pipeline")
    orig = pipe.make_raw_image
    mp.setattr(pipe, "make_raw_image",
               lambda img, *a, **kw: orig(img, *a, **dict(kw, denoise=False)))


def _stereo_half_batch(mp):
    sel = _mod("unified_cvo_tpu_torch.frontend.selector")
    orig = sel.select_points

    def half(*a, **kw):
        uv, g = orig(*a, **kw)
        return uv[: len(uv) // 2], g[: len(uv) // 2]

    mp.setattr(sel, "select_points", half)


def _stereo_answer_altered(mp):
    pipe = _mod("unified_cvo_tpu_torch.frontend.pipeline")
    orig = pipe.compute_disparity

    def altered(*a, **kw):
        d = orig(*a, **kw).clone()
        d[100, 200] += 1.0 / 16.0
        return d

    mp.setattr(pipe, "compute_disparity", altered)


FAULTS = {
    ("geo16k-fleet32", "state_unchanged"): _fleet_state_unchanged,
    ("geo16k-fleet32", "half_batch"): _fleet_half_batch,
    ("geo16k-fleet32", "answer_altered"): _fleet_answer_altered,
    ("stereo-frontend", "state_unchanged"): _stereo_state_unchanged,
    ("stereo-frontend", "half_batch"): _stereo_half_batch,
    ("stereo-frontend", "answer_altered"): _stereo_answer_altered,
}


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[(cell, fault)](monkeypatch)
    res = bench_tiny.run(cell, seed=2147483651)
    assert res["correct"] is False, res["checks"]
