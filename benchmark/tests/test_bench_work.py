"""The work counts of benchmark/work/ against hand-computed shapes, and the
metric readers on a trace made by hand."""

import harness


def test_select_lanes_bytes():
    w = harness.load_module("work", "select_lanes")
    N = 16384
    # source xyz + radius, moved targets, pose; idx + 3 coordinates a slot; kept
    per_lane = N * 16 + N * 12 + 48 + 32 * N * (4 + 12) + N * 4
    assert w.work(N, N, 32, 32) == (32 * per_lane, 0)
    assert per_lane == 8_912_944


def test_ell_consume_bytes_and_ops():
    w = harness.load_module("work", "ell_consume")
    nbytes, ops = w.work(16384, 32, 32)
    assert nbytes == 32 * 2 * (32 * 16384 * 12 + 16384 * 12)
    assert ops == 32 * 32 * 16384 * 154


def test_sgm_scan_bytes_match_the_3way_paths():
    w = harness.load_module("work", "sgm_scan")
    nbytes, _ = w.work(376, 1241, 128)
    # 1113 matched columns; the two horizontal paths alone are the
    # 857.1 MB "across" scan
    assert nbytes == 3 * 376 * 1113 * 128 * 8
    assert round(2 * 376 * 1113 * 128 * 8 / 1e6, 1) == 857.1


class _Trace:
    def __init__(self, events, window_s, units):
        self.events, self.window_s, self.units = events, window_s, units

    busy_us = harness.TraceWindow.busy_us


def _ctx(events, units, **kw):
    return harness.Context(trace=_Trace(events, 1.0, units), kernels=harness.KernelMap(),
                           bench=harness.BENCH, peaks=harness.load_json(
                               harness.BENCH / "peaks.json"), **kw)


def test_roofline_and_share_readers():
    peaks = harness.load_json(harness.BENCH / "peaks.json")
    nbytes, ops = harness.load_module("work", "ell_consume").work(1000, 32, 2)
    least_us = max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["f32_flops"]) * 1e6
    events = [("void flow_kernel<a>", 0.0, least_us), ("void step_kernel<b>", 10.0, least_us),
              ("void at::native::add", 20.0, 5.0)]
    ctx = _ctx(events, 1, counters={"points": 1000, "K": 32, "lanes": 2, "clean_s": 1e-3,
                                    "clean_units": 10})
    share = harness.load_module("metrics", "ell_consume_roofline").read(ctx)
    assert abs(share - 50.0) < 1e-9
    glue = harness.load_module("metrics", "glue_busy_ms.fleet").read(ctx)
    assert abs(glue - 5e-3) < 1e-12
    # busy a unit 20 us + 2 least_us against 100 us a unit of clean wall
    idle = harness.load_module("metrics", "idle_share.fleet").read(ctx)
    assert abs(idle - 100.0 * (1 - (5.0 + 2 * least_us) / 100.0)) < 1e-9
    assert harness.load_module("metrics", "select_lanes_roofline").read(
        _ctx([], 1, counters={"trace_lanes_built": 0})) is None


def test_busy_is_the_union_of_intervals():
    t = _Trace([("a", 0.0, 10.0), ("b", 5.0, 10.0), ("c", 30.0, 1.0)], 1.0, 1)
    assert t.busy_us() == 16.0


def test_percentile_and_spread():
    import spread

    assert harness.percentile(list(range(101)), 95) == 95
    assert harness.percentile([3.0], 95) == 3.0
    assert spread.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert abs(spread.spread([1.0, 2.0, 3.0, 4.0, 5.0]) - (4.5 - 1.5) / 3.0) < 1e-12
