"""Driver of a stereo frontend cell: one stream of stereo pairs, each turned
into a colour point cloud by the measured package's default frontend
(`frontend/pipeline.py::pointcloud_from_stereo`), one at a time.

Set-up renders the traffic's pairs on the device from the seed and keeps
them on the host as uint8 images, as a camera driver hands them over; a
step takes the next pair (cycled: the frontend keeps no state between
frames), makes its cloud and waits for the device. A step's unit is one
frame; its latency is from the call to the synchronised end.

Taps on the pipeline's stage functions (`make_raw_image`,
`compute_disparity`, `selector.select_points`; restored at `release`)
keep, in frames drawn from the seed, what each stage produced, and with
tracing time each stage with CUDA events in every frame before the
profiler starts (`stage_ms.*`), and profile `trace_frames` frames from the
first that starts `trace_after_s` into the window.

`check` runs `reference/stereo_ref.py` on each kept frame's pair and
compares the denoised image, the disparity map and the keypoints exactly,
and the cloud: the same pixels kept (outside a band of 1e-4 m around the
55 m range gate, where float32 and float64 may fall either side), xyz
relative gap, features bit for bit.
"""

from __future__ import annotations

import functools
import importlib
import time

import numpy as np
import torch

import harness

RANGE_BAND_M = 1e-4


class Driver:
    def __init__(self, config, workload, seed, device, trace, spans, bench, log,
                 traffic=None, camera=None):
        self.config, self.workload, self.seed = config, workload, int(seed)
        self.dev, self.trace, self.spans, self.bench, self.log = device, trace, spans, bench, log
        self.spec = dict(workload["traffic"], **(traffic or {}))
        self.camera = dict(config, **(camera or {}))
        self.limits = workload["limits"]
        rng = np.random.default_rng([self.seed, 2])
        horizon = int(workload["check_horizon"])
        self.keep = set(int(i) for i in rng.choice(horizon, int(workload["check_frames"]),
                                                   replace=False))
        self.keep.add(int(rng.integers(0, int(self.spec["pairs"]))))
        self.trace_after_s = float(workload["trace_after_s"])
        self.trace_frames = int(workload["trace_frames"])
        self.t_window = None
        self.clean_s, self.clean_frames = 0.0, 0   # frames the tracer never touched
        self.kept = {}
        self.frame = -1
        self._cur = None
        self._restore = []

    def setup(self):
        from unified_cvo_tpu_torch.frontend.calibration import Calibration

        t0 = time.perf_counter()
        tmod = harness.load_module("traffic", self.workload["traffic_generator"], self.bench)
        self.pairs = tmod.make(self.spec, self.camera, self.seed, self.dev)
        t1 = time.perf_counter()
        c = self.camera
        K = np.array([[c["fx"], 0.0, c["cx"]], [0.0, c["fy"], c["cy"]], [0.0, 0.0, 1.0]],
                     np.float32)
        self.calib = Calibration(K, baseline=float(c["baseline"]), cols=int(c["cols"]),
                                 rows=int(c["rows"]))
        self.pipe = importlib.import_module("unified_cvo_tpu_torch.frontend.pipeline")
        self._install_taps()
        self._call(*self.pairs[0])
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        self.log(f"set-up: inputs {t1 - t0:.3f} s, "
                 f"kernels and warm pass {time.perf_counter() - t1:.3f} s")
        self.frame = 0

    def _call(self, left, right):
        c = self.config
        return self.pipe.pointcloud_from_stereo(
            left, right, self.calib, method=c["method"], denoise=bool(c["denoise"]),
            bucket=int(c["bucket"]), capacity=int(c["capacity"]),
            stereo_backend=c["stereo_backend"], device=self.dev)

    def _install_taps(self):
        sel = importlib.import_module("unified_cvo_tpu_torch.frontend.selector")
        drv = self

        def tap(obj, attr, span, keep):
            orig = getattr(obj, attr)

            def wrapped(*a, **kw):
                if drv.trace.enabled and drv.frame >= 0 and not drv.trace.started:
                    out = drv.spans.device(span, orig, *a, **kw)
                else:
                    out = orig(*a, **kw)
                if drv._cur is not None:
                    drv._cur[span] = keep(out)
                return out

            self._restore.append((obj, attr, orig))
            setattr(obj, attr, functools.update_wrapper(wrapped, orig))

        tap(self.pipe, "make_raw_image", "nlm", lambda raw: raw.image.clone())
        tap(self.pipe, "compute_disparity", "disparity", lambda d: d.clone())
        tap(sel, "select_points", "select", lambda out: out[0].clone())

    def step(self) -> dict:
        i = self.frame
        left, right = self.pairs[i % len(self.pairs)]
        t0 = time.perf_counter()
        if self.t_window is None:
            self.t_window = t0
        clean = not self.trace.started
        if clean and t0 - self.t_window >= self.trace_after_s:
            self.trace.start()
            clean = False
        self._cur = {} if i in self.keep else None
        t0 = time.perf_counter()
        cloud = self._call(left, right)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if clean:
            self.clean_s += dt
            self.clean_frames += 1
        if self._cur is not None:
            self._cur["cloud"] = (cloud.xyz.clone(), cloud.mask.clone(), cloud.features.clone())
            self.kept[i] = self._cur
            self._cur = None
        if self.trace.active:
            self.trace.units += 1
            if self.trace.units >= self.trace_frames:
                self.trace.stop()
        self.frame = i + 1
        return {"units": 1, "latency_s": dt, "failed": int(cloud.mask.sum() == 0)}

    def calibration_steps(self) -> int:
        """Steps that make every frame the checks keep."""
        return max(self.keep) + 1

    def counters(self) -> dict:
        return {"frames": self.frame, "clean_s": self.clean_s, "clean_units": self.clean_frames}

    def release(self):
        for obj, attr, orig in reversed(self._restore):
            setattr(obj, attr, orig)
        self._restore = []
        self.pipe = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, candidate: str = "program") -> list:
        """The numbers compared, each beside its limit. `candidate`
        "control" puts the reference computed in TF32 in the package's
        place."""
        import stereo_ref as ref

        out = {"denoised_px_differing": 0.0, "disparity_px_differing": 0.0,
               "keypoints_differing": 0.0, "cloud_px_differing": 0.0,
               "cloud_xyz_gap": 0.0, "cloud_features_differing": 0.0}
        c = self.camera
        for i in sorted(self.kept):
            got = self.kept[i]
            left, right = (torch.from_numpy(a).to(self.dev)
                           for a in self.pairs[i % len(self.pairs)])
            want = ref.stereo_frontend(left, right, c, int(c["capacity"]), int(c["max_disparity"]))
            if candidate == "control":
                ctl = ref.stereo_frontend(left, right, c, int(c["capacity"]),
                                          int(c["max_disparity"]), prec="tf32")
                got = _as_program(ctl)
            out["denoised_px_differing"] += float(torch.sum(torch.any(
                got["nlm"] != want.denoised, dim=-1)))
            out["disparity_px_differing"] += float(torch.sum(got["disparity"] != want.disparity))
            kp = got["select"]
            out["keypoints_differing"] += (abs(len(kp) - len(want.uv)) if len(kp) != len(want.uv)
                                           else float(torch.sum(torch.any(kp != want.uv, -1))))
            self._cloud(out, got["cloud"], want, c)
        checks = [dict(name=n, value=float(v), limit=float(self.limits[n])) for n, v in out.items()]
        self.log(f"checked frames {sorted(self.kept)} of {self.frame}")
        return checks

    @staticmethod
    def _cloud(out, cloud, want, c):
        h, w = int(c["rows"]), int(c["cols"])
        xyz, mask, feats = cloud
        n = int(mask.sum())
        xyz, feats = xyz[:n].to(torch.float64), feats[:n]
        # a row's pixel is where its ray meets the image: xyz = K^-1 [u, v, 1]
        # depth, so u = x / z fx + cx to rounding
        dev = want.xyz.device
        kept_ref = torch.zeros((h, w), dtype=torch.bool, device=dev)
        kept_ref[want.uv_kept[:, 1], want.uv_kept[:, 0]] = True
        band = torch.zeros((h, w), dtype=torch.bool, device=dev)
        near = (want.range_m - 55.0).abs() < RANGE_BAND_M
        band[want.gated_uv[near, 1], want.gated_uv[near, 0]] = True
        z = xyz[:, 2]
        u = torch.round(xyz[:, 0] / z * c["fx"] + c["cx"]).long().clamp(0, w - 1)
        v = torch.round(xyz[:, 1] / z * c["fy"] + c["cy"]).long().clamp(0, h - 1)
        kept_prog = torch.zeros((h, w), dtype=torch.bool, device=dev)
        kept_prog[v, u] = True
        differ = (kept_prog != kept_ref) & ~band
        out["cloud_px_differing"] += float(differ.sum()) + float(n - int(kept_prog.sum()))
        index = torch.full((h, w), -1, dtype=torch.long, device=dev)
        index[want.uv_kept[:, 1], want.uv_kept[:, 0]] = torch.arange(len(want.uv_kept), device=dev)
        j = index[v, u]
        both = j >= 0
        if both.any():
            ref_xyz, ref_f = want.xyz[j[both]], want.features[j[both]]
            gap = torch.linalg.vector_norm(xyz[both] - ref_xyz, dim=1) / \
                torch.linalg.vector_norm(ref_xyz, dim=1)
            out["cloud_xyz_gap"] = max(out["cloud_xyz_gap"], float(gap.max()))
            out["cloud_features_differing"] += float(torch.sum(torch.any(feats[both] != ref_f,
                                                                         dim=1)))


def _as_program(f) -> dict:
    """The reference's outputs in the form the taps keep the package's."""
    n = len(f.xyz)
    return {"nlm": f.denoised, "disparity": f.disparity, "select": f.uv.to(torch.int32),
            "cloud": (f.xyz.to(torch.float32), torch.ones(n, device=f.xyz.device),
                      f.features)}
