"""Driver of a fleet cell: many drives registered frame to frame in
lockstep through the measured package's batched registration
(`parallel/batch_align.py::make_batch_align` over
`models/align.py::align_batch`).

A step registers the next pair of every drive at once; each drive's guess
is its own previous result, inverted on the device (the constant-velocity
chain of the package's sequence driver). The next step starts when the
last one ends (a closed loop). A step's units are the pairs it registered.

Taps on the package's module attributes (restored at `release`) observe the
solve loop without changing it: a count of iterations; at two iterations
of the first timed frame (the first and one drawn from the seed), copies
of what the loop fed to and got from the flow pass, the step pass and the
schedule's pose update; with tracing, the profiled sub-window (iterations
[0, trace_iterations) of the first frame that starts `trace_after_s` into
the window) and the lanes each list build took.

`check` holds those against `reference/cvo_ref.py`: at the frame's first
iteration the reference builds every lane's candidate list itself from the
drives' frames and the loop's pose and lengthscale, then computes the flow
moments, the step coefficients and the pose update; at the later
iteration it follows the loop from the loop's own state (pose,
lengthscale and list; the list's build is what the first check judges).
Every pair's final transform is held against the drive's true motion.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import math
import time

import numpy as np
import torch

import harness

CHECK_LANES = 4           # lanes whose lists are compared slot by slot


@dataclasses.dataclass
class Capture:
    """What the loop fed to and got from one iteration."""
    lanes: list                       # lanes whose list was copied
    slots: torch.Tensor = None        # [len(lanes), 3, K, N] the list of those lanes
    joint: torch.Tensor = None        # [B, 6] unit twist * norm
    nz: torch.Tensor = None           # [B]
    asum: torch.Tensor = None         # [B]
    coeffs: torch.Tensor = None       # [B, 4]
    R: torch.Tensor = None            # [B, 3, 3] pose before the update
    T: torch.Tensor = None
    ell: torch.Tensor = None          # [B]
    active: torch.Tensor = None       # [B]
    R_after: torch.Tensor = None
    T_after: torch.Tensor = None


class Driver:
    def __init__(self, config, workload, seed, device, trace, spans, bench, log,
                 traffic=None, max_iter=None):
        self.config, self.workload, self.seed = config, workload, int(seed)
        self.dev, self.trace, self.spans, self.bench, self.log = device, trace, spans, bench, log
        self.spec = dict(workload["traffic"], **(traffic or {}))
        self.max_iter = int(config["MAX_ITER"] if max_iter is None else max_iter)
        self.limits = workload["limits"]
        rng = np.random.default_rng([self.seed, 1])
        B = int(self.spec["drives"])
        self.check_lanes = sorted(int(b) for b in rng.choice(B, min(CHECK_LANES, B),
                                                              replace=False))
        self.check_frame = 0
        self.check_iters = (0, int(rng.integers(1, self.max_iter)))
        self.trace_after_s = float(workload["trace_after_s"])
        self.trace_iters = int(workload["trace_iterations"])
        self.t_window = None
        self.clean_s, self.clean_iters = 0.0, 0   # frames the tracer never touched
        self.captures = {}
        self.results = []            # [B, 4, 4] transform of every step
        self.iterations = []         # batched iterations of every step
        self.trace_lanes_built = 0
        self._restore = []

    # ------------------------------------------------------------ set-up

    def setup(self):
        from unified_cvo_tpu_torch.config import CvoParams
        from unified_cvo_tpu_torch.parallel.batch_align import make_batch_align

        t0 = time.perf_counter()
        fields = {f.name for f in dataclasses.fields(CvoParams)}
        self.params = CvoParams(**{k: v for k, v in self.config.items() if k in fields})
        self.pdict = dataclasses.asdict(self.params)
        tmod = harness.load_module("traffic", self.workload["traffic_generator"], self.bench)
        self.fleet = tmod.make(self.spec, self.seed, self.dev)
        B, n = self.fleet.frames.shape[1:3]
        self.mask = torch.ones((B, n), dtype=torch.float32, device=self.dev)
        t1 = time.perf_counter()
        kw = dict(backend=self.config["backend"], device=self.dev)
        self.fn = make_batch_align(self.params, max_iter=self.max_iter, **kw)
        warm = make_batch_align(self.params, max_iter=int(self.workload["warm_iterations"]), **kw)
        self._install_taps()
        self.frame = -1                 # no timed frame yet: the taps stay quiet
        warm(*self._pair(0), self.fleet.guess0)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        self.log(f"set-up: inputs {t1 - t0:.3f} s, "
                 f"kernels and warm pass {time.perf_counter() - t1:.3f} s")
        self.frame = 0
        self.guess = self.fleet.guess0.clone()

    def _pair(self, k):
        from unified_cvo_tpu_torch.utils.pointcloud import PointCloud

        f = self.fleet.frames
        return (PointCloud(xyz=f[k], mask=self.mask), PointCloud(xyz=f[k + 1], mask=self.mask))

    def _install_taps(self):
        align_mod = importlib.import_module("unified_cvo_tpu_torch.models.align")
        ell_mod = importlib.import_module("unified_cvo_tpu_torch.ops.ell")
        nbr_mod = importlib.import_module("unified_cvo_tpu_torch.ops.neighbors")

        drv = self
        flow0, step0 = ell_mod.flow_reduce_lanes, ell_mod.step_cached_lanes
        build0, adv0 = nbr_mod.build_neighbor_list_lanes, align_mod._Schedule.advance_lanes

        def flow(xp, y_xyz, scal, c, d, chan=None, use_geometry=True):
            k = drv.k
            if drv.trace.active and k >= drv.trace_iters:
                drv.trace.stop()
                drv.trace.units = k
            out = flow0(xp, y_xyz, scal, c, d, chan=chan, use_geometry=use_geometry)
            cap = drv._capture(k)
            if cap is not None:
                unit, jn = out[0], out[1]
                cap.slots = y_xyz[cap.lanes].clone()
                cap.joint = (unit * jn[:, None]).clone()
                cap.nz, cap.asum = out[2].clone(), out[3].clone()
            return out

        def step(xp, y_xyz, a, scal, twist=None):
            out = step0(xp, y_xyz, a, scal, twist=twist)
            cap = drv._capture(drv.k)
            if cap is not None:
                cap.coeffs = out.clone()
            return out

        def build(params, ells, xs, *a, **kw):
            if drv.trace.active:
                drv.trace_lanes_built += len(xs)
            return build0(params, ells, xs, *a, **kw)

        def advance(st, k, active, *a, **kw):
            cap = drv._capture(k)
            if cap is not None:
                cap.R, cap.T, cap.ell = st.R.clone(), st.T.clone(), st.ell.clone()
                cap.active = active.clone()
            out = adv0(st, k, active, *a, **kw)
            if cap is not None:
                cap.R_after, cap.T_after = st.R.clone(), st.T.clone()
            drv.k = k + 1
            return out

        # the package counts launches on its module functions' attributes:
        # the taps carry the originals' attributes (functools.update_wrapper)
        for obj, name, new in ((ell_mod, "flow_reduce_lanes", flow),
                               (ell_mod, "step_cached_lanes", step),
                               (nbr_mod, "build_neighbor_list_lanes", build),
                               (align_mod._Schedule, "advance_lanes", advance)):
            self._restore.append((obj, name, getattr(obj, name)))
            setattr(obj, name, functools.update_wrapper(new, getattr(obj, name)))
        self.k = 0

    def _capture(self, k):
        if self.frame != self.check_frame or k not in self.check_iters:
            return None
        if k not in self.captures:
            self.captures[k] = Capture(lanes=self.check_lanes)
        return self.captures[k]

    # ------------------------------------------------------------ window

    def step(self) -> dict:
        k = self.frame
        if k + 1 >= self.fleet.frames.shape[0]:
            raise RuntimeError(f"the traffic holds {k} pairs a drive; a longer window needs "
                               f"more (traffic 'pairs')")
        self.k = 0
        t0 = time.perf_counter()
        if self.t_window is None:
            self.t_window = t0
        clean = not self.trace.started
        if clean and t0 - self.t_window >= self.trace_after_s:
            self.trace.start()
            clean = False
            t0 = time.perf_counter()
        T, ret, _ = self.fn(*self._pair(k), self.guess)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if self.trace.active:
            self.trace.stop()
            self.trace.units = self.k
        info = self.fn.last_info
        self.iterations.append(int(info.host_reads))
        if clean:
            self.clean_s += dt
            self.clean_iters += int(info.host_reads)
        self.results.append(T.clone())
        R, t = T[:, :3, :3], T[:, :3, 3]
        Rinv = R.transpose(1, 2)
        self.guess = torch.zeros_like(T)
        self.guess[:, :3, :3] = Rinv
        self.guess[:, :3, 3] = -torch.einsum("bij,bj->bi", Rinv, t)
        self.guess[:, 3, 3] = 1.0
        bad = int(((ret != 0) | ~torch.isfinite(T).all(dim=(1, 2))).sum())
        self.frame = k + 1
        return {"units": int(T.shape[0]), "latency_s": dt, "failed": bad}

    def calibration_steps(self) -> int:
        """Steps that make every capture the checks read: the first frame."""
        return 1

    def counters(self) -> dict:
        B, n = self.fleet.frames.shape[1:3]
        return {"iterations": sum(self.iterations), "frames": len(self.iterations),
                "lanes": int(B), "points": int(n), "K": 32,
                "trace_lanes_built": self.trace_lanes_built, "trace_iterations": self.trace.units,
                "clean_s": self.clean_s, "clean_units": self.clean_iters}

    def release(self):
        for obj, name, old in reversed(self._restore):
            setattr(obj, name, old)
        self._restore = []
        self.fn = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ checks

    def check(self, candidate: str = "program") -> list:
        """The numbers compared, each beside its limit. Each stage is held
        against the reference from the inputs that stage had: the list from
        the frames, pose and lengthscale; the flow from the list; the step
        from the list and the flow's unit twist; the pose update from the
        twist and the step coefficients. `candidate` "control" puts the
        reference computed in TF32 in the package's place (the iteration
        checks only)."""
        import cvo_ref as ref

        f64 = torch.float64
        out = {"list_slots_differing": 0.0, "flow_gap": 0.0, "a_sum_gap": 0.0,
               "nonzeros_gap": 0.0, "step_gap": 0.0, "update_gap": 0.0}
        x_all = self.fleet.frames[self.check_frame]
        y_all = self.fleet.frames[self.check_frame + 1]
        xm = torch.ones(x_all.shape[1], dtype=torch.float32, device=self.dev)
        p = self.pdict
        ctl = candidate == "control"
        for k in sorted(self.captures):
            cap = self.captures[k]
            if cap.R_after is None:
                continue
            lanes = list(range(x_all.shape[0])) if k == 0 else cap.lanes
            for b in lanes:
                R, T, ell = cap.R[b], cap.T[b], cap.ell[b]
                Rinv = R.transpose(0, 1)
                Tinv = -(Rinv @ T[:, None])[:, 0]
                if k == 0:
                    _, slots = ref.candidate_list(p, ell, x_all[b], xm, y_all[b], xm, Rinv, Tinv)
                    if b in cap.lanes:
                        mine = cap.slots[cap.lanes.index(b)]
                        if ctl:
                            _, mine = ref.candidate_list(p, ell, x_all[b], xm, y_all[b], xm,
                                                         Rinv, Tinv, prec="tf32")
                        out["list_slots_differing"] += float(
                            torch.sum(torch.any(mine != slots, dim=0)))
                else:
                    slots = cap.slots[cap.lanes.index(b)]
                joint_p, coeffs_p = cap.joint[b].to(f64), cap.coeffs[b].to(f64)
                unit_p = joint_p / torch.linalg.vector_norm(joint_p)
                m = ref.moments(p, ell, x_all[b], xm, slots, Rinv, Tinv, unit=unit_p)
                R_ref, T_ref = ref.pose_update(p, R, T, joint_p, coeffs_p)
                nz_p, asum_p = float(cap.nz[b]), float(cap.asum[b])
                R_p, T_p = cap.R_after[b].to(f64), cap.T_after[b].to(f64)
                if ctl:
                    mc = ref.moments(p, ell, x_all[b], xm, slots, Rinv, Tinv, prec="tf32",
                                     unit=unit_p)
                    joint_p, coeffs_p = mc.joint, mc.coeffs
                    nz_p, asum_p = float(mc.nonzeros), float(mc.a_sum)
                    R_p, T_p = ref.pose_update(p, R, T, cap.joint[b].to(f64),
                                               cap.coeffs[b].to(f64), prec="tf32")
                out["flow_gap"] = max(out["flow_gap"], _rel(joint_p, m.joint, m.joint_scale))
                out["a_sum_gap"] = max(out["a_sum_gap"], _rel(asum_p, m.a_sum, m.a_sum))
                out["nonzeros_gap"] = max(out["nonzeros_gap"],
                                          _rel(nz_p, m.nonzeros, max(float(m.nonzeros), 1.0)))
                out["step_gap"] = max(out["step_gap"], _rel(coeffs_p, m.coeffs, m.coeff_scale))
                if bool(cap.active[b]):
                    out["update_gap"] = max(
                        out["update_gap"], float((R_p - R_ref).abs().max()),
                        float((T_p - T_ref).abs().max()) / max(1.0, float(T_ref.abs().max())))
        errs = []
        for step, T_rel in enumerate(self.results):
            for b in range(T_rel.shape[0]):
                errs.append(ref.pose_error(T_rel[b].cpu(), self.fleet.T_true[step, b].cpu()))
        checks = [dict(name=n, value=float(v), limit=float(self.limits[n])) for n, v in out.items()]
        if not ctl:
            checks.append(dict(name="pose_err_max", value=max(errs),
                               limit=float(self.limits["pose_err_max"])))
        self.log(f"checked iterations {sorted(self.captures)} of frame {self.check_frame}, "
                 f"lanes {self.check_lanes}; {len(errs)} pairs against the true motion")
        return checks


def _rel(got, want, scale) -> float:
    """max |got - want| / scale, elementwise; where the scale is 0 the gap
    is 0 if the two agree and infinite if not."""
    got, want, scale = (torch.as_tensor(v, dtype=torch.float64).cpu() for v in (got, want, scale))
    gap = (got - want).abs()
    ratio = torch.where(scale > 0, gap / torch.where(scale > 0, scale, 1.0),
                        torch.where(gap == 0, 0.0, math.inf))
    return float(ratio.max())
