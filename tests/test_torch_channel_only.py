"""The channel-only pair (KITTI_COLOR_BENCH without geometry: a scan list
ranked by the colour kernel, built once, and the channel-only flow and
step passes) through the port's align and JAX align on the CPU, on the
same frames of the bench sequence, the same guess and the same settings
(`backend='ell'`, `nl_builder='scan'`, `max_iter=50`): the configuration
`chip_smoke.py` phase 3d drives on the card at 16384 points.

The test runs the pair at 2048 points; the poses must agree within the
North star's |log dT| < 5e-3, the two packages build one list each, drop
the same number of candidates and run the same number of iterations.

Run as a script for the full size, 16384 points (a few minutes on the CPU):

    JAX_PLATFORMS=cpu python tests/test_torch_channel_only.py [--points 16384]

It prints each package's pose error against the true pose and the gap
between the two poses.
"""

import dataclasses
import sys
import time
from pathlib import Path

if __name__ == "__main__":      # as a script: the repo root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax.numpy as jnp
import numpy as np
import torch

from unified_cvo_tpu.config import CvoParams as JaxParams
from unified_cvo_tpu.models.align import align as j_align
from unified_cvo_tpu.utils.pointcloud import make_pointcloud as j_make
from unified_cvo_tpu_torch.apps import f2f_sequence as f2f
from unified_cvo_tpu_torch.config import KITTI_COLOR_BENCH
from unified_cvo_tpu_torch.models.align import align as t_align
from unified_cvo_tpu_torch.ops import lie as t_lie
from unified_cvo_tpu_torch.utils.pointcloud import make_pointcloud as t_make

POSE_TOL = 5e-3
MAX_ITER = 50


def _log_norm(T):
    T = torch.as_tensor(np.asarray(T, np.float32))
    return float(torch.linalg.vector_norm(t_lie.se3_log(T[:3, :3], T[:3, 3])))


def channel_only_pair(n: int):
    """Frames 0 -> 1 of the colour bench sequence at n points through both
    aligners. Returns (T_jax, info_jax, T_port, info_port, T_true)."""
    frames, T_true, feats = f2f.make_sequence(n, 1, features=True)
    guess = f2f.initial_guess()
    params = KITTI_COLOR_BENCH.replace(is_using_geometry=0)
    kw = dict(backend="ell", nl_builder="scan", max_iter=MAX_ITER)
    jp = JaxParams(**dataclasses.asdict(params))
    T_j, _, info_j = j_align(j_make(frames[0], features=feats, bucket=n),
                             j_make(frames[1], features=feats, bucket=n),
                             jnp.asarray(guess), jp, **kw)
    T_t, _, info_t = t_align(t_make(frames[0], features=feats, bucket=n, device="cpu"),
                             t_make(frames[1], features=feats, bucket=n, device="cpu"),
                             guess, params, device="cpu", **kw)
    return np.asarray(T_j), info_j, T_t.numpy(), info_t, T_true[0]


def test_channel_only_pair_matches_jax():
    T_j, info_j, T_t, info_t, T_true = channel_only_pair(2048)
    assert (info_t.backend, info_t.nl_builder) == ("ell", "scan")
    assert info_t.nl_rebuilds == int(info_j.nl_rebuilds) == 1
    assert int(info_t.nl_overflow) == int(info_j.nl_overflow)
    assert info_t.iterations == int(info_j.iterations)
    gap = _log_norm(np.asarray(T_j, np.float64) @ np.linalg.inv(np.asarray(T_t, np.float64)))
    assert gap < POSE_TOL, f"port and JAX poses {gap} apart"
    err_j, err_t = _log_norm(T_j @ T_true), _log_norm(T_t @ T_true)
    assert abs(err_j - err_t) < POSE_TOL


def main(argv):
    n = int(argv[argv.index("--points") + 1]) if "--points" in argv else 16384
    torch.set_num_threads(4)
    t0 = time.perf_counter()
    T_j, info_j, T_t, info_t, T_true = channel_only_pair(n)
    gap = _log_norm(np.asarray(T_j, np.float64) @ np.linalg.inv(np.asarray(T_t, np.float64)))
    print(f"channel-only pair, {n} points, max_iter {MAX_ITER}, CPU, "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"  JAX : pose error {_log_norm(T_j @ T_true):.6f}, iterations "
          f"{int(info_j.iterations)}, builds {int(info_j.nl_rebuilds)}, overflow "
          f"{int(info_j.nl_overflow)}")
    print(f"  port: pose error {_log_norm(T_t @ T_true):.6f}, iterations "
          f"{info_t.iterations}, builds {info_t.nl_rebuilds}, overflow "
          f"{int(info_t.nl_overflow)}")
    print(f"  |log(T_jax T_port^-1)| = {gap:.6g} (tolerance {POSE_TOL})")
    return 0 if gap < POSE_TOL else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
