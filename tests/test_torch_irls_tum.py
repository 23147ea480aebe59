"""The port's irls_tum (apps/irls_tum.py) against JAX's on the CPU.

test_e2e_accuracy.py::test_irls_tum_ba_improves_ate's case: 5 of the 9
rendered TUM frames (synth.write_tum_sequence, written once by the port's
PNG writer and read by both packages), its IRLS YAML, its perturbed
initial poses and 7 edges, on the dense backend as in JAX. The port must
meet the test's bounds (ATE after < 0.6 x before and < 0.008 m) and end
within 5e-3 of JAX's poses.

Under pytest the YAML's voxel is 0.6 (under 1024 points a frame; JAX and
the port both end at ATE 0.00223 m from 0.01486): at the test's own 0.25
(about 5100 points) the port's dense moments take some 14 s an outer
iteration on one CPU thread, over 33 iterations, and JAX alone some 90 s,
past the file's time budget. `JAX_PLATFORMS=cpu python
tests/test_torch_irls_tum.py [VOXEL]` runs the case at 0.25 (or VOXEL)
through both packages and prints the ATEs, the gap and the times (about
five minutes on four CPU threads; at 0.25 the port ends at ATE 0.00281 m,
JAX at 0.00285, 2.0e-4 apart).
"""

import sys
import time
from pathlib import Path

if __name__ == "__main__":      # as a script: the repo root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from unified_cvo_tpu.apps import irls_tum as j_irls_tum
from unified_cvo_tpu.datasets import tum as j_tum_ds
from unified_cvo_tpu_torch.apps import irls_tum as t_irls_tum
from unified_cvo_tpu_torch.datasets import tum as t_tum_ds
from unified_cvo_tpu_torch.datasets.graph import write_graph_file
from unified_cvo_tpu_torch.ops import lie as t_lie
from unified_cvo_tpu_torch.utils import synth as t_synth
from unified_cvo_tpu_torch.utils.metrics import ate_rmse

torch.set_num_threads(2)

POSE_TOL = 5e-3
TEST_VOXEL = 0.6
# test_e2e_accuracy.py's IRLS_YAML
IRLS_YAML = """ell_init: 0.1
ell_min: 0.05
sigma: 0.1
sp_thres: 0.003
c: 7.0
d: 7.0
c_ell: 0.025
c_sigma: 1.0
is_using_intensity: 1
is_using_geometric_type: 1
multiframe_max_iters: 60
multiframe_ell_init: 0.4
multiframe_ell_min: 0.1
multiframe_ell_decay_rate: 0.85
multiframe_iterations_per_ell: 10
multiframe_downsample_voxel_size: 0.25
multiframe_iterations_per_solve: 20
multiframe_min_nonzeros: 100
"""


def perturbed(gt, rng, t_sigma=0.03, r_sigma=0.015):
    """test_e2e_accuracy.py's `_perturbed`."""
    init = gt.copy()
    for k in range(1, len(init)):
        init[k, :3, 3] += rng.normal(0, t_sigma, 3)
        w = rng.normal(0, r_sigma, 3)
        th = np.linalg.norm(w)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        dR = np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th**2 * (K @ K)
        init[k, :3, :3] = init[k, :3, :3] @ dR
    return init


def _gap(A, B):
    E = np.linalg.inv(A) @ B
    xi = t_lie.se3_log(torch.from_numpy(E[:3, :3]), torch.from_numpy(E[:3, 3]))
    return float(torch.linalg.vector_norm(xi))


def write_case(d, voxel):
    """test_e2e_accuracy.py's tum_seq, graph and YAML (at `voxel`) under d,
    written by the port. Returns (graph, yaml, ground truth)."""
    calib = t_synth.tum_calibration()
    scene = t_synth.corridor_scene(5, half_width=2.5, floor_y=1.2, ceil_y=-1.2, length=30.0)
    traj = t_synth.corridor_trajectory(9, step=0.08, yaw_rate=0.015, bob=0.005)
    t_synth.write_tum_sequence(d, scene, traj, calib)
    frame_inds = [0, 2, 4, 6, 8]
    gt = traj[frame_inds]
    init = perturbed(gt, np.random.default_rng(1))
    edges = [(0, 1), (1, 2), (2, 3), (3, 4), (0, 2), (1, 3), (2, 4)]
    graph = f"{d}/graph.txt"
    write_graph_file(graph, frame_inds, edges, init)
    yaml = f"{d}/irls.yaml"
    with open(yaml, "w") as f:
        f.write(IRLS_YAML.replace("voxel_size: 0.25", f"voxel_size: {voxel}"))
    return graph, yaml, gt


def run_both(d, graph, yaml, gt):
    """Both packages' irls_tum on the case: (ATE before, port's ATE after,
    JAX's ATE after, largest pose gap, JAX s, port s)."""
    times = []
    for name, main, kw in (("jax", j_irls_tum.main, {}),
                           ("port", t_irls_tum.main,
                            dict(device="cpu", log=lambda *a: None))):
        t = time.perf_counter()
        assert main([d, graph, yaml, f"{d}/{name}"], **kw) == 0
        times.append(time.perf_counter() - t)
    _, before = t_tum_ds.read_tum_trajectory(f"{d}/port_before.txt")
    _, after = t_tum_ds.read_tum_trajectory(f"{d}/port_after.txt")
    _, j_after = j_tum_ds.read_tum_trajectory(f"{d}/jax_after.txt")
    gap = max(_gap(a, b) for a, b in zip(after, j_after))
    return (ate_rmse(gt, before), ate_rmse(gt, after), ate_rmse(gt, j_after), gap,
            *times)


def test_irls_tum_improves_ate_and_matches_jax(tmp_path):
    d = str(tmp_path)
    graph, yaml, gt = write_case(d, TEST_VOXEL)
    ate_before, ate_after, _, gap, _, _ = run_both(d, graph, yaml, gt)
    assert ate_after < 0.6 * ate_before, (ate_before, ate_after)
    assert ate_after < 0.008, f"ATE after BA {ate_after:.4f} m"
    assert gap < POSE_TOL, gap


if __name__ == "__main__":
    import tempfile

    torch.set_num_threads(4)
    voxel = float(sys.argv[1]) if len(sys.argv) > 1 else 0.25
    with tempfile.TemporaryDirectory() as d:
        out = run_both(d, *write_case(d, voxel))
    print(f"voxel {voxel}: ATE before {out[0]:.6f} m, port after {out[1]:.6f}, "
          f"JAX after {out[2]:.6f}, largest pose gap {out[3]:.3e}; "
          f"JAX {out[4]:.1f} s, port {out[5]:.1f} s")
