"""Offline visualization — the stack_pcd_viewer / traj_playback twins (port
of unified_cvo_tpu/apps/viewer.py).

The reference ships Qt/PCL viewers (thirdparty/cugicp/viewer, CMake targets
stack_pcd_viewer / ellipse_viewer / traj_playback); headless matplotlib
renders serve the same inspection purpose here. Plotting is host work and
runs on no device. matplotlib (Agg) is imported inside the functions, so
the module imports where matplotlib is absent; there the functions raise
ImportError naming it.

Usage:
    python -m unified_cvo_tpu_torch.apps.viewer traj OUT.png TRAJ1.txt [TRAJ2.txt ...]
    python -m unified_cvo_tpu_torch.apps.viewer pcd OUT.png CLOUD1.pcd [CLOUD2.pcd ...]
"""

from __future__ import annotations

import sys

from unified_cvo_tpu_torch.datasets.kitti import read_kitti_poses
from unified_cvo_tpu_torch.datasets.pcd import read_pcd


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("apps/viewer.py needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectories(out_path: str, traj_paths, labels=None):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 8))
    for i, p in enumerate(traj_paths):
        poses = read_kitti_poses(p)
        t = poses[:, :3, 3]
        label = labels[i] if labels else p
        ax.plot(t[:, 0], t[:, 2], label=label, linewidth=1.2)
        ax.scatter([t[0, 0]], [t[0, 2]], marker="o", s=30)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_pcds(out_path: str, pcd_paths):
    plt = _pyplot()
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(projection="3d")
    palette = ["tab:blue", "tab:orange", "tab:green", "tab:red"]
    for i, p in enumerate(pcd_paths):
        xyz, rgb = read_pcd(p)
        c = rgb if rgb is not None else palette[i % len(palette)]
        ax.scatter(xyz[:, 0], xyz[:, 1], xyz[:, 2], s=1.5, c=c, label=p)
    ax.legend(fontsize=7)
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return out_path


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        print(__doc__)
        return 1
    mode, out = argv[0], argv[1]
    if mode == "traj":
        plot_trajectories(out, argv[2:])
    elif mode == "pcd":
        plot_pcds(out, argv[2:])
    else:
        print(__doc__)
        return 1
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
