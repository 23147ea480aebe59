"""Synthetic textured-scene renderer for end-to-end accuracy evaluation.

The reference validates accuracy only offline, on real KITTI/TUM data that
is not bundled (SURVEY.md §6; devkit/cpp/evaluate_odometry.cpp). This module
closes that loop hermetically: it ray-casts a textured corridor scene into
geometrically-consistent stereo pairs and RGB-D frames along a known
trajectory, written in the exact KITTI / TUM on-disk layouts the dataset
handlers read — so the odometry and BA drivers run UNMODIFIED and their
output trajectories can be scored against ground truth with
utils/metrics (kitti_seq_error / ate_rmse), the devkit twins.

Geometry conventions match the front-end (frontend/stereo.py):
camera frame x right / y down / z forward; right stereo camera at
+baseline along camera x; disparity = fx * baseline / depth;
TUM depth pngs are uint16 depth * depth_scale.

A copy of unified_cvo_tpu/utils/synth.py (numpy), kept here so that the port
imports nothing of the JAX package, with two changes so that scenes render
and write on a host without OpenCV: the texture's bilinear upsampling is
numpy (`_resize_linear`, cv2.resize's INTER_LINEAR rule), and the PNG
writers go through the port's own encoder (`datasets/png.py`; cv2.imread
reads back the same bytes). The lidar writers also take
the scan's elevations (`fov_deg`), and the KITTI one can write height-band
SemanticKITTI labels (`lidar_height_labels`); their defaults write what
JAX's do.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from unified_cvo_tpu_torch.datasets import png
from unified_cvo_tpu_torch.frontend.calibration import Calibration


@dataclasses.dataclass
class Plane:
    """Axis-aligned textured plane: {x[axis] == offset}, visible from the
    `side` sign of the axis, textured over the two `tangent` axes."""

    axis: int
    offset: float
    tangent: Tuple[int, int]
    texture: np.ndarray            # [th, tw, 3] float32 in [0, 255]
    tex_scale: float               # metres per texel
    bounds: Tuple[Tuple[float, float], Tuple[float, float]]  # per tangent axis


def _texture(th: int, tw: int, rng: np.random.Generator) -> np.ndarray:
    """Multi-scale smooth noise texture: coarse colour blocks for appearance
    variety + fine structure for FAST corners and stereo matching. Values
    float32 in [0,255]; bilinear-sampled, so image gradients stay smooth at
    sub-texel camera motion (what subpixel stereo needs)."""
    img = np.zeros((th, tw, 3), np.float32)
    for cell, amp in ((64, 55.0), (16, 40.0), (4, 30.0)):
        noise = rng.uniform(-1.0, 1.0, (th // cell, tw // cell, 3)).astype(np.float32)
        img += amp * _resize_linear(noise, tw, th)
    return np.clip(img + 128.0, 0.0, 255.0)


def _linear_taps(dst: int, src: int):
    """cv2.resize's INTER_LINEAR taps along one axis: source coordinate
    (dst + 0.5) * src / dst - 0.5 in float32, clamped at the first and the
    last texel (weight 0 on the second tap there)."""
    f = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    w = (f - i0).astype(np.float32)
    out = (i0 < 0) | (i0 >= src - 1)
    w[out] = 0.0
    i0 = np.clip(i0, 0, src - 1)
    return i0, np.minimum(i0 + 1, src - 1), w


def _resize_linear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """[sh, sw, C] float32 -> [h, w, C], bilinear as cv2.resize(img, (w, h),
    interpolation=cv2.INTER_LINEAR) computes it: rows first, then columns."""
    x0, x1, wx = _linear_taps(w, img.shape[1])
    y0, y1, wy = _linear_taps(h, img.shape[0])
    wx, wy = wx[None, :, None], wy[:, None, None]
    rows = img[:, x0] * (np.float32(1.0) - wx) + img[:, x1] * wx
    return rows[y0] * (np.float32(1.0) - wy) + rows[y1] * wy


def _sample_bilinear(tex: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Wrap-around bilinear texture fetch. x,y in texel units, any shape."""
    th, tw = tex.shape[:2]
    x = np.mod(x, tw)
    y = np.mod(y, th)
    # mod(-eps, tw) rounds to exactly tw for tiny negative inputs — take
    # the index modulo AFTER the floor so x0/y0 always land in range
    x0 = np.floor(x).astype(np.int64) % tw
    y0 = np.floor(y).astype(np.int64) % th
    fx = (x - np.floor(x))[..., None]
    fy = (y - np.floor(y))[..., None]
    x1 = (x0 + 1) % tw
    y1 = (y0 + 1) % th
    c00 = tex[y0, x0]
    c01 = tex[y0, x1]
    c10 = tex[y1, x0]
    c11 = tex[y1, x1]
    return (c00 * (1 - fx) * (1 - fy) + c01 * fx * (1 - fy)
            + c10 * (1 - fx) * fy + c11 * fx * fy)


def corridor_scene(seed: int = 0, length: float = 60.0,
                   half_width: float = 4.0, floor_y: float = 1.6,
                   ceil_y: float = -2.2, tex_scale: float = 0.04) -> List[Plane]:
    """A closed textured corridor along +z: floor, ceiling, two side walls,
    and a far end wall. Every forward ray hits exactly one surface."""
    rng = np.random.default_rng(seed)
    z_lo, z_hi = -10.0, length
    t = lambda: _texture(512, 512, rng)
    return [
        Plane(1, floor_y, (0, 2), t(), tex_scale, ((-half_width, half_width), (z_lo, z_hi))),
        Plane(1, ceil_y, (0, 2), t(), tex_scale, ((-half_width, half_width), (z_lo, z_hi))),
        Plane(0, -half_width, (1, 2), t(), tex_scale, ((ceil_y, floor_y), (z_lo, z_hi))),
        Plane(0, half_width, (1, 2), t(), tex_scale, ((ceil_y, floor_y), (z_lo, z_hi))),
        Plane(2, length, (0, 1), t(), tex_scale, ((-half_width, half_width), (ceil_y, floor_y))),
    ]


def _box_occluder(center: np.ndarray, half: np.ndarray,
                  rng: np.random.Generator,
                  tex_scale: float = 0.04) -> List[Plane]:
    """Axis-aligned textured box (pillar/crate): six bounded planes. The
    renderer keeps the nearest hit, so boxes OCCLUDE the room behind them —
    the occlusion / parallax stressor VERDICT r3 task 7 asks for."""
    planes = []
    t = lambda: _texture(256, 256, rng)
    for axis in range(3):
        ta, tb = [a for a in range(3) if a != axis]
        bounds = ((center[ta] - half[ta], center[ta] + half[ta]),
                  (center[tb] - half[tb], center[tb] + half[tb]))
        for sgn in (-1.0, 1.0):
            planes.append(Plane(axis, float(center[axis] + sgn * half[axis]),
                                (ta, tb), t(), tex_scale, bounds))
    return planes


def room_scene(seed: int = 0, half: float = 6.0, floor_y: float = 1.6,
               ceil_y: float = -2.2, tex_scale: float = 0.04,
               n_pillars: int = 3) -> List[Plane]:
    """A closed textured square room with free-standing pillar occluders —
    the loop-closure scene (a circular trajectory inside it re-observes the
    start, and the pillars create occlusion boundaries and parallax)."""
    rng = np.random.default_rng(seed)
    t = lambda: _texture(512, 512, rng)
    planes = [
        Plane(1, floor_y, (0, 2), t(), tex_scale, ((-half, half), (-half, half))),
        Plane(1, ceil_y, (0, 2), t(), tex_scale, ((-half, half), (-half, half))),
        Plane(0, -half, (1, 2), t(), tex_scale, ((ceil_y, floor_y), (-half, half))),
        Plane(0, half, (1, 2), t(), tex_scale, ((ceil_y, floor_y), (-half, half))),
        Plane(2, -half, (0, 1), t(), tex_scale, ((-half, half), (ceil_y, floor_y))),
        Plane(2, half, (0, 1), t(), tex_scale, ((-half, half), (ceil_y, floor_y))),
    ]
    for p in range(n_pillars):
        ang = 2.0 * np.pi * p / max(n_pillars, 1) + 0.5
        r = half * 0.55
        c = np.array([r * np.cos(ang), (floor_y + ceil_y) / 2.0,
                      r * np.sin(ang)])
        planes += _box_occluder(
            c, np.array([0.35, (floor_y - ceil_y) / 2.0, 0.35]), rng,
            tex_scale)
    return planes


def loop_trajectory(n_frames: int, radius: float = 2.5,
                    bob: float = 0.01) -> np.ndarray:
    """[N,4,4] camera-to-world poses on a full circle, camera facing along
    the tangent — the final pose re-observes the first frame's view (the
    loop-closure fixture; 50+ frames exercises long-sequence drift)."""
    poses = np.tile(np.eye(4, dtype=np.float64), (n_frames, 1, 1))
    for i in range(n_frames):
        theta = 2.0 * np.pi * i / n_frames
        c, s = np.cos(theta), np.sin(theta)
        # position on the circle; forward (camera z) along the tangent
        pos = np.array([radius * c, bob * np.sin(0.9 * i), radius * s])
        fwd = np.array([-s, 0.0, c])
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        poses[i, :3, 0] = right
        poses[i, :3, 1] = up
        poses[i, :3, 2] = fwd
        poses[i, :3, 3] = pos
    return poses


def corridor_trajectory(n_frames: int, step: float = 0.3,
                        yaw_rate: float = 0.01, bob: float = 0.01) -> np.ndarray:
    """[N,4,4] camera-to-world poses: forward motion with a slow yaw turn
    and a small vertical bob (so rotation and y-translation are exercised,
    not just z)."""
    poses = np.tile(np.eye(4, dtype=np.float64), (n_frames, 1, 1))
    pos = np.zeros(3)
    for i in range(n_frames):
        theta = yaw_rate * i
        c, s = np.cos(theta), np.sin(theta)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        poses[i, :3, :3] = R
        poses[i, :3, 3] = pos + np.array([0.0, bob * np.sin(0.7 * i), 0.0])
        pos = pos + step * np.array([s, 0.0, c])
    return poses


def render_frame(scene: Sequence[Plane], calib: Calibration,
                 T_wc: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Ray-cast one frame. Returns (bgr uint8 [H,W,3], depth float32 [H,W]
    = camera-frame z; 0 where no surface is hit)."""
    H, W = calib.rows, calib.cols
    Kinv = np.linalg.inv(calib.intrinsic).astype(np.float64)
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    # camera-frame directions with z == 1, so the ray parameter IS depth
    d_cam = np.stack([u, v, np.ones_like(u)], axis=-1) @ Kinv.T
    R_wc = T_wc[:3, :3]
    o = T_wc[:3, 3]
    d_world = d_cam @ R_wc.T

    best_t = np.full((H, W), np.inf)
    color = np.zeros((H, W, 3), np.float32)
    for pl in scene:
        denom = d_world[..., pl.axis]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (pl.offset - o[pl.axis]) / denom
            t = np.where(np.abs(denom) > 1e-12, t, np.inf)
            t = np.where(t > 0.2, t, np.inf)
            hit_a = o[pl.tangent[0]] + t * d_world[..., pl.tangent[0]]
            hit_b = o[pl.tangent[1]] + t * d_world[..., pl.tangent[1]]
        (a_lo, a_hi), (b_lo, b_hi) = pl.bounds
        ok = ((t < best_t) & (hit_a >= a_lo) & (hit_a <= a_hi)
              & (hit_b >= b_lo) & (hit_b <= b_hi))
        if not ok.any():
            continue
        texel = _sample_bilinear(
            pl.texture, hit_a[ok] / pl.tex_scale, hit_b[ok] / pl.tex_scale)
        color[ok] = texel
        best_t = np.where(ok, t, best_t)
    depth = np.where(np.isfinite(best_t), best_t, 0.0).astype(np.float32)
    return np.clip(color, 0, 255).astype(np.uint8), depth


def render_stereo(scene: Sequence[Plane], calib: Calibration,
                  T_wc: np.ndarray):
    """(left_bgr, right_bgr, left_depth). Right camera at +baseline along
    camera x (KITTI convention; frontend/stereo.py backproject_disparity)."""
    left, depth = render_frame(scene, calib, T_wc)
    T_right = T_wc.copy()
    T_right[:3, 3] = T_wc[:3, 3] + T_wc[:3, 0] * abs(calib.baseline)
    right, _ = render_frame(scene, calib, T_right)
    return left, right, depth


def render_lidar_scan(scene: Sequence[Plane], T_wl: np.ndarray,
                      n_beams: int = 32, n_az: int = 900,
                      fov_deg: Tuple[float, float] = (-20.0, 8.0),
                      max_range: float = 60.0,
                      noise: float = 0.0,
                      seed: int = 0,
                      velodyne_sweep: bool = False) -> np.ndarray:
    """Ray-cast one spherical lidar scan. Returns [N,4] (xyz in the SENSOR
    frame — same camera-style axes as render_frame: x right / y down /
    z forward — plus intensity sampled from the hit surface's texture).
    Rays with no hit within max_range are dropped.

    The velodyne-style beam lattice: n_beams elevation rings over fov_deg
    (degrees, camera-y-down convention: negative = up) x n_az azimuth
    steps around the y axis. Each beam sweeps azimuth from -pi, so its
    quadrants (frontend/lidar.py::ring_ids) run 2, 1, 4, 3 and ring_ids
    finds one ring; `velodyne_sweep` (the port's addition) sweeps the other
    way, as a velodyne does: 3, 4, 1, 2, a 4 -> 1 wrap in every beam."""
    rng = np.random.default_rng(seed)
    el = np.deg2rad(np.linspace(fov_deg[0], fov_deg[1], n_beams))
    az = np.linspace(-np.pi, np.pi, n_az, endpoint=False)
    if velodyne_sweep:
        az = az[::-1]
    azg, elg = np.meshgrid(az, el)
    # sensor-frame directions: azimuth about +y (down), elevation toward +y
    d_sens = np.stack([
        np.cos(elg) * np.sin(azg),
        np.sin(elg),
        np.cos(elg) * np.cos(azg),
    ], axis=-1).reshape(-1, 3)
    R_wl = T_wl[:3, :3]
    o = T_wl[:3, 3]
    d_world = d_sens @ R_wl.T

    best_t = np.full(len(d_sens), np.inf)
    inten = np.zeros(len(d_sens), np.float32)
    for pl in scene:
        denom = d_world[:, pl.axis]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (pl.offset - o[pl.axis]) / denom
            t = np.where(np.abs(denom) > 1e-12, t, np.inf)
            t = np.where(t > 0.2, t, np.inf)
            hit_a = o[pl.tangent[0]] + t * d_world[:, pl.tangent[0]]
            hit_b = o[pl.tangent[1]] + t * d_world[:, pl.tangent[1]]
        (a_lo, a_hi), (b_lo, b_hi) = pl.bounds
        ok = ((t < best_t) & (hit_a >= a_lo) & (hit_a <= a_hi)
              & (hit_b >= b_lo) & (hit_b <= b_hi))
        if not ok.any():
            continue
        texel = _sample_bilinear(
            pl.texture, hit_a[ok] / pl.tex_scale, hit_b[ok] / pl.tex_scale)
        inten[ok] = texel.mean(-1).astype(np.float32) / 255.0
        best_t = np.where(ok, t, best_t)
    hit = np.isfinite(best_t) & (best_t < max_range)
    pts = d_sens[hit] * best_t[hit, None]
    if noise > 0:
        pts = pts + rng.normal(0, noise, pts.shape)
    return np.concatenate([pts.astype(np.float32),
                           inten[hit, None]], axis=1)


# SemanticKITTI raw ids of lidar_height_labels' bands (the reader maps them
# to training classes 8, 14 and 12; raw 0 is unlabeled and dropped)
ROAD, VEGETATION, BUILDING, UNLABELED = 40, 70, 50, 0


def lidar_height_labels(scan: np.ndarray) -> np.ndarray:
    """SemanticKITTI raw labels (uint32, instance id 0) of a rendered scan
    from a fixed rule on each point's height in the sensor frame (y down):
    more than 1.5 m below the sensor road, more than 2.7 m above it
    unlabeled, within 0.5 m of its height vegetation, building otherwise."""
    y = scan[:, 1]
    out = np.full(len(scan), BUILDING, np.uint32)
    out[np.abs(y) < 0.5] = VEGETATION
    out[y > 1.5] = ROAD
    out[y < -2.7] = UNLABELED
    return out


def write_kitti_lidar_sequence(out_dir: str, scene: Sequence[Plane],
                               trajectory: np.ndarray,
                               n_beams: int = 32, n_az: int = 900,
                               noise: float = 0.0,
                               fov_deg: Tuple[float, float] = (-20.0, 8.0),
                               labels: bool = False,
                               velodyne_sweep: bool = False) -> np.ndarray:
    """Render + write <out_dir>/velodyne/%06d.bin in the KITTI raw-velodyne
    frame (the KittiHandler reader rotates x<- -y, y<- -z, z<- x into the
    camera-style frame, datasets/kitti.py:100-117 — the inverse map is
    velo = (z_cam, -x_cam, -y_cam)). With `labels`, also
    <out_dir>/labels/%06d.label from lidar_height_labels (the port's
    addition, like `fov_deg` and `velodyne_sweep`, render_lidar_scan's)."""
    os.makedirs(os.path.join(out_dir, "velodyne"), exist_ok=True)
    if labels:
        os.makedirs(os.path.join(out_dir, "labels"), exist_ok=True)
    for i, T in enumerate(trajectory):
        scan = render_lidar_scan(scene, T, n_beams=n_beams, n_az=n_az,
                                 fov_deg=fov_deg, noise=noise, seed=i,
                                 velodyne_sweep=velodyne_sweep)
        velo = np.stack([scan[:, 2], -scan[:, 0], -scan[:, 1], scan[:, 3]],
                        axis=1).astype(np.float32)
        velo.tofile(os.path.join(out_dir, "velodyne", f"{i:06d}.bin"))
        if labels:
            lidar_height_labels(scan).tofile(
                os.path.join(out_dir, "labels", f"{i:06d}.label"))
    return trajectory.copy()


def write_lyft_lidar_sequence(out_dir: str, scene: Sequence[Plane],
                              trajectory: np.ndarray,
                              n_beams: int = 40, n_az: int = 900,
                              noise: float = 0.0,
                              fov_deg: Tuple[float, float] = (-20.0, 8.0)) -> np.ndarray:
    """Render + write the Lyft L5 lidar layout (<out_dir>/lidar/*.bin,
    5 float32 per point: raw-frame x y z + intensity + ring;
    datasets/lyft.py applies the same axis rotation as KITTI)."""
    os.makedirs(os.path.join(out_dir, "lidar"), exist_ok=True)
    for i, T in enumerate(trajectory):
        scan = render_lidar_scan(scene, T, n_beams=n_beams, n_az=n_az,
                                 fov_deg=fov_deg, noise=noise, seed=i)
        n = len(scan)
        ring = np.zeros((n, 1), np.float32)
        velo = np.concatenate(
            [np.stack([scan[:, 2], -scan[:, 0], -scan[:, 1]], axis=1),
             scan[:, 3:4], ring], axis=1).astype(np.float32)
        velo.tofile(os.path.join(out_dir, "lidar", f"{i:06d}.bin"))
    return trajectory.copy()


def gt_disparity(depth: np.ndarray, calib: Calibration) -> np.ndarray:
    """Ground-truth left disparity from rendered depth (0 where invalid)."""
    with np.errstate(divide="ignore"):
        d = abs(calib.baseline) * calib.fx / depth
    return np.where(depth > 0, d, 0.0).astype(np.float32)


def kitti_calibration(W: int = 512, H: int = 320, fx: float = 256.0,
                      baseline: float = 0.54) -> Calibration:
    K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]], np.float32)
    return Calibration(K, baseline=baseline, depth_scale=1.0, cols=W, rows=H)


def tum_calibration(W: int = 320, H: int = 240, fx: float = 250.0,
                    depth_scale: float = 5000.0) -> Calibration:
    K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]], np.float32)
    return Calibration(K, baseline=0.0, depth_scale=depth_scale, cols=W, rows=H)


def write_kitti_sequence(out_dir: str, scene: Sequence[Plane],
                         trajectory: np.ndarray, calib: Calibration,
                         depths_out: Optional[list] = None) -> np.ndarray:
    """Render + write <out_dir>/{image_2,image_3}/%06d.png + cvo_calib.txt
    (the KittiHandler layout, datasets/kitti.py). Returns the ground-truth
    camera-to-world poses [N,4,4]."""
    os.makedirs(os.path.join(out_dir, "image_2"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "image_3"), exist_ok=True)
    with open(os.path.join(out_dir, "cvo_calib.txt"), "w") as f:
        f.write(f"{calib.fx} {calib.fy} {calib.cx} {calib.cy} "
                f"{abs(calib.baseline)} {calib.cols} {calib.rows}\n")
    for i, T in enumerate(trajectory):
        left, right, depth = render_stereo(scene, calib, T)
        png.imwrite(os.path.join(out_dir, "image_2", f"{i:06d}.png"), left)
        png.imwrite(os.path.join(out_dir, "image_3", f"{i:06d}.png"), right)
        if depths_out is not None:
            depths_out.append(depth)
    return trajectory.copy()


def tum_frames(scene: Sequence[Plane], trajectory: np.ndarray, calib: Calibration,
               depth_noise: float = 0.0, seed: int = 0):
    """Render the frames write_tum_sequence writes, in memory: yields (bgr
    uint8, depth uint16 at depth_scale, timestamp string) per pose, the
    same noise draws in the same order.

    depth_noise: per-pixel Gaussian sigma in metres added to the rendered
    depth (sensor-noise stressor)."""
    rng = np.random.default_rng(seed)
    for i, T in enumerate(trajectory):
        bgr, depth = render_frame(scene, calib, T)
        if depth_noise > 0:
            depth = np.where(
                depth > 0,
                depth + rng.normal(0, depth_noise, depth.shape).astype(np.float32),
                depth)
        d16 = np.clip(depth * calib.depth_scale, 0, 65535).astype(np.uint16)
        yield bgr, d16, f"{1000.0 + 0.1 * i:.4f}"


def write_tum_sequence(out_dir: str, scene: Sequence[Plane],
                       trajectory: np.ndarray, calib: Calibration,
                       depth_noise: float = 0.0,
                       seed: int = 0) -> np.ndarray:
    """Render + write <out_dir>/{rgb,depth}/*.png, assoc.txt, cvo_calib.txt
    (the TumHandler layout, datasets/tum.py) from `tum_frames`. Returns
    ground truth poses."""
    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    with open(os.path.join(out_dir, "cvo_calib.txt"), "w") as f:
        f.write(f"{calib.fx} {calib.fy} {calib.cx} {calib.cy} "
                f"{calib.depth_scale} {calib.cols} {calib.rows}\n")
    with open(os.path.join(out_dir, "assoc.txt"), "w") as assoc:
        for bgr, d16, ts in tum_frames(scene, trajectory, calib, depth_noise, seed):
            png.imwrite(os.path.join(out_dir, "rgb", f"{ts}.png"), bgr)
            png.imwrite(os.path.join(out_dir, "depth", f"{ts}.png"), d16)
            assoc.write(f"{ts} rgb/{ts}.png {ts} depth/{ts}.png\n")
    return trajectory.copy()


def write_tartan_sequence(out_dir: str, scene: Sequence[Plane],
                          trajectory: np.ndarray) -> np.ndarray:
    """Render + write the TartanAir on-disk layout
    (<out_dir>/image_left/NNNNNN_left.png +
    depth_left/NNNNNN_left_depth.npy, datasets/tartanair.py) at the
    handler's fixed 640x480 fx=320 intrinsics."""
    from unified_cvo_tpu_torch.datasets.tartanair import TARTANAIR_K

    calib = Calibration(TARTANAIR_K.copy(), depth_scale=1.0,
                        cols=640, rows=480)
    os.makedirs(os.path.join(out_dir, "image_left"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth_left"), exist_ok=True)
    for i, T in enumerate(trajectory):
        bgr, depth = render_frame(scene, calib, T)
        png.imwrite(os.path.join(out_dir, "image_left", f"{i:06d}_left.png"),
                    bgr)
        np.save(os.path.join(out_dir, "depth_left",
                             f"{i:06d}_left_depth.npy"),
                depth.astype(np.float32))
    return trajectory.copy()
