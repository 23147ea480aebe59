"""Minimal PCL .pcd reader/writer (ASCII + binary) for xyz[/rgb] clouds (a
copy of unified_cvo_tpu/datasets/pcd.py, kept here so that the port
imports nothing of the JAX package; `load_demo_cloud` builds the port's
PointCloud on `device`).

Replaces the reference's pcl::io::loadPCDFile usage in the demo drivers
(main_cvo_gpu_align_two_color_pcd.cpp:46-53). RGB may be stored as a packed
uint ('U') or packed float ('F') field; both decode to r,g,b in [0,1].
"""

from __future__ import annotations

import numpy as np

from unified_cvo_tpu_torch.utils.pointcloud import PointCloud, make_pointcloud


def _parse_header(lines):
    hdr = {}
    data_start = 0
    for i, line in enumerate(lines):
        s = line.strip()
        if not s or s.startswith("#"):
            continue
        key, _, rest = s.partition(" ")
        hdr[key.upper()] = rest.split()
        if key.upper() == "DATA":
            data_start = i + 1
            break
    return hdr, data_start


def read_pcd(path: str):
    """Returns (xyz [N,3] f32, rgb [N,3] f32 in [0,1] or None)."""
    with open(path, "rb") as f:
        raw = f.read()
    # header is always ASCII
    text_end = raw.find(b"DATA")
    newline = raw.find(b"\n", text_end)
    header_text = raw[: newline + 1].decode("ascii", errors="replace")
    lines = header_text.splitlines()
    hdr, _ = _parse_header(lines)

    fields = [f.lower() for f in hdr["FIELDS"]]
    sizes = [int(s) for s in hdr["SIZE"]]
    types = hdr["TYPE"]
    counts = [int(c) for c in hdr.get("COUNT", ["1"] * len(fields))]
    n_points = int(hdr["POINTS"][0])
    mode = hdr["DATA"][0].lower()

    np_types = {("F", 4): "f4", ("F", 8): "f8", ("U", 4): "u4", ("U", 1): "u1",
                ("U", 2): "u2", ("I", 4): "i4", ("I", 2): "i2", ("I", 1): "i1"}

    if mode == "ascii":
        body = raw[newline + 1 :].decode("ascii")
        rows = np.array(
            [r.split() for r in body.strip().splitlines()[:n_points]], dtype=object
        )
        cols = {}
        ci = 0
        for name, typ, size, count in zip(fields, types, sizes, counts):
            vals = rows[:, ci : ci + count]
            if typ == "F":
                cols[name] = vals.astype(np.float64)
            else:
                cols[name] = vals.astype(np.uint64)
            ci += count
    else:  # binary
        dtype = np.dtype(
            {
                "names": fields,
                "formats": [
                    (np_types[(t, s)], (c,)) if c > 1 else np_types[(t, s)]
                    for t, s, c in zip(types, sizes, counts)
                ],
            }
        )
        arr = np.frombuffer(raw[newline + 1 :], dtype=dtype, count=n_points)
        cols = {name: np.asarray(arr[name]) for name in fields}

    xyz = np.stack(
        [np.asarray(cols["x"], np.float64).ravel(),
         np.asarray(cols["y"], np.float64).ravel(),
         np.asarray(cols["z"], np.float64).ravel()],
        axis=1,
    ).astype(np.float32)

    rgb = None
    if "rgb" in cols or "rgba" in cols:
        v = cols.get("rgb", cols.get("rgba"))
        v = np.asarray(v).ravel()
        if v.dtype.kind == "f":
            packed = v.astype(np.float32).view(np.uint32)
        else:
            packed = v.astype(np.uint32)
        r = (packed >> 16) & 0xFF
        g = (packed >> 8) & 0xFF
        b = packed & 0xFF
        rgb = np.stack([r, g, b], axis=1).astype(np.float32) / 255.0
    return xyz, rgb


def write_pcd(path: str, xyz: np.ndarray, rgb: np.ndarray | None = None):
    """ASCII writer (reference CvoPointCloud::export_to_pcd counterpart)."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n")
        if rgb is not None:
            f.write("FIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F U\nCOUNT 1 1 1 1\n")
        else:
            f.write("FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n")
        f.write(f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA ascii\n")
        if rgb is not None:
            rgb255 = np.clip(np.asarray(rgb) * 255.0, 0, 255).astype(np.uint32)
            packed = (rgb255[:, 0] << 16) | (rgb255[:, 1] << 8) | rgb255[:, 2]
            for p, c in zip(xyz, packed):
                f.write(f"{p[0]} {p[1]} {p[2]} {c}\n")
        else:
            for p in xyz:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")


def load_demo_cloud(path: str, bucket: int = 256, device=None) -> PointCloud:
    """PCD file -> PointCloud with the reference's XYZRGB feature layout:
    features = [r,g,b,0,0]/255 with surface geometric type
    (CvoPointCloud(pcl::PointXYZRGB) ctor, CvoPointCloud.cpp:570-595), on
    `device` (None means the card)."""
    xyz, rgb = read_pcd(path)
    feats = None
    if rgb is not None:
        feats = np.concatenate([rgb, np.zeros((rgb.shape[0], 2), np.float32)], axis=1)
    return make_pointcloud(xyz, features=feats, bucket=bucket, device=device)
