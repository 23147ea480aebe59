"""The installed cv2's StereoSGBM against the map the port's emulation is
held to, on chip_smoke.py phase 15e's frame (1241 x 376, D 128).

JAX's compute_disparity(backend="auto") calls cv2.StereoSGBM wherever cv2
imports, and the port's "auto" then runs ops/sgbm_opencv.py::sgbm_3way, an
emulation of one OpenCV (chip_smoke.SGBM_MAP_SHA256 is its map's digest).
This script asks whether the cv2 installed here gives that map: cv2's
BGR2GRAY against OpenCV 4's fixed-point grey, cv2's int16 map's digest
against SGBM_MAP_SHA256 and pixel by pixel against the port's map, and
JAX's "auto" float map (cv2's grey, StereoSGBM, / 16) against the port's
compute_disparity(backend="auto"). Needs cv2, no JAX; the port runs on the
card where there is one. Prints one JSON line; exits 1 if a map differs.

    python3 tests/torch_sgbm_cv2_probe.py
"""

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import cv2  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from unified_cvo_tpu_torch.frontend import stereo  # noqa: E402
from unified_cvo_tpu_torch.ops import sgbm_opencv as sg  # noqa: E402

CV_NAMES = dict(min_disparity="minDisparity", num_disparities="numDisparities",
                block_size="blockSize", p1="P1", p2="P2", disp12_max_diff="disp12MaxDiff",
                uniqueness_ratio="uniquenessRatio", speckle_window_size="speckleWindowSize",
                speckle_range="speckleRange", pre_filter_cap="preFilterCap")


def opencv4_gray(img):
    """OpenCV 4's BGR2GRAY: (1868 B + 9617 G + 4899 R + 8192) >> 14."""
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    return ((1868 * b + 9617 * g + 4899 * r + 8192) >> 14).astype(np.uint8)


def cv2_sgbm(left, right, kw):
    m = cv2.StereoSGBM_create(**{CV_NAMES[k]: v for k, v in kw.items()},
                              mode=cv2.STEREO_SGBM_MODE_SGBM_3WAY)
    return m.compute(left, right)


def main() -> int:
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    _, frames, _ = chip_smoke.stereo_frames()
    left, right = frames[0]
    kw = stereo.opencv_settings(128)
    gl, gr = opencv4_gray(left), opencv4_gray(right)
    cl, cr = (cv2.cvtColor(im, cv2.COLOR_BGR2GRAY) for im in (left, right))
    want = cv2_sgbm(gl, gr, kw)
    port = sg.sgbm_3way(torch.from_numpy(gl).to(dev), torch.from_numpy(gr).to(dev),
                        **kw).cpu().numpy()
    jax_auto = cv2_sgbm(cl, cr, kw).astype(np.float32) / 16.0
    port_auto = stereo.compute_disparity(torch.from_numpy(left).to(dev),
                                         torch.from_numpy(right).to(dev)).cpu().numpy()
    digest = hashlib.sha256(want.astype("<i2").tobytes()).hexdigest()
    out = {"cv2": cv2.__version__, "device": str(dev), "auto_backend": stereo.auto_backend(),
           "input_digest_equal": hashlib.sha256(left.tobytes() + right.tobytes()).hexdigest()
           == chip_smoke.SGBM_INPUT_SHA256,
           "gray_equal_opencv4": bool(np.array_equal(cl, gl) and np.array_equal(cr, gr)),
           "map_digest": digest, "map_digest_equal": digest == chip_smoke.SGBM_MAP_SHA256,
           "map_pixels_differing_from_port": int((port != want).sum()),
           "auto_pixels_differing_from_port": int((port_auto != jax_auto).sum()),
           "pixels": int(want.size)}
    print(json.dumps(out), flush=True)
    return 0 if out["map_digest_equal"] and out["auto_pixels_differing_from_port"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
