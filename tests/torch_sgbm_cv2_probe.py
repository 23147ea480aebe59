"""The installed cv2's BGR2GRAY and StereoSGBM against what the port's host
frontend computes, on all 2^24 colours and on chip_smoke.py phase 15e's
frame (1241 x 376, D 128).

JAX's host frontend converts colour with cv2.cvtColor(BGR2GRAY), which the
port computes as frontend/image.py::opencv_gray (the 15-bit rule (3735 B +
19235 G + 9798 R + 16384) >> 15); JAX's compute_disparity(backend="auto")
calls cv2.StereoSGBM wherever cv2 imports, and the port's "auto" then runs
ops/sgbm_opencv.py::sgbm_3way, an emulation of one OpenCV
(chip_smoke.SGBM_MAP_SHA256 is its map's digest). This script asks whether
the cv2 installed here agrees: its BGR2GRAY over all 2^24 colours (one 4096
x 4096 image) against the 15-bit rule and against the device frontends'
14-bit rule (1868 B + 9617 G + 4899 R + 8192) >> 14 (colours differing from
each), cv2's int16 map of its own grey of the frame (digest against
SGBM_MAP_SHA256, pixel by pixel against the port's map), and JAX's "auto"
float map (cv2's grey, StereoSGBM, / 16) against the port's
compute_disparity(backend="auto"). Needs cv2, no JAX; the port runs on the
card where there is one. Prints one JSON line; exits 1 if a colour or a map
differs.

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
from unified_cvo_tpu_torch.frontend import image, stereo  # noqa: E402
from unified_cvo_tpu_torch.ops import sgbm_opencv as sg  # noqa: E402

CV_NAMES = dict(min_disparity="minDisparity", num_disparities="numDisparities",
                block_size="blockSize", p1="P1", p2="P2", disp12_max_diff="disp12MaxDiff",
                uniqueness_ratio="uniquenessRatio", speckle_window_size="speckleWindowSize",
                speckle_range="speckleRange", pre_filter_cap="preFilterCap")


def every_colour():
    """All 2^24 BGR colours as one 4096 x 4096 uint8 image."""
    v = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(
        4096, 4096, 3)


def colours_differing():
    """(colours where cv2's BGR2GRAY is not the 15-bit rule, where it is not
    the 14-bit rule)."""
    img = every_colour()
    got = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY).astype(np.int64)
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    rule15 = (3735 * b + 19235 * g + 9798 * r + 16384) >> 15
    rule14 = (1868 * b + 9617 * g + 4899 * r + 8192) >> 14
    return int((got != rule15).sum()), int((got != rule14).sum())


def cv2_sgbm(left, right, kw):
    m = cv2.StereoSGBM_create(**{CV_NAMES[k]: v for k, v in kw.items()},
                              mode=cv2.STEREO_SGBM_MODE_SGBM_3WAY)
    return m.compute(left, right)


def main() -> int:
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    _, frames, _ = chip_smoke.stereo_frames()
    left, right = frames[0]
    kw = stereo.opencv_settings(128)
    off15, off14 = colours_differing()
    cl, cr = (cv2.cvtColor(im, cv2.COLOR_BGR2GRAY) for im in (left, right))
    gl, gr = (image.opencv_gray(torch.from_numpy(im)).to(torch.uint8) for im in (left, right))
    want = cv2_sgbm(cl, cr, kw)
    port = sg.sgbm_3way(gl.to(dev), gr.to(dev), **kw).cpu().numpy()
    jax_auto = want.astype(np.float32) / 16.0
    port_auto = stereo.compute_disparity(torch.from_numpy(left).to(dev),
                                         torch.from_numpy(right).to(dev)).cpu().numpy()
    digest = hashlib.sha256(want.astype("<i2").tobytes()).hexdigest()
    out = {"cv2": cv2.__version__, "device": str(dev), "auto_backend": stereo.auto_backend(),
           "input_digest_equal": hashlib.sha256(left.tobytes() + right.tobytes()).hexdigest()
           == chip_smoke.SGBM_INPUT_SHA256,
           "colours_differing_from_15bit_rule": off15,
           "colours_differing_from_14bit_rule": off14,
           "frame_gray_equal_port": bool(np.array_equal(cl, gl.numpy())
                                         and np.array_equal(cr, gr.numpy())),
           "map_digest": digest, "map_digest_equal": digest == chip_smoke.SGBM_MAP_SHA256,
           "map_pixels_differing_from_port": int((port != want).sum()),
           "auto_pixels_differing_from_port": int((port_auto != jax_auto).sum()),
           "pixels": int(want.size)}
    print(json.dumps(out), flush=True)
    return 0 if (off15 == 0 and out["map_digest_equal"]
                 and out["auto_pixels_differing_from_port"] == 0) else 1


if __name__ == "__main__":
    sys.exit(main())
