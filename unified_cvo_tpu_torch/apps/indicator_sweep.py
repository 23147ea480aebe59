"""Function-angle overlap sweep along a sequence — the
cvo_indicator_in_sequence / evaluate_indicator twin (port of
unified_cvo_tpu/apps/indicator_sweep.py).

Usage:
    python -m unified_cvo_tpu_torch.apps.indicator_sweep SEQ_DIR PARAMS.yaml OUT.csv \
        [ELL] [START] [COUNT] [STRIDE]

For each frame i in the window, computes cos(theta) between frame START and
frame i at the given lengthscale (the keyframe/co-visibility decision signal,
reference main_indicator_in_sequence.cpp) and writes CSV rows
`frame,function_angle`. The clouds (the stereo host frontend) and the angle
are computed on `device` (None means the card).
"""

from __future__ import annotations

import sys

import torch

from unified_cvo_tpu_torch.config import read_cvo_params_yaml
from unified_cvo_tpu_torch.datasets.kitti import KittiHandler
from unified_cvo_tpu_torch.device import resolve_device
from unified_cvo_tpu_torch.frontend.pipeline import pointcloud_from_stereo
from unified_cvo_tpu_torch.models.align import function_angle


def main(argv=None, device=None, log=print):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        print(__doc__)
        return 1
    seq_dir, param_file, out_csv = argv[:3]
    ell = float(argv[3]) if len(argv) > 3 else 1.0
    start = int(argv[4]) if len(argv) > 4 else 0
    count = int(argv[5]) if len(argv) > 5 else 20
    stride = int(argv[6]) if len(argv) > 6 else 1
    dev = resolve_device(device)

    kitti = KittiHandler(seq_dir, "stereo")
    calib = kitti.calibration()
    params = read_cvo_params_yaml(param_file)
    kitti.set_start_index(start)
    ref_pair = kitti.read_next_stereo()
    ref = pointcloud_from_stereo(ref_pair[0], ref_pair[1], calib, capacity=32768, device=dev)
    eye = torch.eye(4, dtype=torch.float32, device=dev)

    with open(out_csv, "w") as f:
        f.write("frame,function_angle\n")
        for k in range(1, count + 1):
            for _ in range(stride):
                kitti.next()
            pair = kitti.read_next_stereo()
            if pair is None:
                break
            cur = pointcloud_from_stereo(pair[0], pair[1], calib, capacity=32768, device=dev)
            cos = float(function_angle(ref, cur, eye, ell, params, device=dev))
            f.write(f"{start + k * stride},{cos:.6f}\n")
            f.flush()
            log(f"frame {start + k * stride}: cos = {cos:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
