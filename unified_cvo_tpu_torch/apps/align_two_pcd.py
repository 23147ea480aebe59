"""Two-colored-PCD alignment demo, the cvo_align_gpu_two_color_pcd twin
(port of unified_cvo_tpu/apps/align_two_pcd.py).

Usage (reference README.md:58-73):
    python -m unified_cvo_tpu_torch.apps.align_two_pcd SOURCE.pcd TARGET.pcd PARAMS.yaml \
        [ELL_INIT] [MAX_ITER]

Mirrors src/experiments/main_cvo_gpu_align_two_color_pcd.cpp: loads two
XYZRGB clouds, sets ell_init to the cloud-mean distance (unless given),
swaps in the first-frame decay schedule, aligns from identity on the card,
writes before_align.pcd / after_align.pcd and prints the transform, the
timing and function_angle before and after.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from unified_cvo_tpu_torch.config import read_cvo_params_yaml
from unified_cvo_tpu_torch.datasets.pcd import load_demo_cloud, read_pcd, write_pcd
from unified_cvo_tpu_torch.device import resolve_device
from unified_cvo_tpu_torch.models.align import align, function_angle

ANGLE_ELL = 0.5   # the lengthscale the demo reads function_angle at


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def align_two(source_file, target_file, param_file, ell=-1.0, max_iter=None, out_dir=".",
              log=print, device=None):
    """The demo: returns a dict with the transform T (float32 [4, 4], numpy),
    ret, the AlignInfo, function_angle before and after, and the cold
    (first call: kernel build and load included) and warm align seconds."""
    dev = resolve_device(device)
    src = load_demo_cloud(source_file, device=dev)
    tgt = load_demo_cloud(target_file, device=dev)
    sx, sc = read_pcd(source_file)
    tx, tc = read_pcd(target_file)

    params = read_cvo_params_yaml(param_file)
    dist = float(np.linalg.norm(sx.mean(0) - tx.mean(0)))
    log(f"source mean {sx.mean(0)}, target mean {tx.mean(0)}, dist {dist:.3f}")
    params = params.replace(
        ell_init=dist if ell < 0 else ell,
        ell_decay_rate=params.ell_decay_rate_first_frame,
        ell_decay_start=params.ell_decay_start_first_frame,
    )
    log(f"ell init is {params.ell_init}")
    log(f"Start align... num_fixed is {len(sx)}, num_moving is {len(tx)}")

    eye = torch.eye(4, dtype=torch.float32, device=dev)
    # the first call builds and loads the kernels; the second times the
    # registration alone (the reference's "Average registration time")
    t0 = time.time()
    align(src, tgt, eye, params, max_iter=max_iter, device=dev)
    _sync(dev)
    cold = time.time() - t0
    t0 = time.time()
    T_dev, ret, info = align(src, tgt, eye, params, max_iter=max_iter, device=dev)
    _sync(dev)
    elapsed = time.time() - t0
    T = T_dev.cpu().numpy()
    log(f"cvo # of iterations is {int(info.iterations)}")
    log(f"final ell is {float(info.final_ell):.4f}, ret={int(ret)}")
    log(f"Transform is\n {T}")
    log(f"first call {cold:.3f} s (kernel build and load included)")
    log(f"Average registration time is {elapsed:.3f} s")

    # function_angle applies the INVERSE of its transform to the moving cloud
    # (inner_product_impl convention, CvoGPU.cu:1719-1778); the align result
    # maps target->source directly, so pass its inverse.
    cos_before = float(function_angle(src, tgt, eye, ANGLE_ELL, params, device=dev))
    T_inv = torch.from_numpy(np.linalg.inv(T).astype(np.float32)).to(dev)
    cos_after = float(function_angle(src, tgt, T_inv, ANGLE_ELL, params, device=dev))
    log(f"function_angle(ell={ANGLE_ELL}): before {cos_before:.4f} after {cos_after:.4f}")

    tx_new = tx @ T[:3, :3].T + T[:3, 3]
    both_rgb = np.concatenate([sc, tc]) if sc is not None and tc is not None else None
    write_pcd(os.path.join(out_dir, "before_align.pcd"), np.concatenate([sx, tx]), both_rgb)
    write_pcd(os.path.join(out_dir, "after_align.pcd"), np.concatenate([sx, tx_new]), both_rgb)
    log("wrote before_align.pcd / after_align.pcd")
    return {"T": T, "ret": int(ret), "info": info, "cos_before": cos_before,
            "cos_after": cos_after, "cold_s": cold, "warm_s": elapsed}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        print(__doc__)
        return 1
    source_file, target_file, param_file = argv[:3]
    ell = float(argv[3]) if len(argv) > 3 else -1.0
    max_iter = int(argv[4]) if len(argv) > 4 else None
    align_two(source_file, target_file, param_file, ell, max_iter)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
