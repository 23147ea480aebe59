"""Pixel/point-level semantic labeling evaluation — the devkit twin (port of
unified_cvo_tpu/apps/evaluate_semantics.py).

The reference bundles a Cityscapes-style evaluator
(devkit/evaluation/evalPixelLevelSemanticLabeling.py: per-class
confusion matrix -> IoU = tp / (tp + fp + fn), mean IoU over classes
with valid ground truth, global pixel accuracy; ignored labels are
excluded from both numerator and denominator). The confusion matrix is one
torch.bincount on `device` (None means the card); label IMAGES (png/npy)
or labeled POINT CLOUD exports (e.g. SemanticBKIMap.export_occupied
semantics vs ground-truth labels).

Usage:
    python -m unified_cvo_tpu_torch.apps.evaluate_semantics GT PRED
        [--num-classes C] [--ignore ID ...]

GT/PRED: .npy int arrays of any matching shape, or PNG label images
(datasets/png.py, cv2.IMREAD_UNCHANGED's samples; a colour image keeps its
first channel, blue, as JAX's cv2 read does). Prints per-class IoU, mean
IoU, and accuracy.
"""

from __future__ import annotations

import argparse
from typing import Sequence

import numpy as np
import torch

from unified_cvo_tpu_torch.datasets import png
from unified_cvo_tpu_torch.device import resolve_device


def _labels(a, dev) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.reshape(-1).to(dev, torch.int64)
    return torch.from_numpy(np.asarray(a).reshape(-1).astype(np.int64)).to(dev)


def confusion_matrix(gt, pred, num_classes: int, ignore: Sequence[int] = (),
                     device=None) -> torch.Tensor:
    """int64 [C, C+1] confusion matrix on `device`, rows = ground truth, cols
    = prediction; the extra column C collects INVALID predictions (out of
    [0, num_classes)) on valid-GT pixels — they count as errors (false
    negatives), exactly as the devkit treats predictions of non-evaluated
    labels. Only pixels whose GT label is ignored or out of range are
    excluded (ignoreInEval semantics)."""
    dev = resolve_device(device)
    gt, pred = _labels(gt, dev), _labels(pred, dev)
    keep = (gt >= 0) & (gt < num_classes)
    for ig in ignore:
        keep &= gt != ig
    gt, pred = gt[keep], pred[keep]
    pred = torch.where((pred >= 0) & (pred < num_classes), pred, num_classes)
    return torch.bincount(gt * (num_classes + 1) + pred,
                          minlength=num_classes * (num_classes + 1)).reshape(
                              num_classes, num_classes + 1)


def iou_per_class(conf: torch.Tensor) -> torch.Tensor:
    """IoU_c = tp / (tp + fp + fn) (getIouScoreForLabel) in float64; NaN
    where the class never appears in GT or prediction. `conf` is [C, C+1]:
    row sums (fn) include the invalid-prediction column, so an invalid
    prediction on a valid-GT pixel lowers that class's IoU."""
    C = conf.shape[0]
    tp = torch.diagonal(conf[:, :C]).to(torch.float64)
    fp = conf[:, :C].sum(0) - tp
    fn = conf.sum(1) - tp
    denom = tp + fp + fn
    return torch.where(denom > 0, tp / denom, torch.nan)


def evaluate(gt, pred, num_classes: int, ignore: Sequence[int] = (), device=None) -> dict:
    """{"confusion" (int64 tensor on `device`), "iou" (float64 tensor),
    "mean_iou", "accuracy"}; the two scalars are numpy's arithmetic on the
    matrix's host copy, JAX's values exactly."""
    conf = confusion_matrix(gt, pred, num_classes, ignore, device)
    ious = iou_per_class(conf)
    host = conf.cpu().numpy()
    total = host.sum()   # includes invalid predictions -> they hurt accuracy
    acc = (float(np.diag(host[:, :num_classes]).sum() / total) if total else float("nan"))
    iou_host = ious.cpu().numpy()
    miou = float(np.nanmean(iou_host)) if np.isfinite(iou_host).any() else float("nan")
    return {"confusion": conf, "iou": ious, "mean_iou": miou, "accuracy": acc}


def _load(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    img = png.imread(path, unchanged=True)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 3:
        img = img[..., 0]
    return img


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("gt")
    ap.add_argument("pred")
    ap.add_argument("--num-classes", type=int, default=19)
    ap.add_argument("--ignore", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    gt = _load(args.gt)
    pred = _load(args.pred)
    if gt.shape != pred.shape:
        print(f"shape mismatch: {gt.shape} vs {pred.shape}")
        return 1
    r = evaluate(gt, pred, args.num_classes, args.ignore, device=device)
    for c, iou in enumerate(r["iou"].tolist()):
        if np.isfinite(iou):
            print(f"class {c:3d}: IoU {iou:.4f}")
    print(f"mean IoU: {r['mean_iou']:.4f}")
    print(f"accuracy: {r['accuracy']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
