"""Segmentation metrics (repsurf_tpu/nn/metrics.py): per-class histograms of
intersection, union and target, and the mIoU / mAcc / OA they give."""

import torch


def intersection_and_union(pred, target, num_class, ignore_index=255):
    """Predictions at ignored targets count as neither hit nor miss.

    Args:
      pred: [...] int predictions in [0, K).
      target: [...] int labels in [0, K) or equal to ``ignore_index``.

    Returns:
      (intersection [K], union [K], target_area [K]) float32 counts.
    """
    pred = pred.reshape(-1).long()
    target = target.reshape(-1).long()
    keep = target != ignore_index

    def hist(x, mask):
        # masked-out rows land in a spare bin K, cut off (no host sync)
        x = torch.where(mask, x, num_class)
        return torch.bincount(x, minlength=num_class + 1)[:num_class].to(torch.float32)

    inter = hist(pred, keep & (pred == target))
    area_pred = hist(pred, keep)
    area_target = hist(target, keep)
    return inter, area_pred + area_target - inter, area_target


def iou_from_counts(intersection, union, target):
    """(mIoU, mAcc, allAcc) from accumulated count vectors."""
    iou_class = intersection / (union + 1e-10)
    acc_class = intersection / (target + 1e-10)
    return iou_class.mean(), acc_class.mean(), intersection.sum() / (target.sum() + 1e-10)
