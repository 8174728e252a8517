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
    # one int64 histogram of three rows (intersection, prediction, target)
    # of K + 1 bins: masked-out entries land in the spare bin K, cut off.
    # torch.bincount on a CUDA tensor reads its input's range back to the
    # host; a scatter-add into a fixed number of bins needs no host sync.
    rows = torch.stack((torch.where(keep & (pred == target), pred, num_class),
                        torch.where(keep, pred, num_class),
                        torch.where(keep, target, num_class)))
    rows = torch.where((rows >= 0) & (rows < num_class), rows, num_class)
    bins = rows + torch.arange(3, device=rows.device)[:, None] * (num_class + 1)
    counts = torch.zeros(3 * (num_class + 1), dtype=torch.int64, device=rows.device)
    counts.scatter_add_(0, bins.reshape(-1), torch.ones_like(bins).reshape(-1))
    inter, area_pred, area_target = counts.view(3, num_class + 1)[:, :num_class].to(torch.float32)
    return inter, area_pred + area_target - inter, area_target


def iou_from_counts(intersection, union, target):
    """(mIoU, mAcc, allAcc) from accumulated count vectors."""
    iou_class = intersection / (union + 1e-10)
    acc_class = intersection / (target + 1e-10)
    return iou_class.mean(), acc_class.mean(), intersection.sum() / (target.sum() + 1e-10)
