"""The segmentation loss (repsurf_tpu/nn/losses.py weighted_cross_entropy)."""

import torch


def weighted_cross_entropy(logits, target, class_weight=None, ignore_index=255):
    """torch ``CrossEntropyLoss(weight=w, ignore_index=i)`` written out as
    the JAX package writes it (nn/losses.py:35-57), including its
    ``max(sum w, 1e-10)`` guard: where every target is ignored the loss is
    0, where ``F.cross_entropy`` gives NaN.

    Args:
      logits: [..., K] unnormalised scores.
      target: [...] int labels; entries equal to ``ignore_index`` count for
        nothing.
      class_weight: optional [K] per-class weights.

    Returns:
      scalar sum(w[t] * nll) / max(sum(w[t]), 1e-10) over kept positions.
    """
    k = logits.shape[-1]
    logits = logits.reshape(-1, k)
    target = target.reshape(-1)
    keep = target != ignore_index
    safe_t = torch.where(keep, target, 0).long()
    nll = -torch.log_softmax(logits, dim=-1).gather(1, safe_t[:, None])[:, 0]
    if class_weight is None:
        w = keep.to(logits.dtype)
    else:
        w = torch.where(keep, class_weight.to(logits)[safe_t], 0.0)
    return (nll * w).sum() / torch.clamp(w.sum(), min=1e-10)
