"""The training losses (repsurf_tpu/nn/losses.py): the classifier's
label-smoothed NLL and the segmentation's weighted cross-entropy."""

import torch


def smooth_cls_loss(log_probs, target, smoothing_ratio=0.1):
    """Label-smoothed NLL over log-probabilities (the reference's
    SmoothClsLoss): the target class weighs 1 - eps, every other class
    eps / (K - 1).

    Args:
      log_probs: [B, K] log-probabilities (the model's output).
      target: [B] int labels.

    Returns:
      the scalar mean over the batch.
    """
    eps = smoothing_ratio
    k = log_probs.shape[-1]
    one_hot = torch.nn.functional.one_hot(target.long(), k).to(log_probs.dtype)
    smoothed = one_hot * (1 - eps) + (1 - one_hot) * eps / (k - 1)
    return -(smoothed * log_probs).sum(dim=-1).mean()


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
