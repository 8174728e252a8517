"""The recipes' losses in plain PyTorch: the segmentation's class-weighted
cross-entropy with an ignore label (torch ``CrossEntropyLoss(weight,
ignore_index)``) and the classification's label-smoothed NLL (RepSurf's
``SmoothClsLoss``, smoothing 0.1)."""

import torch


def weighted_ce(logits, target, weight, ignore):
    k = logits.shape[-1]
    logits, target = logits.reshape(-1, k), target.reshape(-1)
    keep = target != ignore
    t = torch.where(keep, target, 0)
    nll = -torch.log_softmax(logits, -1).gather(1, t[:, None])[:, 0]
    w = torch.where(keep, weight[t], 0.0)
    return (nll * w).sum() / torch.clamp(w.sum(), min=1e-10)


def smooth_nll(logp, target, eps=0.1):
    k = logp.shape[-1]
    one = torch.nn.functional.one_hot(target, k).to(logp.dtype)
    return -((one * (1 - eps) + (1 - one) * eps / (k - 1)) * logp).sum(-1).mean()
