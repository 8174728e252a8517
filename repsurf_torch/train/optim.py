"""The segmentation recipe's optimizer and learning-rate schedule
(repsurf_tpu/train/optim.py ``make_adamw``, ``multistep_lr``)."""

import torch


def make_adamw(params, base_lr=6e-3, weight_decay=1e-2):
    """``torch.optim.AdamW`` as the recipe sets it (segmentation
    util/utils.py:213): betas (0.9, 0.999), eps 1e-8, decoupled decay on
    every parameter, as optax's ``adamw`` applies it."""
    return torch.optim.AdamW(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def multistep_lr(base_lr, milestones=(60, 80), gamma=0.1):
    """torch MultiStepLR stepped after each epoch, as a function of the
    0-based epoch."""

    def lr(epoch):
        return base_lr * gamma ** sum(1 for m in milestones if epoch >= m)

    return lr
