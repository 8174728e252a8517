"""The recipes' optimizers and learning-rate schedules
(repsurf_tpu/train/optim.py).

* classification: Adam (lr 1e-3) with ``weight_decay`` 1e-4 as torch's Adam
  applies it, a coupled L2 term added to the gradient (optax's
  ``add_decayed_weights`` before ``scale_by_adam``), on every parameter, BN
  included; SGD with momentum and coupled L2; StepLR (20, 0.7) with the
  reference's scheduler-before-epoch quirk: epoch e trains at
  lr0 * gamma ** ((e + 1) // step).
* segmentation: AdamW (6e-3, decoupled decay 1e-2) and MultiStepLR stepped
  after each epoch.

A schedule is a function of the 0-based epoch; ``set_lr`` writes its value
into the optimizer's parameter groups before the epoch.
"""

import torch


def _capturable(params):
    """Whether ``train/step_graph.py`` can graph a step over ``params``:
    every one on a CUDA device, and no process group (the data-parallel
    steps stay eager)."""
    return (bool(params) and all(p.is_cuda for p in params)
            and not (torch.distributed.is_available() and torch.distributed.is_initialized()))


def make_adam(params, base_lr=1e-3, weight_decay=1e-4):
    """``torch.optim.Adam`` as the classification recipe sets it
    (train_cls_scanobjectnn.py:179-185): betas (0.9, 0.999), eps 1e-8,
    coupled L2.  Where ``train/step_graph.py`` can graph the step (CUDA
    parameters, no process group) it is ``capturable``: its step count and
    bias corrections live on the device, so that a CUDA graph can hold the
    update; the update may then differ from the host-corrected one in the
    last bit.  The data-parallel step's Adam (in a process group) is not."""
    params = list(params)
    return torch.optim.Adam(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay, capturable=_capturable(params))


def make_sgd(params, base_lr, momentum=0.9, weight_decay=0.0):
    """``torch.optim.SGD`` with momentum and coupled L2."""
    return torch.optim.SGD(params, lr=base_lr, momentum=momentum,
                           weight_decay=weight_decay)


def make_adamw(params, base_lr=6e-3, weight_decay=1e-2):
    """``torch.optim.AdamW`` as the recipe sets it (segmentation
    util/utils.py:213): betas (0.9, 0.999), eps 1e-8, decoupled decay on
    every parameter, as optax's ``adamw`` applies it.  ``capturable`` where
    ``make_adam`` is, with the same last-bit caveat."""
    params = list(params)
    return torch.optim.AdamW(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay, capturable=_capturable(params))


def step_lr(base_lr, decay_step=20, gamma=0.7, pre_step=True):
    """torch StepLR as a function of the 0-based epoch; ``pre_step`` is the
    classification recipe's ``scheduler.step()`` before each epoch."""

    def lr(epoch):
        k = epoch + 1 if pre_step else epoch
        return base_lr * gamma ** (k // decay_step)

    return lr


def multistep_lr(base_lr, milestones=(60, 80), gamma=0.1):
    """torch MultiStepLR stepped after each epoch, as a function of the
    0-based epoch."""

    def lr(epoch):
        return base_lr * gamma ** sum(1 for m in milestones if epoch >= m)

    return lr


def set_lr(optimizer, lr):
    """Set every parameter group's learning rate."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer
