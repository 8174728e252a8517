"""Segmentation train and eval steps (repsurf_tpu/train/train_seg.py).

``train_step``: the training forward (sectorized FPS, batch statistics,
head dropout, a random normal inversion per sample), the loss with the
ignore label, backward, AdamW, and the histogram counters, on a CUDA device
replayed as one CUDA graph (``step_graph``).  ``eval_step``
is the serving forward: running statistics, no sectors, no dropout, no
inversion.

The loss is ``seg_loss``: the weighted cross-entropy, or with
``label_smoothing`` above 0 torch's label-smoothed cross-entropy, which
weighs every class 1.

Every seg name trains through the same step: the repsurf model draws its
normal inversion, the baselines take none.  ``freeze=True`` follows the JAX
step (train_seg.py:148-152): the surface constructor's gradients are zeroed
before the optimizer, so its AdamW moments decay as optax's do, and its
parameters end the step exactly as they began (torch's decoupled decay
would otherwise move them, so they are restored from a snapshot).  Its BN
running statistics still update, as they do in the JAX step.  A model
without a surface constructor has nothing to freeze.
"""

import dataclasses
from typing import Optional

import torch

from ..models import get_model
from ..nn.layers import Dropout
from ..nn.losses import weighted_cross_entropy
from ..nn.metrics import intersection_and_union
from ..utils.spans import span
from . import step_graph
from .optim import make_adamw, make_sgd, multistep_lr

FROZEN_SCOPE = "surface_constructor"


@dataclasses.dataclass(frozen=True)
class SegConfig:
    """The reference argparse surface (tool/train.py:33-103) with the
    recipe defaults of scripts/s3dis/train_repsurf_umb.sh, as the JAX
    package's ``SegConfig`` sets them."""

    model: str = "repsurf.repsurf_umb_ssg"
    dataset: str = "S3DIS"
    num_class: int = 13
    ignore_label: int = 255
    # ScanNet protocol (tool/train.py:458-468): class 0 is "unannotated";
    # predictions take the argmax over classes 1.. and never predict 0
    pred_ignore0: bool = False
    test_area: int = 5
    batch_size: int = 8
    batch_size_val: int = 8
    epoch: int = 100
    optimizer: str = "AdamW"
    learning_rate: float = 6e-3
    weight_decay: float = 1e-2
    momentum: float = 0.9
    lr_decay: float = 0.1
    lr_decay_epochs: tuple = (60, 80)
    min_val: int = 60
    val_freq: int = 1
    freeze_epoch: int = int(1e6)
    seed: int = 2000
    voxel_size: float = 0.04
    voxel_max: int = 80000
    in_channel: int = 6
    data_norm: str = "mean"
    loop: int = 30
    # model
    group_size: int = 8
    return_polar: bool = False
    num_sector: int = 4
    head_dropout: float = 0.5
    # the loss's label smoothing (PointNeXt's S3DIS recipe: 0.2); 0 keeps the
    # weighted cross-entropy
    label_smoothing: float = 0.0
    # augmentation flags (tool/train.py:74-94)
    aug_scale: bool = False
    aug_rotate: Optional[str] = None
    aug_jitter: bool = False
    aug_flip: bool = False
    aug_shift: bool = False
    color_contrast: bool = False
    color_shift: bool = False
    color_jitter: bool = False
    hs_shift: bool = False
    color_drop: bool = False


def build_model(cfg, generator=None):
    """The configured model on the CPU, parameters drawn from ``generator``
    (a CPU ``torch.Generator``).  As in the JAX package, only the repsurf
    names take ``group_size``, ``return_polar`` and ``head_dropout``; every
    model takes ``num_sector`` and, to size its first layer, ``in_channel``."""
    kwargs = dict(num_class=cfg.num_class, num_sector=cfg.num_sector,
                  in_channel=cfg.in_channel, generator=generator)
    if "repsurf" in cfg.model:
        kwargs.update(group_size=cfg.group_size, return_polar=cfg.return_polar,
                      head_dropout=cfg.head_dropout)
    return get_model(cfg.model, **kwargs)


def make_optimizer(model, cfg):
    """AdamW (decoupled decay), or SGD with momentum and coupled L2 for
    ``optimizer="SGD"``, as the JAX ``create_state`` builds them."""
    if cfg.optimizer == "AdamW":
        return make_adamw(model.parameters(), cfg.learning_rate, cfg.weight_decay)
    if cfg.optimizer == "SGD":
        return make_sgd(model.parameters(), cfg.learning_rate, cfg.momentum, cfg.weight_decay)
    raise ValueError(f"optimizer {cfg.optimizer!r}: the seg recipe has AdamW and SGD")


def _random_sign(batch, generator, device):
    draw = torch.randint(0, 2, (batch,), generator=generator, device=device)
    return draw.to(torch.float32) * 2.0 - 1.0


def train_forward(model, batch, generator=None):
    """The training forward of ``train_step`` (``model.train()``, the
    normal inversion drawn from ``generator`` when ``model.random_inv``,
    the head's dropout from it when the model has one) -> logits."""
    with span("train.forward"):
        model.train()
        coord = batch["coord"]
        kwargs = {}
        if getattr(model, "random_inv", False):
            if generator is None:
                raise ValueError("the random normal inversion needs a generator")
            kwargs["inv_sign"] = _random_sign(coord.shape[0], generator, coord.device)
        if any(isinstance(m, Dropout) for m in model.modules()):
            kwargs["generator"] = generator
        return model(coord, batch["feat"], batch["valid"], **kwargs)


def apply_update(model, optimizer, freeze=False):
    """The optimizer step on the gradients in ``.grad``; with ``freeze``
    the surface constructor's gradients are zeroed first and its parameters
    restored after (see the module doc)."""
    with span("train.update"):
        scope = getattr(model, FROZEN_SCOPE, None) if freeze else None
        frozen = [] if scope is None else list(scope.parameters())
        saved = [p.detach().clone() for p in frozen]
        for p in frozen:
            p.grad = torch.zeros_like(p)
        optimizer.step()
        with torch.no_grad():
            for p, s in zip(frozen, saved):
                p.copy_(s)


def seg_loss(logits, label, class_weight, cfg):
    """The segmentation loss: ``weighted_cross_entropy`` at
    ``cfg.label_smoothing`` 0; above it torch's ``cross_entropy`` with that
    label smoothing and the ignore label, the mean over the points kept.
    The recipe that smooths (PointNeXt's) weighs every class 1, so
    ``class_weight`` is not used there."""
    if cfg.label_smoothing == 0.0:
        return weighted_cross_entropy(logits, label, class_weight, cfg.ignore_label)
    k = logits.shape[-1]
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, k), label.reshape(-1).long(), ignore_index=cfg.ignore_label,
        label_smoothing=cfg.label_smoothing)


def train_step(model, optimizer, batch, class_weight, cfg, generator=None, freeze=False):
    """One training step, in place on ``model`` and ``optimizer``.

    Args:
      batch: dict of coord [B, N, 3], feat [B, N, C], label [B, N] and
        valid [B] tensors on the model's device.
      class_weight: [K] tensor.
      generator: ``torch.Generator`` on the model's device for the normal
        inversion (when ``model.random_inv``) and the head dropout (when
        the model has one); the baselines take no inversion, PointTransformer
        no dropout.
      freeze: freeze the surface constructor (see the module doc); a no-op
        for a model without one.

    Where ``step_graph.graphable`` holds (CUDA inputs, no process group, a
    capturable optimizer: ``make_adamw`` on CUDA parameters), the step is
    captured as a CUDA graph on its second call with the same key and
    replayed from then on (``step_graph.run``); elsewhere it is
    ``eager_step``.

    Returns:
      (loss, (intersection, union, target)) tensors of their own.
    """
    def step(class_weight, **batch):
        return eager_step(model, optimizer, batch, class_weight, cfg, generator, freeze)

    return step_graph.run(step, model, optimizer, dict(batch, class_weight=class_weight),
                          generator, config=(cfg, freeze))


def eager_step(model, optimizer, batch, class_weight, cfg, generator=None, freeze=False):
    """``train_step`` without a graph: launch by launch from the host."""
    label = batch["label"]
    logits = train_forward(model, batch, generator)
    loss = seg_loss(logits, label, class_weight, cfg)
    optimizer.zero_grad(set_to_none=True)
    with span("train.backward"):
        loss.backward()
    apply_update(model, optimizer, freeze)
    pred = predict(logits.detach(), cfg)
    return loss.detach(), intersection_and_union(pred, label, cfg.num_class,
                                                 cfg.ignore_label)


def predict(logits, cfg):
    """The argmax over classes, or with ``cfg.pred_ignore0`` over classes
    1.. plus one (the reference's ``output[:, 1:].max(1)[1] + 1``)."""
    if cfg.pred_ignore0:
        return logits[..., 1:].argmax(dim=-1) + 1
    return logits.argmax(dim=-1)


def eval_step(model, batch, class_weight, cfg):
    """The serving forward of one batch (same batch layout as
    ``train_step``); returns (loss, pred [B, N], (intersection, union,
    target))."""
    model.eval()
    with torch.no_grad():
        logits = model(batch["coord"], batch["feat"], batch["valid"])
        loss = seg_loss(logits, batch["label"], class_weight, cfg)
    pred = predict(logits, cfg)
    return loss, pred, intersection_and_union(pred, batch["label"], cfg.num_class,
                                              cfg.ignore_label)


def epoch_lr(cfg, epoch):
    return multistep_lr(cfg.learning_rate, tuple(cfg.lr_decay_epochs), cfg.lr_decay)(epoch)


def is_frozen(cfg, epoch):
    """The reference's condition: frozen from the 0-based epoch index
    ``freeze_epoch`` on (tool/train.py:272, ``freeze_epoch < epoch + 1``)."""
    return cfg.freeze_epoch < epoch + 1
