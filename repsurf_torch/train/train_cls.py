"""Classification trainer (repsurf_tpu/train/train_cls.py).

``train_step``: FPS 2048 -> ``num_point``, the optional scale / shift
augmentation, a training forward (batch statistics, a random +-1 normal
inversion per sample, head dropout), the label-smoothed loss, backward and
the optimizer step, on a CUDA device replayed as one CUDA graph
(``step_graph``).  ``train_epoch`` sets the epoch's StepLR rate and runs the
steps over shuffled, drop-last batches.

Vote evaluation, per batch: FPS 2048 -> ``num_point``, then ``num_votes``
forwards in eval mode.  Vote 0 is unscaled, votes 1.. are rescaled by
U(0.8, 1.2) per cloud and axis, every vote draws a fresh +-1 normal
inversion per sample, the log-probabilities are summed and the argmax is
the vote prediction.

Every random draw comes from an explicit ``torch.Generator``.
"""

import dataclasses
import functools
from typing import Optional

import torch

from ..data.scanobjectnn import iterate_batches
from ..data.transforms import fps_sample, scale_point_cloud, transform_point_cloud
from ..models import get_model
from ..nn.losses import smooth_cls_loss
from ..utils.spans import span
from . import step_graph
from .optim import make_adam, make_sgd, set_lr, step_lr


@dataclasses.dataclass(frozen=True)
class ClsConfig:
    """The reference's argparse surface (train_cls_scanobjectnn.py:22-67)
    with the recipe defaults of scripts/scanobjectnn/repsurf_ssg_umb.sh, as
    the JAX package's ClsConfig."""

    model: str = "repsurf.repsurf_ssg_umb"
    num_class: int = 15
    num_point: int = 1024
    batch_size: int = 64
    epoch: int = 250
    optimizer: str = "Adam"
    learning_rate: float = 1e-3
    decay_rate: float = 1e-4
    momentum: float = 0.9  # SGD only
    decay_step: int = 20
    min_val: int = 100
    seed: int = 2800
    aug_scale: bool = False
    aug_shift: bool = False
    group_size: int = 8
    umb_pool: str = "sum"
    return_dist: bool = True
    return_center: bool = True
    return_polar: bool = True
    num_votes: int = 10
    init_type: Optional[str] = None  # kaiming | xavier | None (torch default)
    head_dropout: float = 0.4


def build_model(cfg, generator=None):
    """The configured model on the CPU, parameters drawn from ``generator``
    (a CPU ``torch.Generator``; torch's global one when None).
    ``return_center=False`` raises in the model, as in the JAX package;
    ``init_type``, which the JAX trainer carries but never applies, raises
    here."""
    if cfg.init_type is not None:
        raise NotImplementedError(f"init_type {cfg.init_type!r} is not ported")
    return get_model(
        cfg.model,
        num_class=cfg.num_class,
        group_size=cfg.group_size,
        umb_pool=cfg.umb_pool,
        return_dist=cfg.return_dist,
        return_center=cfg.return_center,
        return_polar=cfg.return_polar,
        head_dropout=cfg.head_dropout,
        generator=generator,
    )


def make_optimizer(model, cfg):
    """The optimizer ``create_state`` builds: Adam with coupled L2
    ``decay_rate``, or SGD with ``momentum`` and no decay."""
    if cfg.optimizer == "Adam":
        return make_adam(model.parameters(), cfg.learning_rate, cfg.decay_rate)
    return make_sgd(model.parameters(), cfg.learning_rate, momentum=cfg.momentum)


def epoch_lr(cfg, epoch):
    """StepLR with the scheduler-before-epoch quirk, for the 0-based epoch."""
    return step_lr(cfg.learning_rate, cfg.decay_step)(epoch)


def _random_sign(batch, generator, device):
    draw = torch.randint(0, 2, (batch,), generator=generator, device=device)
    return draw.to(torch.float32) * 2.0 - 1.0


def train_forward(model, points, cfg, generator=None, signs=None):
    """The training forward of ``train_step``: FPS, the augmentation, the
    normal inversion and the dropout draws (see there) -> log-probs."""
    with span("train.forward"):
        model.train()
        pts = fps_sample(points, cfg.num_point)
        if cfg.aug_scale or cfg.aug_shift:
            xyz = transform_point_cloud(pts[..., :3], generator=generator,
                                        aug_scale=cfg.aug_scale, aug_shift=cfg.aug_shift)
            pts = torch.cat([xyz, pts[..., 3:]], dim=-1)
        if signs is None:
            if generator is None:
                raise ValueError("the random normal inversion needs a generator")
            signs = _random_sign(pts.shape[0], generator, pts.device)
        return model(pts, inv_sign=signs, generator=generator)


def train_step(model, optimizer, points, target, cfg, generator=None, signs=None):
    """One optimizer step, in place on ``model`` and ``optimizer``.

    Args:
      points: [B, N_raw, >=3] raw clouds and target [B] labels, on the
        model's device.
      generator: ``torch.Generator`` on that device.  Draws, in order: the
        augmentation uniforms (scale, then shift, when on), the +-1 sign,
        the head's dropout masks.
      signs: optional [B] +-1 normal inversion (not drawn when given).

    Where ``step_graph.graphable`` holds (CUDA inputs, no process group, a
    capturable optimizer: ``make_adam`` on CUDA parameters), the step is
    captured as a CUDA graph on its second call with the same key and
    replayed from then on (``step_graph.run``); elsewhere it is
    ``eager_step``.

    Returns:
      (loss, correct) tensors of their own.
    """
    step = functools.partial(eager_step, model, optimizer, cfg=cfg, generator=generator)
    return step_graph.run(step, model, optimizer,
                          {"points": points, "target": target, "signs": signs}, generator,
                          config=cfg)


def eager_step(model, optimizer, points, target, cfg, generator=None, signs=None):
    """``train_step`` without a graph: launch by launch from the host."""
    logp = train_forward(model, points, cfg, generator, signs)
    loss = smooth_cls_loss(logp, target)
    optimizer.zero_grad(set_to_none=True)
    with span("train.backward"):
        loss.backward()
    with span("train.update"):
        optimizer.step()
    correct = (logp.detach().argmax(dim=-1) == target).sum()
    return loss.detach(), correct


def train_epoch(model, optimizer, dataset, cfg, epoch, generator, rng=None):
    """One epoch: the epoch's StepLR rate, then a ``train_step`` per
    shuffled, drop-last batch (``rng``: a NumPy RandomState for the
    shuffle).  Returns (mean loss, accuracy) as floats."""
    set_lr(optimizer, epoch_lr(cfg, epoch))
    device = next(model.parameters()).device
    losses, correct, total = [], 0, 0
    for pts, lbl in iterate_batches(dataset, cfg.batch_size, shuffle=True, drop_last=True,
                                    rng=rng):
        target = torch.from_numpy(lbl).to(device)
        loss, corr = train_step(model, optimizer, torch.from_numpy(pts).to(device), target,
                                cfg, generator=generator)
        losses.append(loss)
        correct = correct + corr
        total += len(lbl)
    if not losses:
        return 0.0, 0.0
    return float(torch.stack(losses).mean()), int(correct) / total


def train_epoch_sharded(step, model, optimizer, dataset, cfg, epoch, rng=None):
    """One epoch through the data-parallel step of
    ``parallel.shard_step.make_cls_train_step`` (repsurf_tpu/train/train_cls.py
    ``train_epoch_sharded``): every rank walks the same shuffled, drop-last
    global batches (``rng`` seeded alike on every rank) and steps its
    shard; step i's draws come from (seed, epoch, i, rank).  Returns
    (mean loss, accuracy) over the global batches, as floats."""
    from ..utils.seed import epoch_generator

    set_lr(optimizer, epoch_lr(cfg, epoch))
    device = next(model.parameters()).device
    losses, correct, total = [], 0, 0
    for i, (pts, lbl) in enumerate(iterate_batches(dataset, cfg.batch_size, shuffle=True,
                                                   drop_last=True, rng=rng)):
        gen = epoch_generator(cfg.seed, epoch, device, i, step.rank)
        loss, corr = step(model, optimizer, pts, lbl, generator=gen)
        losses.append(loss)
        correct = correct + corr
        total += len(lbl)
    if not losses:
        return 0.0, 0.0
    return float(torch.stack(losses).mean()), int(correct) / total


def eval_step(model, points, target, cfg, generator=None, uniforms=None, signs=None):
    """Vote evaluation of one batch, under ``torch.inference_mode``.

    Args:
      model: a classifier in eval mode.
      points: [B, N_raw, 3] raw clouds; target: [B] labels.
      generator: ``torch.Generator`` on points' device for the rescale and
        inversion draws (per vote: the uniforms, then the signs).
      uniforms: optional [num_votes - 1, B, 1, 3] U(0, 1) draws for votes 1..
      signs: optional [num_votes, B] +-1 inversions.  Draws that are given
        are not taken from the generator.

    Returns:
      (single_correct, vote_correct, vote_sum [B, num_class]) tensors.
    """
    if model.training:
        raise ValueError("eval_step needs a model in eval mode")
    if generator is None and (uniforms is None or signs is None):
        raise ValueError("give a generator for the draws that are not injected")
    with torch.inference_mode():
        with span("serve.sample"):
            pts = fps_sample(points, cfg.num_point)
        vote_sum, single = 0.0, None
        for i in range(cfg.num_votes):
            with span("serve.forward"):
                p = pts
                if i > 0:
                    u = None if uniforms is None else uniforms[i - 1]
                    p = scale_point_cloud(
                        pts, generator=None if u is not None else generator, uniforms=u
                    )
                sign = (
                    signs[i] if signs is not None
                    else _random_sign(pts.shape[0], generator, pts.device)
                )
                logp = model(p, inv_sign=sign)
                if i == 0:
                    single = logp
                vote_sum = vote_sum + logp
        single_correct = (single.argmax(-1) == target).sum()
        vote_correct = (vote_sum.argmax(-1) == target).sum()
    return single_correct, vote_correct, vote_sum


def evaluate(model, dataset, cfg, generator, device):
    """Full vote evaluation; returns (single_acc, vote_acc)."""
    model.eval()
    sing, vote, total = 0, 0, 0
    for pts, lbl in iterate_batches(dataset, cfg.batch_size):
        points = torch.from_numpy(pts).to(device)
        target = torch.from_numpy(lbl).to(device)
        s, v, _ = eval_step(model, points, target, cfg, generator=generator)
        sing += int(s)
        vote += int(v)
        total += len(lbl)
    return sing / max(total, 1), vote / max(total, 1)
