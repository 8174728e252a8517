"""Data-parallel train steps (repsurf_tpu/parallel/shard_step.py): each rank
steps its shard of the global batch, the gradients are averaged across the
ranks before the optimizer (DDP's averaging, JAX's ``pmean``), the loss is
averaged and the IoU counters summed.

``bn="per_device"`` is the reference's default: every rank normalises with
its own shard's statistics and keeps its own BN running buffers, which are
never averaged or broadcast (JAX keeps them stacked a device each; torch
DDP would need ``broadcast_buffers=False`` for the same).  Rank 0's buffers
are what the trainer saves and evaluates with (JAX's
``unstack_batch_stats(stats, 0)``).  ``bn="sync"`` (the reference's
``--sync_bn``) all-reduces the masked statistics across the ranks inside
every ``MaskedBatchNorm`` for the step, so every rank's buffers stay equal.

Each rank draws from its own generator, which the caller derives from
(seed, epoch, step, rank): the counterpart of JAX's ``fold_in(key,
axis_index)``.  Every rank holds the same parameters and optimizer state
from the same initial weights, and averaging keeps them equal.
"""

import contextlib

import torch
import torch.distributed as dist

from ..nn.layers import MaskedBatchNorm
from .distributed import process_info


@contextlib.contextmanager
def bn_process_group(model, group):
    """Every ``MaskedBatchNorm`` of ``model`` takes ``group`` for the block,
    and its own group again after it."""
    bns = [m for m in model.modules() if isinstance(m, MaskedBatchNorm)]
    saved = [m.process_group for m in bns]
    for m in bns:
        m.process_group = group
    try:
        yield
    finally:
        for m, g in zip(bns, saved):
            m.process_group = g


def average_gradients(model):
    """Average every parameter's gradient over the ranks, in one all-reduce
    of one flat buffer (a parameter without a gradient counts as a zero
    one, so every rank reduces the same buffer)."""
    world = process_info()[1]
    params = list(model.parameters())
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= world
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[offset:offset + n].view_as(p)
        offset += n


def _mean_and_sums(loss, counts):
    loss = loss.detach().clone()
    dist.all_reduce(loss)
    stacked = torch.stack(counts)
    dist.all_reduce(stacked)
    return loss / process_info()[1], tuple(stacked)


def make_seg_train_step(cfg, bn="per_device"):
    """The data-parallel segmentation train step.

    Returns ``step(model, optimizer, batch, class_weight, generator=None,
    freeze=False) -> (loss, (intersection, union, target))``: ``batch`` is
    this rank's shard (``parallel.mesh.shard_batch``) on its device, the
    loss the mean over the ranks and the counters their sums.  Predictions
    take ``train_seg.predict`` (``cfg.pred_ignore0``); JAX's sharded step
    takes the plain argmax there.  ``freeze`` masks the surface constructor
    after the gradients are averaged, as JAX does.
    """
    from ..nn.losses import weighted_cross_entropy
    from ..nn.metrics import intersection_and_union
    from ..train.train_seg import apply_update, predict, train_forward

    if bn not in ("per_device", "sync"):
        raise ValueError(f"bn {bn!r}: per_device or sync")
    if not dist.is_initialized():
        raise ValueError("the data-parallel step needs a process group (init_distributed)")
    # a MaskedBatchNorm without a group normalises over its own rows
    bn_group = dist.group.WORLD if bn == "sync" else None

    def step(model, optimizer, batch, class_weight, generator=None, freeze=False):
        label = batch["label"]
        with bn_process_group(model, bn_group):
            logits = train_forward(model, batch, generator)
            loss = weighted_cross_entropy(logits, label, class_weight, cfg.ignore_label)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        average_gradients(model)
        apply_update(model, optimizer, freeze)
        pred = predict(logits.detach(), cfg)
        counts = intersection_and_union(pred, label, cfg.num_class, cfg.ignore_label)
        return _mean_and_sums(loss, counts)

    step.rank = process_info()[0]
    return step


def make_cls_train_step(cfg):
    """The data-parallel classification train step (the reference's
    ``nn.DataParallel``: per-replica BN, averaged gradients).

    Returns ``step(model, optimizer, points, target, generator=None,
    signs=None) -> (loss, correct)``: ``points`` [B, N_raw, 3] and
    ``target`` [B] are the GLOBAL batch (numpy arrays or tensors); the step
    takes this rank's rows, moves them to the model's device, and returns
    the mean loss over the ranks and the summed count of correct clouds.
    """
    from ..nn.losses import smooth_cls_loss
    from ..train.train_cls import train_forward
    from .mesh import shard_rows

    if not dist.is_initialized():
        raise ValueError("the data-parallel step needs a process group (init_distributed)")
    rank, world = process_info()

    def step(model, optimizer, points, target, generator=None, signs=None):
        device = next(model.parameters()).device
        rows = shard_rows(points.shape[0], rank, world)
        points = torch.as_tensor(points[rows]).to(device)
        target = torch.as_tensor(target[rows]).to(device)
        logp = train_forward(model, points, cfg, generator, signs)
        loss = smooth_cls_loss(logp, target)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        average_gradients(model)
        optimizer.step()
        correct = (logp.detach().argmax(dim=-1) == target).sum()
        loss, (correct,) = _mean_and_sums(loss, [correct])
        return loss, correct

    step.rank = rank
    return step
