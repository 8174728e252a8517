"""Checkpoints with the reference's save-on-best policy and full-state
resume (repsurf_tpu/train/checkpoint.py), in ``torch.save`` format.

The reference saves {epoch, metric, model state, optimizer state} only when
the validation metric does not fall (``>=``), and resumes the model, the
optimizer, the epoch and the best metric from it; ``--pretrain`` restores
the weights alone.  ``train_state_dict`` / ``apply_train_state`` package a
model and its optimizer the same way: the model's state dict holds its
parameters and its BN running statistics.
"""

import os

import torch


def train_state_dict(model, optimizer, epoch=0, best_metric=0.0):
    """The full-resume payload: model (parameters and BN buffers),
    optimizer state, the epochs done and the best metric."""
    return {
        "model": model.state_dict(),
        "optimizer": optimizer.state_dict(),
        "epoch": int(epoch),
        "best_metric": float(best_metric),
    }


def apply_train_state(model, optimizer, restored, weights_only=False):
    """Load a payload into ``model`` (and ``optimizer``) in place.

    ``weights_only`` is the reference's ``--pretrain``: the model's state
    alone, the optimizer left fresh.

    Returns:
      (start_epoch, best_metric); (0, 0.0) with ``weights_only``.
    """
    model.load_state_dict(restored["model"])
    if weights_only:
        return 0, 0.0
    optimizer.load_state_dict(restored["optimizer"])
    return int(restored["epoch"]), float(restored["best_metric"])


class BestCheckpointer:
    """Keeps exactly one checkpoint: the best-metric payload so far, at
    ``path``."""

    def __init__(self, ckpt_dir):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.best_metric = float("-inf")
        self.best_epoch = -1

    @property
    def path(self):
        return os.path.join(self.ckpt_dir, "best.pt")

    def maybe_save(self, metric, epoch, payload):
        """Save ``payload`` iff ``metric`` >= the best so far (the
        reference's ``>=``); returns whether it saved.  The file is written
        beside the old one and renamed over it, so a crash leaves one whole
        checkpoint."""
        if metric < self.best_metric:
            return False
        self.best_metric = metric
        self.best_epoch = epoch
        tmp = self.path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path)
        return True

    def restore(self, map_location=None):
        """The saved payload, tensors on ``map_location``.  Loads with
        ``weights_only=True``: tensors and plain containers only."""
        return torch.load(self.path, map_location=map_location, weights_only=True)

    def exists(self):
        return os.path.exists(self.path)


def restore_weights(model, path, map_location=None):
    """The eval CLIs' partial restore (repsurf_tpu/train/checkpoint.py
    ``restore(partial=True)``): the model's parameters and BN statistics
    out of a full-resume payload, loaded into ``model`` in place.  The file
    is memory-mapped, so the optimizer state it also holds is never read."""
    payload = torch.load(path, map_location=map_location, weights_only=True, mmap=True)
    model.load_state_dict(payload["model"])
