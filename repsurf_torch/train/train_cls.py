"""Classification vote evaluation (repsurf_tpu/train/train_cls.py, the
eval half).

Per batch: FPS 2048 -> ``num_point``, then ``num_votes`` forwards in eval
mode.  Vote 0 is unscaled, votes 1.. are rescaled by U(0.8, 1.2) per cloud
and axis, every vote draws a fresh +-1 normal inversion per sample, the
log-probabilities are summed and the argmax is the vote prediction.
"""

import dataclasses

import torch

from ..data.scanobjectnn import iterate_batches
from ..data.transforms import fps_sample, scale_point_cloud
from ..models import get_model


@dataclasses.dataclass(frozen=True)
class ClsConfig:
    """The eval slice of the reference recipe (scripts/scanobjectnn/
    repsurf_ssg_umb.sh)."""

    model: str = "repsurf.repsurf_ssg_umb"
    num_class: int = 15
    num_point: int = 1024
    batch_size: int = 64
    seed: int = 2800
    group_size: int = 8
    return_polar: bool = True
    num_votes: int = 10
    head_dropout: float = 0.4


def build_model(cfg, generator=None):
    """The configured model on the CPU, parameters drawn from ``generator``
    (a CPU ``torch.Generator``; torch's global one when None)."""
    return get_model(
        cfg.model,
        num_class=cfg.num_class,
        group_size=cfg.group_size,
        return_polar=cfg.return_polar,
        head_dropout=cfg.head_dropout,
        generator=generator,
    )


def _random_sign(batch, generator, device):
    draw = torch.randint(0, 2, (batch,), generator=generator, device=device)
    return draw.to(torch.float32) * 2.0 - 1.0


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
        pts = fps_sample(points, cfg.num_point)
        vote_sum, single = 0.0, None
        for i in range(cfg.num_votes):
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
