"""Umbrella RepSurf semantic segmentation (repsurf_tpu/models/repsurf_seg.py).

A seg-style umbrella constructor, four stride-4 kNN SA-CD stages (the first
with sectorized FPS in training), four FP-CD stages and a per-point head.
Inputs are [B, N, 3] coordinates, [B, N, C] point features (RGB for S3DIS)
and optional [B] valid counts; the output is [B, N, num_class] logits
(padded rows carry garbage: mask them with the valid counts or the ignore
label).  Parameter names are the reference's (``surface_constructor``,
``sa1..4``, ``fp1..4``, ``classifier``).
"""

import torch
from torch import nn

from ..nn.blocks import (
    SurfaceAbstractionCD,
    SurfaceFeaturePropagationCD,
    UmbrellaSurfaceConstructor,
)
from ..nn.layers import Dropout, Linear, MaskedBatchNorm, run_layers
from ..ops.masking import counts_to_mask

REPSURF_CHANNEL = 10
HEAD_HIDDEN = 128
SA_STRIDE = 4  # every stage keeps a quarter of its points
SA_NSAMPLE = 32  # kNN group size of every stage


class RepSurfSegmentor(nn.Module):
    """PointNet++-SSG segmentation backbone with Umbrella RepSurf features.

    ``forward(pos, feature, valid, inv_sign, generator)``: ``inv_sign`` is
    the [B] +-1 inversion of the umbrella normals, or None for none (the
    train step draws it when ``random_inv``); ``generator`` feeds the head's
    dropout in training.  ``in_channel`` counts the stage-0 features,
    [xyz, feature] (6 for xyz + RGB).  Parameters are drawn from
    ``generator`` at construction when one is given.
    """

    def __init__(self, num_class=13, group_size=8, return_polar=False,
                 random_inv=True, num_sector=4, head_dropout=0.5, in_channel=6,
                 sa_mlp=((32, 32, 64), (64, 64, 128), (128, 128, 256), (256, 256, 512)),
                 fp_mlp=((256, 256), (256, 256), (256, 128), (128, 128, 128)),
                 generator=None):
        super().__init__()
        gen = generator
        self.random_inv = random_inv
        self.n_stages = len(sa_mlp)
        self.surface_constructor = UmbrellaSurfaceConstructor(
            group_size + 1, REPSURF_CHANNEL, style="seg", generator=gen,
        )
        feat_in = REPSURF_CHANNEL + in_channel  # normal + [xyz, rgb]
        for i in range(self.n_stages):
            self.add_module(f"sa{i + 1}", SurfaceAbstractionCD(
                feat_in, tuple(sa_mlp[i]), stride=SA_STRIDE, nsample=SA_NSAMPLE,
                return_polar=return_polar, grouping="knn",
                num_sector=num_sector if i == 0 else 1, generator=gen,
            ))
            feat_in = REPSURF_CHANNEL + sa_mlp[i][-1]
        prev = sa_mlp[-1][-1]
        for j in range(self.n_stages, 0, -1):
            mlp = tuple(fp_mlp[self.n_stages - j])  # fp4 .. fp1, reference order
            skip = sa_mlp[j - 2][-1] if j > 1 else None
            self.add_module(f"fp{j}", SurfaceFeaturePropagationCD(prev, skip, mlp,
                                                                  generator=gen))
            prev = mlp[-1]
        self.classifier = nn.Sequential(
            Linear(prev, HEAD_HIDDEN, generator=gen),
            MaskedBatchNorm(HEAD_HIDDEN),
            nn.ReLU(),
            Dropout(head_dropout),
            Linear(HEAD_HIDDEN, num_class, generator=gen),
        )

    def forward(self, pos, feature, valid=None, inv_sign=None, generator=None):
        normal = self.surface_constructor(pos, valid=valid, inv_sign=inv_sign)
        centers, normals = [pos], [normal]
        feats, valids = [torch.cat([pos, feature], dim=-1)], [valid]
        for i in range(1, self.n_stages + 1):
            c, n, f, v = getattr(self, f"sa{i}")(centers[-1], normals[-1], feats[-1],
                                                 valid=valids[-1])
            centers.append(c)
            normals.append(n)
            feats.append(f)
            valids.append(v)
        x = feats[-1]
        for j in range(self.n_stages, 0, -1):
            x = getattr(self, f"fp{j}")(
                centers[j - 1], feats[j - 1] if j > 1 else None, centers[j], x,
                valid1=valids[j - 1], valid2=valids[j],
            )
        mask = None if valid is None else counts_to_mask(valid, pos.shape[1])[..., None]
        return run_layers(self.classifier, x, mask, generator)


def repsurf_umb_ssg(num_class=13, **kw):
    """Reference recipe repsurf_umb_ssg (0.976 M parameters)."""
    return RepSurfSegmentor(num_class=num_class, **kw)
