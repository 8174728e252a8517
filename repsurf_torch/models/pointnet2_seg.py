"""PointNet++ SSG segmentation baseline (repsurf_tpu/models/pointnet2_seg.py):
four stride-4 kNN SA stages (the first with sectorized FPS in training),
four concat-skip FP stages and the per-point head.  Inputs and output as
``RepSurfSegmentor``'s; parameter names are the reference's (``sa1..4``,
``fp1..4``, ``classifier``).
"""

import torch
from torch import nn

from ..nn.blocks import PointNetFeaturePropagation, PointNetSetAbstraction
from ..nn.layers import Dropout, Linear, MaskedBatchNorm, run_layers
from ..ops.masking import counts_to_mask
from .repsurf_seg import HEAD_HIDDEN

HEAD_DROPOUT = 0.5


class PointNet2Segmentor(nn.Module):
    """``forward(pos, feature, valid, generator)``: ``generator`` feeds the
    head's dropout (the reference's 0.5) in training.  ``in_channel``
    counts the stage-0 features, [xyz, feature]."""

    def __init__(self, num_class=13, num_sector=4, in_channel=6,
                 sa_stride=(4, 4, 4, 4), sa_nsample=(32, 32, 32, 32),
                 sa_mlp=((32, 32, 64), (64, 64, 128), (128, 128, 256), (256, 256, 512)),
                 fp_mlp=((256, 256), (256, 256), (256, 128), (128, 128, 128)),
                 generator=None):
        super().__init__()
        gen = generator
        self.n_stages = len(sa_stride)
        widths = [in_channel]  # each level's feature channels
        for i in range(self.n_stages):
            self.add_module(f"sa{i + 1}", PointNetSetAbstraction(
                3 + widths[-1], tuple(sa_mlp[i]), stride=sa_stride[i], nsample=sa_nsample[i],
                num_sector=num_sector if i == 0 else 1, generator=gen,
            ))
            widths.append(sa_mlp[i][-1])
        prev = widths[-1]
        for j in range(self.n_stages, 0, -1):
            skip = widths[j - 1] if j > 1 else 0
            mlp = tuple(fp_mlp[self.n_stages - j])  # fp4 .. fp1, reference order
            self.add_module(f"fp{j}", PointNetFeaturePropagation(skip + prev, mlp, generator=gen))
            prev = mlp[-1]
        self.classifier = nn.Sequential(
            Linear(prev, HEAD_HIDDEN, generator=gen),
            MaskedBatchNorm(HEAD_HIDDEN),
            nn.ReLU(),
            Dropout(HEAD_DROPOUT),
            Linear(HEAD_HIDDEN, num_class, generator=gen),
        )

    def forward(self, pos, feature, valid=None, generator=None):
        xyzs, feats, valids = [pos], [torch.cat([pos, feature], dim=-1)], [valid]
        for i in range(1, self.n_stages + 1):
            x, f, v = getattr(self, f"sa{i}")(xyzs[-1], feats[-1], valid=valids[-1])
            xyzs.append(x)
            feats.append(f)
            valids.append(v)
        x = feats[-1]
        for j in range(self.n_stages, 0, -1):
            x = getattr(self, f"fp{j}")(xyzs[j - 1], feats[j - 1] if j > 1 else None, xyzs[j], x,
                                        valid1=valids[j - 1], valid2=valids[j])
        mask = None if valid is None else counts_to_mask(valid, pos.shape[1])[..., None]
        return run_layers(self.classifier, x, mask, generator)


def pointnet2_ssg(num_class=13, **kw):
    """Reference recipe pointnet2_ssg (0.968 M parameters)."""
    return PointNet2Segmentor(num_class=num_class, **kw)
