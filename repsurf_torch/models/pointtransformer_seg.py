"""PointTransformer segmentation (repsurf_tpu/models/pointtransformer_seg.py):
5 encoder stages (blocks 2, 3, 4, 6, 3; strides 1, 4, 4, 4, 4; kNN of 16;
sectorized FPS at stage 2 in training), 5 decoder stages of TransitionUp
and one block, and a Linear + BN + ReLU + Linear head.  Inputs and output
as ``RepSurfSegmentor``'s; no random inversion, no dropout.  Parameter
names are the reference's: ``enc{i}.0`` the TransitionDown and
``enc{i}.j`` its blocks, ``dec{i}.0`` the TransitionUp and ``dec{i}.1`` the
block, ``cls`` the head.
"""

import torch
from torch import nn

from ..nn.layers import Linear, MaskedBatchNorm, run_layers
from ..nn.pointtransformer import PointTransformerBlock, TransitionDown, TransitionUp
from ..ops.masking import counts_to_mask


class PointTransformerSegmentor(nn.Module):
    """``in_channel`` counts the stage-0 features, [xyz, feature] (xyz
    alone at 3)."""

    def __init__(self, num_class=13, in_channel=6, share_planes=8, num_sector=4,
                 planes=(32, 64, 128, 256, 512), enc_blocks=(2, 3, 4, 6, 3),
                 strides=(1, 4, 4, 4, 4), nsample=(16, 16, 16, 16, 16), generator=None):
        super().__init__()
        gen = generator
        self.in_channel = in_channel
        in_p = in_channel
        for i in range(5):
            layers = [TransitionDown(in_p, planes[i], strides[i], nsample[i],
                                     num_sector if i == 1 else 1, generator=gen)]
            layers += [PointTransformerBlock(planes[i], share_planes, nsample[i], generator=gen)
                       for _ in range(1, enc_blocks[i])]
            self.add_module(f"enc{i + 1}", nn.ModuleList(layers))
            in_p = planes[i]
        for i in range(4, -1, -1):
            up = TransitionUp(planes[i], None, generator=gen) if i == 4 else TransitionUp(
                planes[i + 1], planes[i], generator=gen)
            self.add_module(f"dec{i + 1}", nn.ModuleList([
                up, PointTransformerBlock(planes[i], share_planes, nsample[i], generator=gen)]))
        self.cls = nn.Sequential(
            Linear(planes[0], planes[0], generator=gen), MaskedBatchNorm(planes[0]), nn.ReLU(),
            Linear(planes[0], num_class, generator=gen),
        )

    def forward(self, pos, feature, valid=None):
        x = pos if self.in_channel == 3 else torch.cat([pos, feature], dim=-1)
        stages, p, v = [], pos, valid
        for i in range(1, 6):
            for layer in getattr(self, f"enc{i}"):
                p, x, v = layer(p, x, valid=v)
            stages.append((p, x, v))
        up, block = self.dec5
        p, _, v = stages[4]
        _, x, _ = block(p, up(p, stages[4][1], valid1=v), valid=v)
        coarse = (p, x, v)
        for i in range(4, 0, -1):
            up, block = getattr(self, f"dec{i}")
            p, xi, v = stages[i - 1]
            x = up(p, xi, valid1=v, pos2=coarse[0], feat2=coarse[1], valid2=coarse[2])
            _, x, _ = block(p, x, valid=v)
            coarse = (p, x, v)
        mask = None if valid is None else counts_to_mask(valid, pos.shape[1])[..., None]
        return run_layers(self.cls, x, mask)


def pointtransformer(num_class=13, **kw):
    """Reference recipe pointtransformer (7.767 M parameters)."""
    return PointTransformerSegmentor(num_class=num_class, **kw)
