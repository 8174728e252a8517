"""PointNeXt segmentation (Qian et al., NeurIPS 2022, arXiv:2206.04670;
guochengqian/PointNeXt ``cfgs/s3dis/pointnext-xl.yaml``, openpoints
``PointNextEncoder``, ``PointNextDecoder``, ``SegHead``).

* Input: [feature, height] per point, the height being z minus the lowest
  z of the cloud's valid points (openpoints' ``heights``); ``in_channel``
  counts both, so the model takes ``in_channel - 1`` feature channels.
* Stem ``stem``: Linear(in_channel -> width) with a bias, no norm or
  activation.
* Encoder stages ``enc1`` .. ``enc4``: widths 2, 4, 8, 16 x ``width``,
  each a ``SetAbstraction`` (FPS to N // stride, ball radius r_i) then
  ``blocks[i] - 1`` ``InvResMLP`` blocks over the stage's own points at
  radius r_i * ``radius_scaling``, r_i = ``radius`` * scaling^(i - 1).
* Decoder ``dec4`` .. ``dec1``: each the 3-NN interpolation of the coarser
  stage onto the finer, after its skip features, and two Linear + BN +
  ReLU layers to the skip's width.
* Head ``head``: Linear (no bias) + BN + ReLU, Dropout(0.5), Linear to the
  classes.

Departures from openpoints:

* the ball test is d2 <= float32(r**2) (openpoints' CUDA ``ball_query``
  tests d2 < r**2), d2 summed from direct coordinate differences;
* FPS starts at index 0 and breaks ties on the lowest index;
* each local aggregation queries its own ball, so a stage's blocks select
  the same balls again (exact, the same indices);
* the 3-NN interpolation is the port's ``three_interpolate``: Euclidean
  distances from direct differences, weights 1 / (d + 1e-8) normalised, as
  openpoints' ``three_nn`` (square root of its squared distances) and
  ``three_interpolation`` form them; neighbour ties break on the lowest
  index;
* clouds are padded to one [B, N] layout with ``valid`` counts, every
  batch norm takes its statistics over the live rows of the whole batch,
  and stage i keeps valid // 4 points.
"""

import torch
from torch import nn

from ..nn.layers import Dropout, Linear, MaskedBatchNorm, run_layers
from ..nn.pointnext import FeaturePropagation, InvResMLP, SetAbstraction
from ..ops.masking import counts_to_mask

HEAD_DROPOUT = 0.5
# the training recipe's fields of train_seg.SegConfig that differ from
# RepSurf's defaults (cfgs/s3dis/pointnext-xl.yaml, default.yaml): colour and
# height in, plain FPS, label smoothing 0.2 with every class weighed 1
RECIPE = {"in_channel": 4, "num_sector": 1, "label_smoothing": 0.2}


class PointNeXtSegmentor(nn.Module):
    """``forward(pos, feature, valid, generator)``: ``generator`` feeds the
    head's dropout in training."""

    def __init__(self, num_class=13, in_channel=4, width=64, blocks=(1, 4, 7, 4, 4),
                 strides=(1, 4, 4, 4, 4), radius=0.1, radius_scaling=2, nsample=32,
                 expansion=4, generator=None):
        super().__init__()
        gen = generator
        if strides[0] != 1 or blocks[0] != 1:
            raise ValueError("the stem is one stride-1 layer: blocks[0] and strides[0] are 1")
        widths = [width * 2 ** i for i in range(len(blocks))]
        self.stem = Linear(in_channel, width, generator=gen)
        r = radius
        for i in range(1, len(blocks)):
            layers = [SetAbstraction(widths[i - 1], widths[i], strides[i], r, nsample,
                                     generator=gen)]
            layers += [InvResMLP(widths[i], r * radius_scaling, nsample, expansion,
                                 generator=gen) for _ in range(1, blocks[i])]
            self.add_module(f"enc{i}", nn.ModuleList(layers))
            r *= radius_scaling
        self.n_stages = len(blocks) - 1
        for i in range(self.n_stages, 0, -1):
            self.add_module(f"dec{i}", FeaturePropagation(widths[i - 1], widths[i],
                                                          widths[i - 1], generator=gen))
        self.head = nn.Sequential(
            Linear(width, width, bias=False, generator=gen), MaskedBatchNorm(width), nn.ReLU(),
            Dropout(HEAD_DROPOUT), Linear(width, num_class, generator=gen),
        )

    def forward(self, pos, feature, valid=None, generator=None):
        """pos [B, N, 3], feature [B, N, in_channel - 1], valid [B] or None
        -> logits [B, N, num_class]."""
        z = pos[..., 2]
        if valid is not None:
            live = counts_to_mask(valid, pos.shape[1])
            z_low = torch.where(live, z, z.new_full((), float("inf")))
        else:
            z_low = z
        height = z - z_low.amin(dim=1, keepdim=True)
        xyzs, valids = [pos], [valid]
        feats = [self.stem(torch.cat([feature, height[..., None]], dim=-1))]
        for i in range(1, self.n_stages + 1):
            sa, *blocks = getattr(self, f"enc{i}")
            p, f, v = sa(xyzs[-1], feats[-1], valid=valids[-1])
            for block in blocks:
                f = block(p, f, valid=v)
            xyzs.append(p)
            feats.append(f)
            valids.append(v)
        x = feats[-1]
        for i in range(self.n_stages, 0, -1):
            x = getattr(self, f"dec{i}")(xyzs[i - 1], feats[i - 1], xyzs[i], x,
                                         valid1=valids[i - 1], valid2=valids[i])
        mask = None if valid is None else counts_to_mask(valid, pos.shape[1])[..., None]
        return run_layers(self.head, x, mask, generator)


def pointnext_xl(num_class=13, num_sector=1, in_channel=4, **kw):
    """The S3DIS recipe pointnext-xl (41,576,461 parameters at 13 classes):
    width 64, blocks 1/4/7/4/4, strides 1/4/4/4/4, radius 0.1 doubling a
    stage, 32 a ball, expansion 4.  ``num_sector`` is taken for
    ``train_seg.build_model`` and must be 1: the recipe samples by plain
    FPS."""
    if num_sector != 1:
        raise ValueError(f"pointnext samples by plain FPS: num_sector must be 1, got {num_sector}")
    return PointNeXtSegmentor(num_class=num_class, in_channel=in_channel, **kw)
