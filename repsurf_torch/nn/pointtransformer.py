"""PointTransformer blocks, the segmentation baseline
(repsurf_tpu/nn/pointtransformer.py): local vector attention over kNN
neighbourhoods with shared attention planes, TransitionDown (FPS, kNN
group, Linear, max-pool) and TransitionUp (3-NN interpolation fusion, or
the head's per-sample context).

Every kNN takes ``nsample`` (16) neighbours.  A query with fewer valid
points than that gets missing slots, (index 0, distance sqrt(1e10)), and
the attention's softmax runs over them unmasked, as in the JAX package.
Module attribute names follow the reference's torch modules (``linear_q``,
``linear_p.0``, ``linear_w.2``, ``linear1``, ``bn1``, ``transformer2``...).

Spans (``utils/spans.py``): ``pt.attention`` a vector attention layer,
``pt.down`` a strided TransitionDown, ``pt.up`` a TransitionUp.
"""

import torch
from torch import nn

from ..ops.gather import index_points
from ..ops.interpolate import three_interpolate
from ..ops.masking import counts_to_mask
from ..ops.neighbors import knn
from ..utils.spans import span
from .blocks import _mask, sample
from .layers import Linear, MaskedBatchNorm, run_layers


class PointTransformerLayer(nn.Module):
    """Local vector attention: w = MLP(k - q + pos_enc), softmax over the
    neighbours, out = sum_k (v + pos_enc) * w, ``share_planes`` channel
    groups sharing each attention weight."""

    def __init__(self, in_planes, out_planes, share_planes=8, nsample=16, generator=None):
        super().__init__()
        gen, mid, s = generator, out_planes, share_planes
        self.out_planes, self.share_planes, self.nsample = out_planes, share_planes, nsample
        self.linear_q = Linear(in_planes, mid, generator=gen)
        self.linear_k = Linear(in_planes, mid, generator=gen)
        self.linear_v = Linear(in_planes, out_planes, generator=gen)
        self.linear_p = nn.Sequential(
            Linear(3, 3, generator=gen), MaskedBatchNorm(3), nn.ReLU(),
            Linear(3, out_planes, generator=gen),
        )
        self.linear_w = nn.Sequential(
            MaskedBatchNorm(mid), nn.ReLU(), Linear(mid, mid // s, generator=gen),
            MaskedBatchNorm(mid // s), nn.ReLU(),
            Linear(out_planes // s, out_planes // s, generator=gen),
        )

    def forward(self, pos, feat, valid=None):
        """pos [B,N,3], feat [B,N,C] -> [B, N, out_planes]."""
        with span("pt.attention"):
            b, n, _ = pos.shape
            x_q, x_k, x_v = self.linear_q(feat), self.linear_k(feat), self.linear_v(feat)
            idx, _ = knn(self.nsample, pos, pos, valid=valid)
            mask = _mask(valid, n)  # [B, N, 1], broadcast over the neighbours
            pe = run_layers(self.linear_p, index_points(pos, idx) - pos[:, :, None], mask)
            w = index_points(x_k, idx) - x_q[:, :, None] + pe
            w = torch.softmax(run_layers(self.linear_w, w, mask), dim=2)
            s = self.share_planes
            v = (index_points(x_v, idx) + pe).reshape(b, n, self.nsample, s,
                                                      self.out_planes // s)
            return (v * w[:, :, :, None, :]).sum(dim=2).reshape(b, n, self.out_planes)


class TransitionDown(nn.Module):
    """Stride 1: pointwise Linear (no bias) + BN + ReLU.  Otherwise FPS to
    N // stride (sectorized in training with ``num_sector`` > 1), kNN
    grouping of [relative xyz, feat], Linear (no bias) + BN + ReLU and a
    max-pool over the neighbours."""

    def __init__(self, in_planes, out_planes, stride=1, nsample=16, num_sector=1,
                 generator=None):
        super().__init__()
        self.stride, self.nsample, self.num_sector = stride, nsample, num_sector
        in_ch = in_planes if stride == 1 else 3 + in_planes
        self.linear = Linear(in_ch, out_planes, bias=False, generator=generator)
        self.bn = MaskedBatchNorm(out_planes)

    def forward(self, pos, feat, valid=None):
        """-> (new_pos, new_feat, new_valid)."""
        if self.stride == 1:
            x = self.bn(self.linear(feat), mask=_mask(valid, pos.shape[1]), relu=True)
            return pos, x, valid
        with span("pt.down"):
            idx, new_valid = sample(pos, None, self.stride, valid, self.num_sector, self.training)
            new_pos = index_points(pos, idx)
            gidx, _ = knn(self.nsample, pos, new_pos, valid=valid)
            x = torch.cat([index_points(pos, gidx) - new_pos[:, :, None],
                           index_points(feat, gidx)], dim=-1)
            x = self.bn(self.linear(x), mask=_mask(new_valid, new_pos.shape[1]), relu=True)
            return new_pos, x.amax(dim=2), new_valid


class TransitionUp(nn.Module):
    """Head mode (``out_planes`` None): each point concatenated with its
    sample's masked feature mean through ``linear2`` (Linear + ReLU), then
    ``linear1`` (Linear + BN + ReLU).  Otherwise ``linear1`` of the fine
    features plus the 3-NN interpolation of ``linear2`` of the coarse."""

    def __init__(self, in_planes, out_planes=None, generator=None):
        super().__init__()
        gen = generator
        self.head = out_planes is None
        if self.head:
            self.linear1 = nn.Sequential(Linear(2 * in_planes, in_planes, generator=gen),
                                         MaskedBatchNorm(in_planes), nn.ReLU())
            self.linear2 = nn.Sequential(Linear(in_planes, in_planes, generator=gen), nn.ReLU())
            return
        self.linear1 = nn.Sequential(Linear(out_planes, out_planes, generator=gen),
                                     MaskedBatchNorm(out_planes), nn.ReLU())
        self.linear2 = nn.Sequential(Linear(in_planes, out_planes, generator=gen),
                                     MaskedBatchNorm(out_planes), nn.ReLU())

    def forward(self, pos1, feat1, valid1=None, pos2=None, feat2=None, valid2=None):
        with span("pt.up"):
            n = feat1.shape[1]
            mask1 = _mask(valid1, n)
            if self.head:
                if valid1 is None:
                    mean = feat1.mean(dim=1, keepdim=True)
                else:
                    m = counts_to_mask(valid1, n)[..., None].to(feat1.dtype)
                    mean = (feat1 * m).sum(dim=1, keepdim=True) / torch.clamp(
                        m.sum(dim=1, keepdim=True), min=1.0)
                g = self.linear2(mean).expand(-1, n, -1)
                return run_layers(self.linear1, torch.cat([feat1, g], dim=-1), mask1)
            a = run_layers(self.linear1, feat1, mask1)
            b = run_layers(self.linear2, feat2, _mask(valid2, feat2.shape[1]))
            return a + three_interpolate(pos2, pos1, b, valid_src=valid2)


class PointTransformerBlock(nn.Module):
    """Residual block: Linear + BN + ReLU, the attention layer, BN + ReLU,
    Linear + BN, plus the input, ReLU."""

    def __init__(self, planes, share_planes=8, nsample=16, generator=None):
        super().__init__()
        gen = generator
        self.linear1 = Linear(planes, planes, bias=False, generator=gen)
        self.bn1 = MaskedBatchNorm(planes)
        self.transformer2 = PointTransformerLayer(planes, planes, share_planes, nsample,
                                                  generator=gen)
        self.bn2 = MaskedBatchNorm(planes)
        self.linear3 = Linear(planes, planes, bias=False, generator=gen)
        self.bn3 = MaskedBatchNorm(planes)

    def forward(self, pos, feat, valid=None):
        """-> (pos, new_feat, valid)."""
        mask = _mask(valid, pos.shape[1])
        x = self.bn1(self.linear1(feat), mask=mask, relu=True)
        x = self.bn2(self.transformer2(pos, x, valid=valid), mask=mask, relu=True)
        x = self.bn3(self.linear3(x), mask=mask)
        return pos, torch.relu(x + feat), valid
