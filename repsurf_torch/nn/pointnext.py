"""PointNeXt blocks (Qian et al., *PointNeXt: Revisiting PointNet++ with
Improved Training and Scaling Strategies*, NeurIPS 2022, arXiv:2206.04670;
openpoints ``models/backbone/pointnext.py``): the local aggregation, the
strided set abstraction built on it, the inverted-residual MLP block and
the two-layer feature propagation of the decoder.

Every 1x1 convolution is a ``Linear`` over the trailing channel axis, with
no bias where a batch norm follows.  The local aggregation of a cloud's
points p_j, f_j onto queries q_i is

    a_i = max_j ReLU(BN(W [(p_j - q_i) / r, f_j]))

over the first ``nsample`` points within radius r of q_i in index order
(``ball_group_feature``: the ball kernel on a CUDA device), a short ball
padded with its first hit.  The division by r is an IEEE division by a
tensor (torch divides by a Python float as a multiply by its reciprocal on
the card).

Spans (``utils/spans.py``): ``pnx.aggregate`` a local aggregation, from the
ball query to the max over the slots, with ``pnx.group`` around its ball
query and gather inside it; ``pnx.mlp`` an inverted-residual block's two
pointwise layers and its residual.
"""

import torch
from torch import nn

from ..ops.gather import index_points
from ..ops.interpolate import three_interpolate
from ..ops.kernels.ball_group import ball_group_feature
from ..utils.spans import span
from .blocks import _mask, sample
from .layers import Linear, MaskedBatchNorm


class LocalAggregation(nn.Module):
    """``conv`` (C_in + 3 -> C_out, no bias), ``bn`` with the ReLU, and the
    max over each query's ``nsample`` slots (openpoints ``LocalAggregation``
    with ``feature_type dp_fj``, ``normalize_dp``, ``reduction max``)."""

    def __init__(self, in_channels, out_channels, radius, nsample, generator=None):
        super().__init__()
        self.radius, self.nsample = radius, nsample
        self.conv = Linear(in_channels + 3, out_channels, bias=False, generator=generator)
        self.bn = MaskedBatchNorm(out_channels)

    def forward(self, xyz, new_xyz, feat, valid=None, new_valid=None):
        """xyz [B, N, 3] and feat [B, N, C_in] of the cloud, queries new_xyz
        [B, M, 3] with ``new_valid`` real rows -> [B, M, C_out]."""
        with span("pnx.aggregate"):
            with span("pnx.group"):
                dp, fj = ball_group_feature(self.radius, self.nsample, xyz, new_xyz,
                                            [xyz, feat], valid=valid)
            x = torch.cat([dp / dp.new_full((), self.radius), fj], dim=-1)
            x = self.bn(self.conv(x), mask=_mask(new_valid, new_xyz.shape[1]), relu=True)
            return x.max(dim=2).values


class SetAbstraction(nn.Module):
    """FPS of N // ``stride`` centres, then the local aggregation of the
    cloud onto them (openpoints ``SetAbstraction`` with ``sa_layers 1``,
    ``sa_use_res False``)."""

    def __init__(self, in_channels, out_channels, stride, radius, nsample, generator=None):
        super().__init__()
        self.stride = stride
        self.aggregate = LocalAggregation(in_channels, out_channels, radius, nsample,
                                          generator=generator)

    def forward(self, xyz, feat, valid=None):
        """-> (new_xyz [B, M, 3], new_feat [B, M, C_out], new_valid or None)."""
        idx, new_valid = sample(xyz, None, self.stride, valid, 1, self.training)
        new_xyz = index_points(xyz, idx)
        return new_xyz, self.aggregate(xyz, new_xyz, feat, valid, new_valid), new_valid


class InvResMLP(nn.Module):
    """The inverted-residual block over a stage's own points: the local
    aggregation (each point its own query), then ``pw1`` (C -> expansion * C)
    + ``bn1`` + ReLU, ``pw2`` (back to C) + ``bn2``, plus the block's input,
    ReLU."""

    def __init__(self, channels, radius, nsample, expansion=4, generator=None):
        super().__init__()
        mid = expansion * channels
        self.aggregate = LocalAggregation(channels, channels, radius, nsample,
                                          generator=generator)
        self.pw1 = Linear(channels, mid, bias=False, generator=generator)
        self.bn1 = MaskedBatchNorm(mid)
        self.pw2 = Linear(mid, channels, bias=False, generator=generator)
        self.bn2 = MaskedBatchNorm(channels)

    def forward(self, xyz, feat, valid=None):
        """xyz [B, N, 3], feat [B, N, C] -> [B, N, C]."""
        a = self.aggregate(xyz, xyz, feat, valid, valid)
        with span("pnx.mlp"):
            mask = _mask(valid, xyz.shape[1])
            u = self.bn1(self.pw1(a), mask=mask, relu=True)
            return torch.relu(self.bn2(self.pw2(u), mask=mask) + feat)


class FeaturePropagation(nn.Module):
    """3-NN inverse-distance interpolation of the coarse features onto the
    fine points, after the fine skip features, then two Linear (no bias) +
    BN + ReLU layers (openpoints ``FeaturePropogation``)."""

    def __init__(self, skip_channels, coarse_channels, out_channels, generator=None):
        super().__init__()
        self.conv1 = Linear(skip_channels + coarse_channels, out_channels, bias=False,
                            generator=generator)
        self.bn1 = MaskedBatchNorm(out_channels)
        self.conv2 = Linear(out_channels, out_channels, bias=False, generator=generator)
        self.bn2 = MaskedBatchNorm(out_channels)

    def forward(self, xyz1, feat1, xyz2, feat2, valid1=None, valid2=None):
        """Fine cloud xyz1 / feat1, coarse xyz2 / feat2 -> [B, N1, out]."""
        x = torch.cat([feat1, three_interpolate(xyz2, xyz1, feat2, valid_src=valid2)], dim=-1)
        mask = _mask(valid1, xyz1.shape[1])
        x = self.bn1(self.conv1(x), mask=mask, relu=True)
        return self.bn2(self.conv2(x), mask=mask, relu=True)
