"""RepSurf blocks for classification (repsurf_tpu/nn/blocks.py), as
``nn.Module``s over channels-last tensors with optional valid counts.

Module attribute names follow the reference's torch modules
(``surface_constructor.mlps.i``, ``sa{i}.mlp_l0 / bn_l0 / mlp_f0 / bn_f0 /
mlp_convs.j / mlp_bns.j``), so a reference state dict maps one to one.
"""

import torch
from torch import nn

from ..geometry.polar import xyz2sphere
from ..geometry.umbrella import umbrella_features
from ..ops.gather import index_points_multi
from ..ops.kernels.ball_group import ball_group_feature
from ..ops.masking import counts_to_mask
from ..ops.sampling import farthest_point_sample
from .layers import Linear, MaskedBatchNorm


class SharedMLP(nn.Module):
    """Linear + BN + ReLU stack (``mlp_convs.j`` / ``mlp_bns.j``)."""

    def __init__(self, in_channel, features, generator=None):
        super().__init__()
        self.mlp_convs = nn.ModuleList()
        self.mlp_bns = nn.ModuleList()
        for f in features:
            self.mlp_convs.append(Linear(in_channel, f, generator=generator))
            self.mlp_bns.append(MaskedBatchNorm(f))
            in_channel = f

    def forward(self, x, mask=None):
        for conv, bn in zip(self.mlp_convs, self.mlp_bns):
            x = torch.relu(bn(conv(x), mask=mask))
        return x


class UmbrellaSurfaceConstructor(nn.Module):
    """Umbrella RepSurf features, classification style: the fused umbrella
    geometry, a 3-layer MLP and a sum over the fans
    (``mlps`` = Linear, BN, ReLU, Linear, BN, ReLU, Linear)."""

    def __init__(self, k, in_channel=10, generator=None):
        super().__init__()
        self.k = k
        c = in_channel
        self.mlps = nn.Sequential(
            Linear(c, c, bias=False, generator=generator),
            MaskedBatchNorm(c),
            nn.ReLU(),
            Linear(c, c, generator=generator),
            MaskedBatchNorm(c),
            nn.ReLU(),
            Linear(c, c, generator=generator),
        )

    def forward(self, center, valid=None, inv_sign=None):
        """center [B, N, 3] -> [B, N, in_channel].  ``inv_sign``: optional
        [B] +-1 per-sample normal inversion."""
        feat = umbrella_features(center, self.k, valid=valid, random_inv_sign=inv_sign)
        mask = None
        if valid is not None:
            mask = counts_to_mask(valid, center.shape[1])[:, :, None]
        x = feat
        for layer in self.mlps:
            x = layer(x, mask=mask) if isinstance(layer, MaskedBatchNorm) else layer(x)
        return x.sum(dim=2)


class SurfaceAbstractionCD(SharedMLP):
    """Surface abstraction with channel de-differentiation, ball grouping
    (repsurf_tpu/nn/blocks.py SurfaceAbstractionCD, grouping 'ball').

    It is the trailing SharedMLP (mlp[1:]) plus the CD first layer: the
    position and feature channels get their own Linear + BN (``mlp_l0`` /
    ``bn_l0``, ``mlp_f0`` / ``bn_f0``), summed before the stack and the
    max-pool over the neighbors.  Subclassing keeps the reference's flat
    parameter names.

    With ``group_all`` the whole cloud is one group around the origin.
    Otherwise FPS picks ``npoint`` centers and ``ball_group_feature``
    groups ``nsample`` neighbors within ``radius`` of each.
    """

    def __init__(self, feat_channel, mlp, npoint=None, radius=None, nsample=None,
                 group_all=False, return_polar=True, generator=None):
        super().__init__(mlp[0], mlp[1:], generator=generator)
        if not group_all and None in (npoint, radius, nsample):
            raise ValueError("ball grouping needs npoint, radius and nsample")
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.group_all = group_all
        self.return_polar = return_polar
        pos_channel = 6 if return_polar else 3
        self.mlp_l0 = Linear(pos_channel, mlp[0], generator=generator)
        self.bn_l0 = MaskedBatchNorm(mlp[0])
        self.mlp_f0 = Linear(feat_channel, mlp[0], generator=generator)
        self.bn_f0 = MaskedBatchNorm(mlp[0])

    def forward(self, center, normal, feature, valid=None):
        """center [B,N,3], normal [B,N,D], feature [B,N,C] or None ->
        (new_center [B,M,3], new_normal [B,M,D], new_feature [B,M,mlp[-1]],
        new_valid [B] or None)."""
        b = center.shape[0]
        if self.group_all:
            new_center = torch.zeros((b, 1, 3), dtype=center.dtype, device=center.device)
            new_normal = new_center
            new_valid = None if valid is None else torch.ones_like(valid)
            group_center = center[:, None]
            if self.return_polar:
                group_center = torch.cat([group_center, xyz2sphere(group_center)], dim=-1)
            parts = [group_center, normal[:, None]]
            if feature is not None:
                parts.append(feature[:, None])
            new_feature = torch.cat(parts, dim=-1)
            pc = group_center.shape[-1]
            pos, feat = new_feature[..., :pc], new_feature[..., pc:]
        else:
            idx = farthest_point_sample(center, self.npoint, valid=valid)
            new_valid = None if valid is None else torch.clamp(valid, max=self.npoint)
            new_center, new_normal = index_points_multi(idx, center, normal)
            pos, feat = ball_group_feature(
                self.radius, self.nsample, center, new_center,
                [center, normal, feature], valid=valid,
                return_polar=self.return_polar,
            )
        mask = None
        if new_valid is not None:
            mask = counts_to_mask(new_valid, pos.shape[1])[:, :, None]
        loc = self.bn_l0(self.mlp_l0(pos), mask=mask)
        fea = self.bn_f0(self.mlp_f0(feat), mask=mask)
        x = super().forward(torch.relu(loc + fea), mask=mask)
        return new_center, new_normal, x.amax(dim=2), new_valid
