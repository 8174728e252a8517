"""RepSurf blocks (repsurf_tpu/nn/blocks.py), as ``nn.Module``s over
channels-last tensors with optional valid counts.

Module attribute names follow the reference's torch modules
(``surface_constructor.mlps.i``, ``sa{i}.mlp_l0 / bn_l0 / mlp_f0 / bn_f0 /
mlp_convs.j / mlp_bns.j``, ``fp{i}.mlp_f0 / norm_f0 / mlp_s0 / norm_s0 /
mlp_convs.j / mlp_bns.j``), so a reference state dict maps one to one.
Blocks whose behaviour differs between training and evaluation (sectorized
FPS, BN statistics) read the module's ``training`` flag.
"""

import torch
from torch import nn

from ..geometry.polar import xyz2sphere
from ..geometry.umbrella import umbrella_features
from ..ops.gather import index_points, index_points_multi
from ..ops.interpolate import three_interpolate
from ..ops.kernels.ball_group import ball_group_feature
from ..ops.masking import counts_to_mask
from ..ops.neighbors import knn
from ..ops.sampling import farthest_point_sample
from ..ops.sector import sectorized_fps
from .layers import Linear, MaskedBatchNorm, run_layers


def _mask(valid, n):
    """[B, n, 1] bool rows-to-count for MaskedBatchNorm, or None."""
    return None if valid is None else counts_to_mask(valid, n)[:, :, None]


def sample(center, npoint, stride, valid, num_sector, train):
    """FPS of ``npoint`` centers (classification) or N // ``stride``
    (segmentation), sectorized over ``num_sector`` azimuth sectors in
    training -> (idx [B, M], new valid counts or None)."""
    if (npoint is None) == (stride is None):
        raise ValueError("exactly one of npoint / stride must be set")
    m = npoint if npoint is not None else max(center.shape[1] // stride, 1)
    new_valid = None
    if valid is not None:
        new_valid = valid // stride if stride is not None else torch.clamp(valid, max=m)
    if num_sector > 1 and train:
        idx = sectorized_fps(center, m, num_sector, valid=valid, m_valid=new_valid)
    else:
        idx = farthest_point_sample(center, m, valid=valid)
    return idx, new_valid


class SharedMLP(nn.Module):
    """Linear + BN + ReLU stack (``mlp_convs.j`` / ``mlp_bns.j``), the ReLU
    fused into the norm."""

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
            x = bn(conv(x), mask=mask, relu=True)
        return x


class UmbrellaSurfaceConstructor(nn.Module):
    """Umbrella RepSurf features: the umbrella geometry of ``style``, an MLP
    and a pool over the fans (``aggr_type`` 'sum', 'avg' or 'max').

    'cls': ``mlps`` = Linear (no bias), BN, ReLU, Linear, BN, ReLU, Linear.
    'seg': ``mlps`` = Linear, BN, ReLU, Linear.
    The first Linear takes the geometry's 10 channels, or 9 without the
    plane constant (``return_dist=False``); every layer gives ``in_channel``.
    """

    def __init__(self, k, in_channel=10, style="cls", aggr_type="sum", return_dist=True,
                 generator=None):
        super().__init__()
        if aggr_type not in ("sum", "avg", "max"):
            raise ValueError(f"aggr_type must be sum, avg or max, got {aggr_type!r}")
        self.k = k
        self.style = style
        self.aggr_type = aggr_type
        self.return_dist = return_dist
        c, f = in_channel, 10 if return_dist else 9
        if style == "seg":
            self.mlps = nn.Sequential(
                Linear(f, c, generator=generator),
                MaskedBatchNorm(c),
                nn.ReLU(),
                Linear(c, c, generator=generator),
            )
            return
        self.mlps = nn.Sequential(
            Linear(f, c, bias=False, generator=generator),
            MaskedBatchNorm(c),
            nn.ReLU(),
            Linear(c, c, generator=generator),
            MaskedBatchNorm(c),
            nn.ReLU(),
            Linear(c, c, generator=generator),
        )

    def forward(self, center, valid=None, inv_sign=None):
        """center [B, N, 3] -> [B, N, channels].  ``inv_sign``: optional
        [B] +-1 per-sample normal inversion."""
        feat = umbrella_features(center, self.k, valid=valid, random_inv_sign=inv_sign,
                                 style=self.style, return_dist=self.return_dist)
        x = run_layers(self.mlps, feat, _mask(valid, center.shape[1]))
        if self.aggr_type == "max":
            return x.amax(dim=2)
        return x.mean(dim=2) if self.aggr_type == "avg" else x.sum(dim=2)


class SurfaceAbstractionCD(SharedMLP):
    """Surface abstraction with channel de-differentiation
    (repsurf_tpu/nn/blocks.py SurfaceAbstractionCD).

    It is the trailing SharedMLP (mlp[1:]) plus the CD first layer: the
    position and feature channels get their own Linear + BN (``mlp_l0`` /
    ``bn_l0``, ``mlp_f0`` / ``bn_f0``), summed before the stack and the
    max-pool over the neighbors.  Subclassing keeps the reference's flat
    parameter names.

    With ``group_all`` the whole cloud is one group around the origin.
    Otherwise FPS picks the centers, ``npoint`` of them (classification) or
    N // ``stride`` (segmentation; sectorized over ``num_sector`` azimuth
    sectors in training), and the neighbours are grouped by ``grouping``:
    'ball' (``ball_group_feature``, ``nsample`` within ``radius``) or 'knn'
    (the ``nsample`` nearest).
    """

    def __init__(self, feat_channel, mlp, npoint=None, radius=None, nsample=None,
                 group_all=False, return_polar=True, stride=None, grouping="ball",
                 num_sector=1, generator=None):
        super().__init__(mlp[0], mlp[1:], generator=generator)
        if not group_all:
            if (npoint is None) == (stride is None):
                raise ValueError("exactly one of npoint / stride must be set")
            if nsample is None or (grouping == "ball" and radius is None):
                raise ValueError(f"{grouping} grouping needs nsample (and a radius for ball)")
        self.npoint = npoint
        self.stride = stride
        self.radius = radius
        self.nsample = nsample
        self.group_all = group_all
        self.return_polar = return_polar
        self.grouping = grouping
        self.num_sector = num_sector
        pos_channel = 6 if return_polar else 3
        self.mlp_l0 = Linear(pos_channel, mlp[0], generator=generator)
        self.bn_l0 = MaskedBatchNorm(mlp[0])
        self.mlp_f0 = Linear(feat_channel, mlp[0], generator=generator)
        self.bn_f0 = MaskedBatchNorm(mlp[0])

    def _knn_group(self, center, new_center, tensors, valid):
        """kNN grouping -> (pos, feat): relative coordinates (+ polar) and
        the grouped normal and feature channels."""
        gidx, _ = knn(self.nsample, center, new_center, valid=valid)
        group_center, *rest = index_points_multi(gidx, center, *tensors)
        pos = group_center - new_center[:, :, None]
        if self.return_polar:
            pos = torch.cat([pos, xyz2sphere(pos)], dim=-1)
        return pos, torch.cat([t for t in rest if t is not None], dim=-1)

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
            idx, new_valid = sample(center, self.npoint, self.stride, valid, self.num_sector,
                                    self.training)
            new_center, new_normal = index_points_multi(idx, center, normal)
            if self.grouping == "knn":
                pos, feat = self._knn_group(center, new_center, [normal, feature], valid)
            else:
                pos, feat = ball_group_feature(
                    self.radius, self.nsample, center, new_center,
                    [center, normal, feature], valid=valid,
                    return_polar=self.return_polar,
                )
        mask = _mask(new_valid, pos.shape[1])
        loc = self.bn_l0(self.mlp_l0(pos), mask=mask)
        fea = self.bn_f0(self.mlp_f0(feat), mask=mask)
        x = super().forward(torch.relu(loc + fea), mask=mask)
        return new_center, new_normal, x.amax(dim=2), new_valid


class SurfaceFeaturePropagationCD(SharedMLP):
    """Feature propagation with channel de-differentiation
    (repsurf_tpu/nn/blocks.py SurfaceFeaturePropagationCD): 3-NN
    inverse-distance interpolation of the Linear + BN of the coarse
    features (``mlp_f0`` / ``norm_f0``), summed with the Linear + BN of the
    skip features (``mlp_s0`` / ``norm_s0``, absent when ``skip_channel`` is
    None), ReLU, then the Linear + BN + ReLU stack of mlp[1:]."""

    def __init__(self, prev_channel, skip_channel, mlp, generator=None):
        super().__init__(mlp[0], mlp[1:], generator=generator)
        self.mlp_f0 = Linear(prev_channel, mlp[0], generator=generator)
        self.norm_f0 = MaskedBatchNorm(mlp[0])
        self.skip = skip_channel is not None
        if self.skip:
            self.mlp_s0 = Linear(skip_channel, mlp[0], generator=generator)
            self.norm_s0 = MaskedBatchNorm(mlp[0])

    def forward(self, xyz1, feat1, xyz2, feat2, valid1=None, valid2=None):
        """xyz1 / feat1: the fine cloud and its skip features (None without
        a skip); xyz2 / feat2: the coarse cloud -> [B, N1, mlp[-1]]."""
        mask1 = _mask(valid1, xyz1.shape[1])
        f2 = self.norm_f0(self.mlp_f0(feat2), mask=_mask(valid2, feat2.shape[1]))
        x = three_interpolate(xyz2, xyz1, f2, valid_src=valid2)
        if self.skip:
            x = x + self.norm_s0(self.mlp_s0(feat1), mask=mask1)
        return super().forward(torch.relu(x), mask=mask1)


class PointNetSetAbstraction(SharedMLP):
    """PointNet++ SA baseline (repsurf_tpu/nn/blocks.py
    PointNetSetAbstraction): FPS (sectorized in training with
    ``num_sector`` > 1), kNN grouping of [relative xyz, features],
    ``mlp_convs.j`` / ``mlp_bns.j`` and a max-pool over the neighbours.
    ``in_channel`` counts the grouped channels, 3 + the feature's."""

    def __init__(self, in_channel, mlp, stride=None, npoint=None, nsample=32, num_sector=1,
                 generator=None):
        super().__init__(in_channel, mlp, generator=generator)
        self.stride = stride
        self.npoint = npoint
        self.nsample = nsample
        self.num_sector = num_sector

    def forward(self, xyz, feature, valid=None):
        """xyz [B,N,3], feature [B,N,C] or None -> (new_xyz [B,M,3],
        new_feature [B,M,mlp[-1]], new_valid [B] or None)."""
        idx, new_valid = sample(xyz, self.npoint, self.stride, valid, self.num_sector,
                                self.training)
        new_xyz = index_points(xyz, idx)
        gidx, _ = knn(self.nsample, xyz, new_xyz, valid=valid)
        group_xyz, group_feature = index_points_multi(gidx, xyz, feature)
        parts = [group_xyz - new_xyz[:, :, None]]
        if group_feature is not None:
            parts.append(group_feature)
        x = super().forward(torch.cat(parts, dim=-1), mask=_mask(new_valid, new_xyz.shape[1]))
        return new_xyz, x.amax(dim=2), new_valid


class PointNetFeaturePropagation(SharedMLP):
    """PointNet++ FP baseline (repsurf_tpu/nn/blocks.py
    PointNetFeaturePropagation): 3-NN inverse-distance interpolation of the
    coarse features, concatenated after the skip features (when given),
    then ``mlp_convs.j`` / ``mlp_bns.j``.  ``in_channel`` counts skip +
    coarse channels."""

    def forward(self, xyz1, feat1, xyz2, feat2, valid1=None, valid2=None):
        """xyz1 / feat1: the fine cloud and its skip features (or None);
        xyz2 / feat2: the coarse cloud -> [B, N1, mlp[-1]]."""
        x = three_interpolate(xyz2, xyz1, feat2, valid_src=valid2)
        if feat1 is not None:
            x = torch.cat([feat1, x], dim=-1)
        return super().forward(x, mask=_mask(valid1, xyz1.shape[1]))
