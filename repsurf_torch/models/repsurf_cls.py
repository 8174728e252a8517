"""Umbrella RepSurf classifiers (repsurf_tpu/models/repsurf_cls.py).

Inputs are [B, N, 3] point coordinates; the output is [B, num_class]
log-probabilities.  Parameter names are the reference's
(``surface_constructor``, ``sa1..``, ``classfier``, sic).
"""

import torch
from torch import nn

from ..nn.blocks import SurfaceAbstractionCD, UmbrellaSurfaceConstructor
from ..nn.layers import Dropout, Linear, MaskedBatchNorm

REPSURF_CHANNEL = 10


class RepSurfClassifier(nn.Module):
    """Umbrella RepSurf + PointNet++-SSG classifier (repsurf_ssg_umb).

    ``forward(points, inv_sign, generator)``: the per-sample random
    inversion of the umbrella normals is an input, ``inv_sign`` [B] of +-1,
    or None for no inversion (the train step draws it); ``generator`` feeds
    the head's dropout in training.  Parameters are drawn from
    ``generator`` at construction when one is given.
    """

    def __init__(self, num_class=15, group_size=8, return_polar=True,
                 head_dropout=0.4, sa_npoint=(512, 128), sa_radius=(0.2, 0.4),
                 sa_nsample=(32, 64), sa_mlp=((64, 64, 128), (128, 128, 256)),
                 final_mlp=(256, 512, 1024), head_hidden=(512, 256),
                 generator=None):
        super().__init__()
        gen = generator
        self.surface_constructor = UmbrellaSurfaceConstructor(
            group_size + 1, REPSURF_CHANNEL, generator=gen
        )
        feat_in = REPSURF_CHANNEL  # normals; each stage appends its features
        for i, (npoint, radius, nsample, mlp) in enumerate(
            zip(sa_npoint, sa_radius, sa_nsample, sa_mlp)
        ):
            self.add_module(f"sa{i + 1}", SurfaceAbstractionCD(
                feat_in, tuple(mlp), npoint=npoint, radius=radius,
                nsample=nsample, return_polar=return_polar, generator=gen,
            ))
            feat_in = REPSURF_CHANNEL + mlp[-1]
        self.n_sa = len(sa_npoint) + 1
        self.add_module(f"sa{self.n_sa}", SurfaceAbstractionCD(
            feat_in, tuple(final_mlp), group_all=True, return_polar=return_polar,
            generator=gen,
        ))
        layers, c = [], final_mlp[-1]
        for h in head_hidden:
            layers += [Linear(c, h, generator=gen), MaskedBatchNorm(h), nn.ReLU(),
                       Dropout(head_dropout)]
            c = h
        layers.append(Linear(c, num_class, generator=gen))
        self.classfier = nn.Sequential(*layers)

    def forward(self, points, inv_sign=None, generator=None):
        center = points[..., :3]
        normal = self.surface_constructor(center, inv_sign=inv_sign)
        feature = None
        for i in range(1, self.n_sa + 1):
            center, normal, feature, _ = getattr(self, f"sa{i}")(center, normal, feature)
        x = feature.reshape(feature.shape[0], -1)
        for layer in self.classfier:
            x = layer(x, generator=generator) if isinstance(layer, Dropout) else layer(x)
        return torch.log_softmax(x, dim=-1)


def repsurf_ssg_umb(num_class=15, **kw):
    """Reference recipe repsurf_ssg_umb (1.483 M parameters)."""
    return RepSurfClassifier(num_class=num_class, **kw)


def repsurf_ssg_umb_2x(num_class=15, **kw):
    """2x-width variant (repsurf_ssg_umb_2x)."""
    return RepSurfClassifier(
        num_class=num_class,
        sa_npoint=(512, 128, 32),
        sa_radius=(0.1, 0.2, 0.4),
        sa_nsample=(24, 24, 24),
        sa_mlp=((128, 128, 256), (256, 256, 512), (512, 512, 1024)),
        final_mlp=(1024, 1024, 2048),
        head_hidden=(512, 256),
        **kw,
    )
