"""Triangular RepSurf constructor (repsurf_tpu/nn/triangular.py): each point
reconstructs one triangle from its k = 3 nearest points of the context
cloud (the point itself among them when the context is its own cloud); the
unit normal, the centroid and optionally the plane constant are its surface
features.  Degenerate triangles take the sample's first valid point's.
"""

import torch
from torch import nn

from ..geometry.surface import cal_center, cal_const, cal_normal, repair_invalid_points
from ..ops.gather import index_points
from ..ops.neighbors import knn


def knn_recons(k, center, context, valid=None):
    """kNN triangle vertices: [B, N, k, 3] (on a CUDA device the kNN is the
    brute kernel at these cloud sizes)."""
    idx, _ = knn(k, context, center, valid=valid)
    return index_points(context, idx)


class SurfaceConstructor(nn.Module):
    """Triangular surface constructor, no parameters.

    Plane A(x-x0) + B(y-y0) + C(z-z0) = 0 with A^2+B^2+C^2 = 1 and A > 0,
    optionally inverted per sample: ``forward(center, context, valid,
    inv_sign)`` takes the [B] +-1 inversion as an input (the train step
    draws it), or None for none.  Returns torch.cat of (normal [B,N,3],
    center [B,N,3][, plane constant [B,N,1] with ``return_dist``]) on the
    channel axis, the layout the classifier's SA stages read.
    """

    def __init__(self, k=3, recons_type="knn", return_dist=False):
        super().__init__()
        if recons_type != "knn":
            raise NotImplementedError(recons_type)
        self.k = k
        self.return_dist = return_dist

    def forward(self, center, context=None, valid=None, inv_sign=None):
        if context is None:
            context = center
        group_xyz = knn_recons(self.k, center, context, valid=valid)
        normal, bad = cal_normal(group_xyz, random_inv_sign=inv_sign, is_group=False)
        parts = [normal, cal_center(group_xyz)]
        if self.return_dist:
            parts.append(cal_const(normal, parts[1]))
        return torch.cat(repair_invalid_points(bad, *parts), dim=-1)
