"""Umbrella triangle fans and their surface features, classification style
(repsurf_tpu/geometry/umbrella.py).

kNN around every point with the self column dropped, neighbors relative to
the center, sorted by azimuth, each paired with its roll-by-1 successor and
the center into a triangle fan.  ``umbrella_composition`` is the plain
composition of the geometry functions; ``umbrella_features`` is what the
model calls, and it runs the fused umbrella kernel on a CUDA device.
"""

import torch

from ..ops.gather import index_points, resort_points
from ..ops.kernels.umbrella import umbrella_fan_features
from ..ops.neighbors import knn
from .polar import xyz2sphere
from .surface import cal_center, cal_const, cal_normal, repair_invalid_group

# the per-sample inversion flips the normal and the plane constant:
# channels 6: of [center(3), polar(3), normal(3), const]
_NORMAL_START = 6


def group_by_umbrella(xyz, new_xyz, k=9, valid=None):
    """Umbrella fans around every query, the self column dropped.

    Args:
      xyz: [B, N, 3] cloud searched for neighbors.
      new_xyz: [B, M, 3] fan centers.
      k: kNN size (group_size + 1).
      valid: optional [B] counts for xyz.

    Returns:
      [B, M, k-1, 3, 3] fan vertices relative to each center; vertex 0 is
      the center (origin), then neighbor g and its azimuth successor.
    """
    idx, _ = knn(k, xyz, new_xyz, valid=valid)
    group_norm = index_points(xyz, idx[:, :, 1:]) - new_xyz[:, :, None, :]
    phi = xyz2sphere(group_norm)[..., 2]
    order = torch.argsort(phi, dim=-1, stable=True)
    sorted_xyz = resort_points(group_norm, order)
    rolled = torch.roll(sorted_xyz, -1, dims=2)
    return torch.stack([torch.zeros_like(sorted_xyz), sorted_xyz, rolled], dim=-2)


def umbrella_composition(xyz, k, valid=None, random_inv_sign=None):
    """Plain composition of the umbrella geometry (umbrella.py:181-195 of
    the JAX package, style 'cls' with the plane constant).

    Args:
      xyz: [B, N, 3].
      k: kNN size (group_size + 1).
      valid: optional [B] counts.
      random_inv_sign: optional [B] float +-1 normal inversion per sample.

    Returns:
      [B, N, k-1, 10] channels [center(3), polar(3), normal(3), const].
    """
    fans = group_by_umbrella(xyz, xyz, k=k, valid=valid)
    normal, bad = cal_normal(fans, random_inv_sign=random_inv_sign, is_group=True)
    t_center = cal_center(fans)
    polar = xyz2sphere(t_center)
    pos = cal_const(normal, t_center)
    normal, t_center, pos = repair_invalid_group(bad, normal, t_center, pos)
    return torch.cat([t_center, polar, normal, pos], dim=-1)


def umbrella_features(xyz, k, valid=None, random_inv_sign=None):
    """The umbrella constructor's geometry stage: points -> per-fan features.

    Same result as ``umbrella_composition``.  The fused kernel (or its
    plain version on the CPU) leaves normals un-inverted; the per-sample
    +-1 sign is uniform within a sample, so it commutes with the repair
    gather and is applied to the normal and constant channels here.

    Returns:
      [B, N, k-1, 10].
    """
    feat = umbrella_fan_features(xyz, k, valid=valid)
    if random_inv_sign is None:
        return feat
    inv = random_inv_sign.to(feat)[:, None, None, None]
    return torch.cat([feat[..., :_NORMAL_START], feat[..., _NORMAL_START:] * inv], dim=-1)
