"""Umbrella triangle fans and their surface features
(repsurf_tpu/geometry/umbrella.py).

kNN around every point, neighbours relative to the center, sorted by
azimuth, each paired with its roll-by-1 successor and the center into a
triangle fan.  Two styles, as in the JAX package:

  * 'cls': kNN column 0 (the point itself) dropped, plain azimuth, channels
    [center(3), polar(3), normal(3), const];
  * 'seg': the self column kept (its fans are degenerate and the repair
    overwrites them), the azimuth taken in the fixed rotated frame,
    channels [polar(3), normal(3), const, center(3)].
Without the plane constant both are [center(3), polar(3), normal(3)].

``umbrella_composition`` is the plain composition of the geometry
functions.  ``umbrella_features`` is what the model calls, routed as the
JAX package's (umbrella.py:147-157): on a CUDA device a cloud under 16,384
points with G*C <= 128 takes the fused kernel entry
(``ops/kernels/umbrella.umbrella_features_kernel``); otherwise the
composition over the routed ``knn`` (the window kernel at scene scale).
"""

import torch

from ..ops.gather import index_points, resort_points
from ..ops.kernels.knn import knn_plain
from ..ops.kernels.umbrella import MAX_LANES, fan_shape, umbrella_features_kernel
from ..ops.neighbors import WINDOW_MIN_N, knn
from .polar import azimuth, xyz2sphere
from .surface import cal_center, cal_const, cal_normal, repair_invalid_group

# the reference's truncated literals (0.7071, not sqrt(0.5)): 45 degrees
# about y then 45 about z, for row-vector points, the frame of the 'seg'
# azimuth sort (repsurf_tpu/geometry/umbrella.py:30-34)
FIXED_ROTATION_ROWS = (
    (0.5, -0.5, 0.7071),
    (0.7071, 0.7071, 0.0),
    (-0.5, 0.5, 0.7071),
)


def _sign_channels(style, return_dist):
    """(lo, hi): the channels the per-sample inversion flips, the normal
    and the plane constant it feeds (umbrella.py:167-172)."""
    if not return_dist:
        return 6, 9
    return (3, 7) if style == "seg" else (6, 10)


def fan_azimuth(rel, rotate=False):
    """The sorting key of center-relative neighbours rel [..., 3]:
    xyz2sphere's normalised phi, taken in the FIXED_ROTATION_ROWS frame when
    ``rotate`` (element by element, in the kernels' order, not as a
    matmul)."""
    x, y, z = rel.unbind(-1)
    if rotate:
        (r00, r01, _), (r10, r11, _), (r20, r21, _) = FIXED_ROTATION_ROWS
        x, y = x * r00 + y * r10 + z * r20, x * r01 + y * r11 + z * r21
    return azimuth(x, y)


def azimuth_near_ties(xyz, k, drop_self=False, rotate=False, valid=None, gap=1e-6):
    """[B, N] True where two of a point's fan neighbours lie within ``gap``
    in the sorting azimuth: their order, and so the fans, may differ between
    two implementations of the same function (an ulp of atan2 flips them).
    Exact copies (the kept self column, duplicate points) tie alike
    everywhere and do not count.  Over the plain kNN."""
    idx, _ = knn_plain(k, xyz, xyz, valid=valid)
    if drop_self:
        idx = idx[:, :, 1:]
    rel = index_points(xyz, idx) - xyz[:, :, None, :]
    phi, order = torch.sort(fan_azimuth(rel, rotate), dim=-1, stable=True)
    rel = resort_points(rel, order)
    same = (rel[:, :, 1:] == rel[:, :, :-1]).all(-1)
    return ((torch.diff(phi, dim=-1) < gap) & ~same).any(-1)


def umbrella_for_queries(xyz, queries, idx, rotate=False, return_dist=True, style="cls",
                         random_inv_sign=None):
    """Fan features from given kNN indices.

    Args:
      xyz: [B, N, 3] cloud; queries: [B, M, 3] fan centers.
      idx: [B, M, G] neighbour indices, the self column already dropped or
        kept.
      rotate: sort by the azimuth in the FIXED_ROTATION_ROWS frame.
      return_dist, style: the channels and their order (module doc).
      random_inv_sign: optional [B] float +-1 normal inversion per sample.

    Returns:
      [B, M, G, C].
    """
    rel = index_points(xyz, idx) - queries[:, :, None, :]
    order = torch.argsort(fan_azimuth(rel, rotate), dim=-1, stable=True)
    sorted_xyz = resort_points(rel, order)
    rolled = torch.roll(sorted_xyz, -1, dims=2)
    fans = torch.stack([torch.zeros_like(sorted_xyz), sorted_xyz, rolled], dim=-2)
    normal, bad = cal_normal(fans, random_inv_sign=random_inv_sign, is_group=True)
    t_center = cal_center(fans)
    polar = xyz2sphere(t_center)
    if not return_dist:
        normal, t_center = repair_invalid_group(bad, normal, t_center)
        return torch.cat([t_center, polar, normal], dim=-1)
    pos = cal_const(normal, t_center)
    normal, t_center, pos = repair_invalid_group(bad, normal, t_center, pos)
    if style == "seg":
        return torch.cat([polar, normal, pos, t_center], dim=-1)
    return torch.cat([t_center, polar, normal, pos], dim=-1)


def umbrella_composition(xyz, k, drop_self=False, rotate=False, return_dist=True, style="cls",
                         valid=None, random_inv_sign=None, knn_fn=None):
    """Plain composition of the umbrella geometry over the cloud's own kNN
    (umbrella.py:181-195 of the JAX package).

    Args:
      xyz: [B, N, 3].
      k: kNN size (group_size + 1).
      drop_self: drop kNN column 0 (G = k - 1), else keep it (G = k).
      rotate, return_dist, style, random_inv_sign: as ``umbrella_for_queries``.
      valid: optional [B] counts.
      knn_fn: the kNN to use; the routed ``neighbors.knn`` when None.

    Returns:
      [B, N, G, C].
    """
    idx, _ = (knn_fn or knn)(k, xyz, xyz, valid=valid)
    if drop_self:
        idx = idx[:, :, 1:]
    return umbrella_for_queries(xyz, xyz, idx, rotate=rotate, return_dist=return_dist,
                                style=style, random_inv_sign=random_inv_sign)


def umbrella_features(xyz, k, valid=None, random_inv_sign=None, style="cls", return_dist=True,
                      impl="auto"):
    """The umbrella constructor's geometry stage: points -> per-fan features.

    Args:
      impl: 'auto' (see the module doc), 'kernel' (the kernel entry, which
        runs its plain version for a CPU tensor) or 'composition'.

    The kernel leaves normals un-inverted; the per-sample +-1 sign is
    uniform within a sample, so it commutes with the repair gather and is
    applied to the normal and constant channels here.  The composition
    applies it inside ``cal_normal``.

    Returns:
      [B, N, G, C]; G = k - 1 ('cls') or k, C = 10 or 9.
    """
    drop_self = style == "cls"
    if impl == "auto":
        g, c = fan_shape(k, drop_self, return_dist)
        small = xyz.shape[1] < WINDOW_MIN_N
        impl = "kernel" if xyz.is_cuda and g * c <= MAX_LANES and small else "composition"
    if impl == "composition":
        return umbrella_composition(xyz, k, drop_self=drop_self, rotate=style == "seg",
                                    return_dist=return_dist, style=style, valid=valid,
                                    random_inv_sign=random_inv_sign)
    if impl != "kernel":
        raise ValueError(f"impl must be 'auto', 'kernel' or 'composition', got {impl!r}")
    feat = umbrella_features_kernel(xyz, k, drop_self=drop_self, rotate=style == "seg",
                                    return_dist=return_dist, style=style, valid=valid)
    if random_inv_sign is None:
        return feat
    lo, hi = _sign_channels(style, return_dist)
    chan = torch.arange(feat.shape[-1], device=feat.device)
    inv = random_inv_sign.to(feat)[:, None, None, None]
    return feat * torch.where((chan >= lo) & (chan < hi), inv, 1.0)
