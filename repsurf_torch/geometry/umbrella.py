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

``umbrella_composition`` is the plain composition of the geometry
functions.  ``umbrella_features`` is what the model calls: for 'cls' it runs
the fused umbrella kernel on a CUDA device; for 'seg' it is the composition
over the routed ``knn`` (the window kernel at scene scale), as the JAX
package's route is there (umbrella.py:147-157).
"""

import torch

from ..ops.gather import index_points, resort_points
from ..ops.kernels.umbrella import umbrella_fan_features
from ..ops.neighbors import knn
from .polar import xyz2sphere
from .surface import cal_center, cal_const, cal_normal, repair_invalid_group

# the reference's truncated literals (0.7071, not sqrt(0.5)): 45 degrees
# about y then 45 about z, for row-vector points, the frame of the 'seg'
# azimuth sort (repsurf_tpu/geometry/umbrella.py:30-34)
FIXED_ROTATION_ROWS = (
    (0.5, -0.5, 0.7071),
    (0.7071, 0.7071, 0.0),
    (-0.5, 0.5, 0.7071),
)

# the per-sample inversion flips the normal and the plane constant:
# channels 6: of the 'cls' order [center(3), polar(3), normal(3), const]
_NORMAL_START = 6


def group_by_umbrella(xyz, new_xyz, k=9, valid=None, style="cls", knn_fn=None):
    """Umbrella fans around every query.

    Args:
      xyz: [B, N, 3] cloud searched for neighbors.
      new_xyz: [B, M, 3] fan centers.
      k: kNN size (group_size + 1).
      valid: optional [B] counts for xyz.
      style: 'cls' (self column dropped, plain azimuth) or 'seg' (self
        kept, azimuth in the FIXED_ROTATION_ROWS frame).
      knn_fn: the kNN to use; the routed ``neighbors.knn`` when None.

    Returns:
      [B, M, G, 3, 3] fan vertices relative to each center, G = k - 1
      ('cls') or k ('seg'); vertex 0 is the center (origin), then
      neighbor g and its azimuth successor.
    """
    idx, _ = (knn_fn or knn)(k, xyz, new_xyz, valid=valid)
    if style == "cls":
        idx = idx[:, :, 1:]
    group_norm = index_points(xyz, idx) - new_xyz[:, :, None, :]
    frame = group_norm
    if style == "seg":
        rot = torch.tensor(FIXED_ROTATION_ROWS, dtype=xyz.dtype, device=xyz.device)
        frame = group_norm @ rot
    phi = xyz2sphere(frame)[..., 2]
    order = torch.argsort(phi, dim=-1, stable=True)
    sorted_xyz = resort_points(group_norm, order)
    rolled = torch.roll(sorted_xyz, -1, dims=2)
    return torch.stack([torch.zeros_like(sorted_xyz), sorted_xyz, rolled], dim=-2)


def umbrella_composition(xyz, k, valid=None, random_inv_sign=None, style="cls",
                         knn_fn=None):
    """Plain composition of the umbrella geometry (umbrella.py:181-195 of
    the JAX package, with the plane constant).

    Args:
      xyz: [B, N, 3].
      k: kNN size (group_size + 1).
      valid: optional [B] counts.
      random_inv_sign: optional [B] float +-1 normal inversion per sample.
      style: 'cls' or 'seg' (see the module doc).
      knn_fn: the kNN to use; the routed ``neighbors.knn`` when None.

    Returns:
      [B, N, G, 10] in the style's channel order.
    """
    fans = group_by_umbrella(xyz, xyz, k=k, valid=valid, style=style, knn_fn=knn_fn)
    normal, bad = cal_normal(fans, random_inv_sign=random_inv_sign, is_group=True)
    t_center = cal_center(fans)
    polar = xyz2sphere(t_center)
    pos = cal_const(normal, t_center)
    normal, t_center, pos = repair_invalid_group(bad, normal, t_center, pos)
    if style == "seg":
        return torch.cat([polar, normal, pos, t_center], dim=-1)
    return torch.cat([t_center, polar, normal, pos], dim=-1)


def umbrella_features(xyz, k, valid=None, random_inv_sign=None, style="cls"):
    """The umbrella constructor's geometry stage: points -> per-fan features.

    'cls': the fused kernel (or its plain version on the CPU), which leaves
    normals un-inverted; the per-sample +-1 sign is uniform within a sample,
    so it commutes with the repair gather and is applied to the normal and
    constant channels here.  'seg': ``umbrella_composition`` over the
    routed kNN, the sign applied inside ``cal_normal``.

    Returns:
      [B, N, G, 10].
    """
    if style == "seg":
        return umbrella_composition(xyz, k, valid=valid,
                                    random_inv_sign=random_inv_sign, style="seg")
    feat = umbrella_fan_features(xyz, k, valid=valid)
    if random_inv_sign is None:
        return feat
    inv = random_inv_sign.to(feat)[:, None, None, None]
    return torch.cat([feat[..., :_NORMAL_START], feat[..., _NORMAL_START:] * inv], dim=-1)
