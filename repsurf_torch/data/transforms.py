"""FPS preprocessing, the train-time augmentations and the vote rescale
(repsurf_tpu/data/transforms.py).

Every random draw comes from an explicit ``torch.Generator`` on the points'
device, or is injected as U(0, 1) tensors (the tests feed both frameworks
the same numbers).
"""

import torch

from ..ops.gather import index_points
from ..ops.kernels.fps import fps


def _uniforms(pts, generator, uniforms):
    if (generator is None) == (uniforms is None):
        raise ValueError("give exactly one of generator / uniforms")
    if uniforms is None:
        uniforms = torch.rand((pts.shape[0], 1, 3), generator=generator,
                              device=pts.device, dtype=pts.dtype)
    return uniforms


def scale_point_cloud(pts, generator=None, uniforms=None, scale_range=0.2):
    """Per-cloud anisotropic random scale U(1-r, 1+r) per axis.

    Args:
      pts: [B, N, 3].
      generator: a ``torch.Generator`` on pts' device to draw the uniforms,
        or None when ``uniforms`` is given.
      uniforms: optional [B, 1, 3] draws from U(0, 1).
      scale_range: r.
    """
    return pts * ((_uniforms(pts, generator, uniforms) * 2.0 - 1.0) * scale_range + 1.0)


def shift_point_cloud(pts, generator=None, uniforms=None, shift_range=0.2):
    """Per-cloud random translation U(-r, r) per axis; the arguments as
    ``scale_point_cloud``'s."""
    return pts + (_uniforms(pts, generator, uniforms) * 2.0 - 1.0) * shift_range


def transform_point_cloud(pts, generator=None, aug_scale=False, aug_shift=False,
                          scale_factor=0.5, shift_factor=0.3, uniforms=None):
    """Flag-driven train-time augmentation, off by default as in the recipe:
    the scale (U(1 - scale_factor, 1 + scale_factor)) first, then the shift
    (U(-shift_factor, shift_factor)), each drawn from ``generator`` in that
    order, or taken from ``uniforms``, a pair of optional [B, 1, 3] U(0, 1)
    draws (scale, shift)."""
    u_scale, u_shift = uniforms if uniforms is not None else (None, None)
    if aug_scale:
        pts = scale_point_cloud(pts, None if u_scale is not None else generator,
                                u_scale, scale_factor)
    if aug_shift:
        pts = shift_point_cloud(pts, None if u_shift is not None else generator,
                                u_shift, shift_factor)
    return pts


def fps_sample(pts, npoint):
    """FPS-downsample a batch of clouds: [B, N, C] -> [B, npoint, C]; the
    leading 3 channels drive the sampling.  Coordinate-only clouds take the
    FPS kernel's own sampled coordinates (equal to the gather)."""
    if pts.shape[-1] == 3:
        return fps(pts, npoint, return_xyz=True)[1]
    return index_points(pts, fps(pts[..., :3].contiguous(), npoint))
