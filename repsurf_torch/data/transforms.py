"""FPS preprocessing and the vote rescale (repsurf_tpu/data/transforms.py).
"""

import torch

from ..ops.gather import index_points
from ..ops.kernels.fps import fps


def scale_point_cloud(pts, generator=None, uniforms=None, scale_range=0.2):
    """Per-cloud anisotropic random scale U(1-r, 1+r) per axis.

    Args:
      pts: [B, N, 3].
      generator: a ``torch.Generator`` on pts' device to draw the uniforms,
        or None when ``uniforms`` is given.
      uniforms: optional [B, 1, 3] draws from U(0, 1).
      scale_range: r.
    """
    if (generator is None) == (uniforms is None):
        raise ValueError("give exactly one of generator / uniforms")
    if uniforms is None:
        uniforms = torch.rand((pts.shape[0], 1, 3), generator=generator,
                              device=pts.device, dtype=pts.dtype)
    return pts * ((uniforms * 2.0 - 1.0) * scale_range + 1.0)


def fps_sample(pts, npoint):
    """FPS-downsample a batch of clouds: [B, N, C] -> [B, npoint, C]; the
    leading 3 channels drive the sampling.  Coordinate-only clouds take the
    FPS kernel's own sampled coordinates (equal to the gather)."""
    if pts.shape[-1] == 3:
        return fps(pts, npoint, return_xyz=True)[1]
    return index_points(pts, fps(pts[..., :3].contiguous(), npoint))
