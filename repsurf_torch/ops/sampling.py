"""Furthest-point sampling (repsurf_tpu/ops/sampling.py).

Seed index 0, running min-distance, argmax with the lowest index on ties,
padding rows never selected.  For ``npoint > valid[b]`` the extra slots
repeat already-selected points; callers mask them with
``m_valid = min(npoint, valid)``.
"""

from .kernels.fps import fps


def farthest_point_sample(xyz, npoint, valid=None):
    """[B, N, 3] -> [B, npoint] int32 indices (the FPS kernel on a CUDA
    device, its plain version on the CPU)."""
    return fps(xyz, npoint, valid=valid)
