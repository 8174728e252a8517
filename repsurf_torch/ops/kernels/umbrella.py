"""Fused umbrella geometry: the CUDA kernel ``csrc/umbrella.cu`` and its
plain PyTorch version.

Replaces repsurf_tpu/ops/pallas/umbrella.py:_umbrella_tq_kernel (reached
through umbrella_features_pallas).  Classification style: kNN column 0
dropped, plain azimuth sort, channels [center, polar, normal, const].
``umbrella_fan_features`` runs the plain version for a tensor on the CPU
and the kernel for a tensor on a CUDA device.  Neither applies the
per-sample normal inversion; geometry.umbrella.umbrella_features does.
"""

import torch

from . import build
from .common import check_launch, counts_i32, cuda_f32, forward_only, ptr, stream
from .knn import knn_plain

CHANNELS = 10
KERNEL_K = 9  # the one k the kernel is built for: group size 8 + 1


def umbrella_fan_features_plain(xyz, k, valid=None, return_knn=False):
    """Plain version: the composition of the geometry functions.

    Args:
      xyz: [B, N, 3] float32; valid: optional [B] counts.
      return_knn: also return the kNN indices the fans were built from.

    Returns:
      [B, N, k-1, 10] float32 (and the kNN indices [B, N, k] int32, self
      column included, a missing slot as 0).
    """
    from ...geometry.umbrella import umbrella_composition

    feat = umbrella_composition(xyz, k, valid=valid, knn_fn=knn_plain)
    if return_knn:
        return feat, knn_plain(k, xyz, xyz, valid=valid)[0]
    return feat


def umbrella_fan_features(xyz, k, valid=None, return_knn=False):
    """Umbrella fan features (see the module doc); the plain version on the
    CPU, the CUDA kernel on a CUDA device.  Same arguments and return as
    ``umbrella_fan_features_plain``."""
    forward_only(xyz)
    if xyz.device.type == "cpu":
        return umbrella_fan_features_plain(xyz, k, valid=valid, return_knn=return_knn)
    if k != KERNEL_K:
        raise ValueError(f"the umbrella kernel is built for k={KERNEL_K}, got {k}")
    b, n = xyz.shape[0], xyz.shape[1]
    xyz = cuda_f32(xyz, "xyz", (b, n, 3))
    valid = counts_i32(valid, b, xyz.device)
    out = torch.empty((b, n, k - 1, CHANNELS), dtype=torch.float32, device=xyz.device)
    idx = (
        torch.empty((b, n, k), dtype=torch.int32, device=xyz.device)
        if return_knn
        else None
    )
    status = build.library().repsurf_umbrella_cls(
        ptr(xyz), ptr(valid), b, n, k, ptr(out), ptr(idx), stream(xyz.device)
    )
    check_launch(status, "repsurf_umbrella_cls")
    umbrella_fan_features.launches += 1
    return (out, idx) if return_knn else out


umbrella_fan_features.launches = 0
