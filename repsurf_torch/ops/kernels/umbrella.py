"""Fused umbrella geometry: the CUDA kernel ``csrc/umbrella.cu`` and its
plain PyTorch version.

Replaces repsurf_tpu/ops/pallas/umbrella.py:_umbrella_tq_kernel (reached
through umbrella_features_pallas).  Classification style: kNN column 0
dropped, plain azimuth sort, channels [center, polar, normal, const].
``umbrella_fan_features`` runs the plain version for a tensor on the CPU
and the kernel for a tensor on a CUDA device.  Neither applies the
per-sample normal inversion; geometry.umbrella.umbrella_features does.

Gradient: the kernel has no backward of its own.  As in the JAX package
(repsurf_tpu/geometry/umbrella.py:198-249, _umbrella_pallas_xla_vjp), the
gradient with respect to xyz is that of the plain composition, recomputed
on the same inputs in the backward pass.  The stock models feed data
coordinates, so this backward never runs in them.
"""

import torch

from . import build
from .common import check_launch, counts_i32, cuda_f32, ptr, stream
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


class _UmbrellaFans(torch.autograd.Function):
    """The kernel forward; the plain composition's vector-Jacobian product
    as the backward (see the module doc)."""

    @staticmethod
    def forward(ctx, xyz, valid, k, return_knn):
        b, n = xyz.shape[0], xyz.shape[1]
        out = torch.empty((b, n, k - 1, CHANNELS), dtype=torch.float32, device=xyz.device)
        idx = torch.empty((b, n, k), dtype=torch.int32, device=xyz.device) if return_knn else None
        status = build.library().repsurf_umbrella_cls(
            ptr(xyz), ptr(valid), b, n, k, ptr(out), ptr(idx), stream(xyz.device)
        )
        check_launch(status, "repsurf_umbrella_cls")
        umbrella_fan_features.launches += 1
        if idx is not None:
            ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(xyz, valid)
        ctx.k = k
        return out, idx

    @staticmethod
    def backward(ctx, g, g_idx):
        xyz, valid = ctx.saved_tensors
        with torch.enable_grad():
            x = xyz.detach().requires_grad_(True)
            feat = umbrella_fan_features_plain(x, ctx.k, valid=valid)
            (dx,) = torch.autograd.grad(feat, x, g)
        return dx, None, None, None


def umbrella_fan_features(xyz, k, valid=None, return_knn=False):
    """Umbrella fan features (see the module doc); the plain version on the
    CPU, the CUDA kernel on a CUDA device.  Same arguments and return as
    ``umbrella_fan_features_plain``."""
    if xyz.device.type == "cpu":
        return umbrella_fan_features_plain(xyz, k, valid=valid, return_knn=return_knn)
    if k != KERNEL_K:
        raise ValueError(f"the umbrella kernel is built for k={KERNEL_K}, got {k}")
    b, n = xyz.shape[0], xyz.shape[1]
    xyz = cuda_f32(xyz, "xyz", (b, n, 3))
    valid = counts_i32(valid, b, xyz.device)
    out, idx = _UmbrellaFans.apply(xyz, valid, k, return_knn)
    return (out, idx) if return_knn else out


umbrella_fan_features.launches = 0
