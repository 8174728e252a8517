"""Fused ball query + grouping + SA-CD input split: the CUDA kernel
``csrc/ball_group.cu`` and its plain PyTorch version.

Replaces repsurf_tpu/ops/pallas/ball_group.py:_ball_feat_kernel and
:_ball_feat_t_kernel, the TPU's wide and narrow layouts of one function
(reached through ball_group_feature_pallas); one kernel serves both.
``ball_group_feature`` runs the plain version for a tensor on the CPU and
the kernel for a tensor on a CUDA device.
"""

import collections

import torch

from ...geometry.polar import xyz2sphere
from ..gather import index_points
from ..neighbors import ball_query
from . import build
from .common import check_launch, counts_i32, cuda_f32, forward_only, ptr, stream


def _concat(tensors):
    live = [t for t in tensors if t is not None]
    return torch.cat(live, dim=-1) if len(live) > 1 else live[0]


def ball_group_feature_plain(radius, nsample, xyz, new_xyz, tensors, valid=None,
                             return_polar=False):
    """Plain version: ball query, gather, relative coordinates, polar.

    Args:
      radius: ball radius; the test is d2 <= float32(radius**2).
      nsample: group size S.
      xyz: [B, N, 3] reference cloud.
      new_xyz: [B, M, 3] ball centers.
      tensors: channel tensors [B, N, C_i] (None passes), tensors[0] being
        xyz itself, as the SA stages group (center, normal, feature).
      valid: optional [B] counts of real reference points.
      return_polar: append xyz2sphere of the relative coordinates to pos.

    Returns:
      pos [B, M, S, 3|6] and feat [B, M, S, C-3], C the summed channels.
    """
    idx = ball_query(radius, nsample, xyz, new_xyz, valid=valid)
    grouped = index_points(_concat(tensors), idx)
    rel = index_points(xyz, idx) - new_xyz[:, :, None, :]
    pos = torch.cat([rel, xyz2sphere(rel)], dim=-1) if return_polar else rel
    return pos, grouped[..., 3:]


def ball_group_feature(radius, nsample, xyz, new_xyz, tensors, valid=None,
                       return_polar=False):
    """Ball-group features (see the module doc); the plain version on the
    CPU, the CUDA kernel on a CUDA device.  Same arguments and returns as
    ``ball_group_feature_plain``."""
    forward_only(xyz, new_xyz, *tensors)
    if xyz.device.type == "cpu":
        return ball_group_feature_plain(
            radius, nsample, xyz, new_xyz, tensors, valid=valid,
            return_polar=return_polar,
        )
    b, n = xyz.shape[0], xyz.shape[1]
    m = new_xyz.shape[1]
    xyz = cuda_f32(xyz, "xyz", (b, n, 3))
    new_xyz = cuda_f32(new_xyz, "new_xyz", (b, m, 3))
    tcat = cuda_f32(_concat(tensors), "tensors", (b, n, None))
    c = tcat.shape[-1]
    lib = build.library()
    if c < 3 or not 0 < nsample <= lib.repsurf_ball_feature_max_nsample():
        raise ValueError(
            f"ball kernel needs C >= 3 and 0 < nsample <= "
            f"{lib.repsurf_ball_feature_max_nsample()}, got C={c}, nsample={nsample}"
        )
    valid = counts_i32(valid, b, xyz.device)
    pos = torch.empty((b, m, nsample, 6 if return_polar else 3),
                      dtype=torch.float32, device=xyz.device)
    feat = torch.empty((b, m, nsample, c - 3), dtype=torch.float32, device=xyz.device)
    r2 = float(torch.tensor(float(radius) ** 2, dtype=torch.float32))
    status = lib.repsurf_ball_feature(
        ptr(xyz), ptr(new_xyz), ptr(tcat), ptr(valid), b, n, m, c, nsample, r2,
        int(return_polar), ptr(pos), ptr(feat), stream(xyz.device),
    )
    check_launch(status, "repsurf_ball_feature")
    ball_group_feature.launches += 1
    ball_group_feature.launches_by_channels[c] += 1
    return pos, feat


ball_group_feature.launches = 0
# launches keyed by the grouped channel count C (13 and 141 in the classifier)
ball_group_feature.launches_by_channels = collections.Counter()
