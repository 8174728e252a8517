"""Furthest-point sampling: the CUDA kernel ``csrc/fps.cu`` and its plain
PyTorch version.

Replaces repsurf_tpu/ops/pallas/fps.py:_fps_kernel.  ``fps`` runs the plain
version for a tensor on the CPU and the kernel for a tensor on a CUDA
device; there is no other choice between them.  The kernel keeps each
thread's points in registers; it holds clouds of up to 8,192 points in one
block (route ``block``) and larger ones, up to 131,072 points, in a
cluster of up to 16 blocks (``cluster``; ``repsurf_fps_cluster_size``
gives the size for a cloud).  A larger cloud, such as a whole voxel pass
of a large room, takes the 16-block cluster with the points beyond its
registers streamed from a [B, N, 4] float32 scratch of their coordinates
and running distances (``stream``).  ``fps.launches_by_route`` counts the
launches by route.  A refused cluster launch raises with its CUDA error.

Semantics: seed index 0, running min of squared distance over every point
(selected points included), argmax with the lowest index on ties; points
at or beyond ``valid[b]`` start at -1 and are never picked.  When
``npoint > valid[b]`` only the first ``valid[b]`` slots are defined.
"""

import collections

import torch

from . import build
from .common import check_launch, counts_i32, cuda_f32, forward_only, ptr, stream


def fps_plain(xyz, npoint, valid=None, return_xyz=False):
    """Plain PyTorch FPS, round by round.

    Args:
      xyz: [B, N, 3] float32.
      npoint: samples per cloud.
      valid: optional [B] int counts.
      return_xyz: also return the sampled coordinates.

    Returns:
      idx [B, npoint] int32 (and sampled xyz [B, npoint, 3]).
    """
    b, n, _ = xyz.shape
    dev = xyz.device
    col = torch.arange(n, device=dev)
    if valid is None:
        dist = torch.full((b, n), 1e10, dtype=torch.float32, device=dev)
    else:
        ok = col[None, :] < valid.to(dev)[:, None]
        dist = torch.where(ok, 1e10, -1.0).to(torch.float32)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rows = torch.arange(b, device=dev)
    far = torch.zeros(b, dtype=torch.long, device=dev)
    idx = torch.empty((b, npoint), dtype=torch.long, device=dev)
    for i in range(npoint):
        idx[:, i] = far
        dx = x - x[rows, far][:, None]
        dy = y - y[rows, far][:, None]
        dz = z - z[rows, far][:, None]
        dist = torch.minimum(dist, dx * dx + dy * dy + dz * dz)
        top = dist.amax(dim=1, keepdim=True)
        far = torch.where(dist == top, col, n).amin(dim=1)  # first index
    idx = idx.to(torch.int32)
    if return_xyz:
        sampled = torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, 3))
        return idx, sampled
    return idx


def fps(xyz, npoint, valid=None, return_xyz=False):
    """Masked FPS (see the module doc); the plain version on the CPU, the
    CUDA kernel on a CUDA device.  Same arguments and returns as
    ``fps_plain``."""
    forward_only(xyz)
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint, valid=valid, return_xyz=return_xyz)
    b, n = xyz.shape[0], xyz.shape[1]
    xyz = cuda_f32(xyz, "xyz", (b, n, 3))
    lib = build.library()
    if n < 1:
        raise ValueError("fps of an empty cloud")
    if npoint < 1:
        raise ValueError(f"npoint must be positive, got {npoint}")
    valid = counts_i32(valid, b, xyz.device)
    route = ("block" if n <= lib.repsurf_fps_block_points() else
             "cluster" if n <= lib.repsurf_fps_register_points() else "stream")
    scratch = (torch.empty((b, n, 4), dtype=torch.float32, device=xyz.device)
               if route == "stream" else None)
    idx = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    sampled = (
        torch.empty((b, npoint, 3), dtype=torch.float32, device=xyz.device)
        if return_xyz
        else None
    )
    status = lib.repsurf_fps(
        ptr(xyz), ptr(valid), b, n, npoint, ptr(scratch), ptr(idx), ptr(sampled),
        stream(xyz.device),
    )
    check_launch(status, "repsurf_fps")
    fps.launches += 1
    fps.launches_by_route[route] += 1
    fps.launches_by_shape[f"{b}x{n}->{npoint}"] += 1
    return (idx, sampled) if return_xyz else idx


fps.launches = 0
fps.launches_by_route = collections.Counter()
fps.launches_by_shape = collections.Counter()  # "BxN->npoint"
