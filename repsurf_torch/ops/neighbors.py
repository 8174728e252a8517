"""Neighbor search, plain PyTorch (repsurf_tpu/ops/neighbors.py).

Distances are direct coordinate differences, ``dx*dx + dy*dy + dz*dz``
summed left to right, as the kernels compute them (the JAX package's XLA
route uses ``|q|^2 + |p|^2 - 2 q.p`` instead, which can differ by an ulp
and so at exact ties and radius boundaries).  Selections break ties on the
lowest index: a stable sort, never ``topk``.
"""

import torch

from .gather import index_points
from .masking import BIG_DIST2, counts_to_mask


def pairwise_dist2(q, p):
    """[B, M, 3], [B, N, 3] -> [B, M, N] squared distances."""
    dx = p[:, None, :, 0] - q[:, :, None, 0]
    dy = p[:, None, :, 1] - q[:, :, None, 1]
    dz = p[:, None, :, 2] - q[:, :, None, 2]
    return dx * dx + dy * dy + dz * dz


def knn(k, xyz, new_xyz, valid=None):
    """Batched masked k-nearest neighbors.

    Args:
      k: neighbors per query.
      xyz: [B, N, 3] reference points.
      new_xyz: [B, M, 3] queries.
      valid: optional [B] counts of real reference points.

    Returns:
      idx [B, M, k] int32 (ascending distance, lowest index first on ties)
      and dist [B, M, k] float32 Euclidean distances; a missing slot (fewer
      than k valid points) is (0, sqrt(1e10)).
    """
    b, n, _ = xyz.shape
    d2 = pairwise_dist2(new_xyz, xyz)
    if valid is not None:
        ok = counts_to_mask(valid.to(xyz.device), n)
        d2 = torch.where(ok[:, None, :], d2, BIG_DIST2)
    if n < k:
        pad = torch.full(d2.shape[:-1] + (k - n,), BIG_DIST2, dtype=d2.dtype,
                         device=d2.device)
        d2 = torch.cat([d2, pad], dim=-1)
    d2k, idx = torch.sort(d2, dim=-1, stable=True)
    d2k, idx = d2k[..., :k], idx[..., :k]
    missing = d2k >= BIG_DIST2
    d2k = torch.clamp(d2k, max=BIG_DIST2)
    idx = torch.where(missing, 0, idx).to(torch.int32)
    return idx, torch.sqrt(d2k)


def ball_query(radius, nsample, xyz, new_xyz, valid=None):
    """Batched masked ball query.

    The first ``nsample`` valid points in index order with squared distance
    <= float32(radius**2); a short ball is padded with its first hit, an
    empty ball with index 0.

    Returns:
      idx [B, M, nsample] int32.
    """
    n = xyz.shape[1]
    r2 = torch.tensor(float(radius) ** 2, dtype=torch.float32)
    within = pairwise_dist2(new_xyz, xyz) <= r2.to(xyz.device)
    if valid is not None:
        within = within & counts_to_mask(valid.to(xyz.device), n)[:, None, :]
    # hits first, each group in index order (stable), then the misses
    order = torch.sort((~within).to(torch.uint8), dim=-1, stable=True).indices
    if n < nsample:
        order = torch.cat(
            [order, order.new_zeros(order.shape[:-1] + (nsample - n,))], dim=-1
        )
    sel = order[..., :nsample]
    count = within.sum(dim=-1, keepdim=True)
    slot = torch.arange(nsample, device=xyz.device)
    first = torch.where(count > 0, sel[..., :1], 0)
    return torch.where(slot < count, sel, first).to(torch.int32)


def ball_group(radius, nsample, xyz, new_xyz, tensors, valid=None):
    """Ball query + gather of each tensor: ``index_points(t, ball_query(...))``
    for every [B, N, C_i] entry (None passes through)."""
    idx = ball_query(radius, nsample, xyz, new_xyz, valid=valid)
    return [None if t is None else index_points(t, idx) for t in tensors]
