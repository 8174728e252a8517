"""Neighbor search (repsurf_tpu/ops/neighbors.py).

``knn`` routes as the JAX package does (ops/neighbors.py:102-119): a tensor
on the CPU takes the plain version; on a CUDA device a cloud of at least
16,384 points with k <= 128 takes the window kernel, any other the brute
kernel (ops/kernels).  The bucket route is not ported: the window kernel
takes clouds of any size.

Distances are direct coordinate differences, ``dx*dx + dy*dy + dz*dz``
summed left to right, as the kernels compute them (the JAX package's XLA
route uses ``|q|^2 + |p|^2 - 2 q.p`` instead, which can differ by an ulp
and so at exact ties and radius boundaries).  Selections break ties on the
lowest index, never by ``topk``'s own order.
"""

import torch

from .gather import index_points
from .kernels.knn import knn_brute, knn_plain, pairwise_dist2
from .kernels.knn_window import knn_window
from .masking import counts_to_mask

# clouds at least this large take the window kernel on a CUDA device
WINDOW_MIN_N = 16384
WINDOW_MAX_K = 128


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
    if xyz.device.type == "cpu":
        return knn_plain(k, xyz, new_xyz, valid=valid)
    if xyz.shape[1] >= WINDOW_MIN_N and k <= WINDOW_MAX_K:
        return knn_window(k, xyz, new_xyz, valid=valid)
    return knn_brute(k, xyz, new_xyz, valid=valid)


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
