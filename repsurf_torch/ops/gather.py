"""Point gathering / grouping on ``torch.gather`` (repsurf_tpu/ops/gather.py).

The JAX package recasts these gathers as one-hot matmuls for the TPU's
matrix unit; a GPU gathers rows natively, so the port keeps what they
compute and uses ``torch.gather``.
"""

import torch


def index_points(points, idx):
    """Gather rows of a point tensor.

    Args:
      points: [B, N, C].
      idx: [B, M] (gathering) or [B, M, K] (grouping) int indices into N.

    Returns:
      [B, M, C] or [B, M, K, C].
    """
    if idx.ndim not in (2, 3):
        raise ValueError(f"idx must be rank 2 or 3, got {idx.ndim}")
    b, c = points.shape[0], points.shape[-1]
    flat = idx.reshape(b, -1).long()
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, c))
    return out.reshape(*idx.shape, c)


def index_points_multi(idx, *tensors):
    """Gather several channel tensors with the same indices; None entries
    pass through as None."""
    return tuple(None if t is None else index_points(t, idx) for t in tensors)


def resort_points(points, order):
    """Permute the group axis of [B, N, G, C] by per-point order [B, N, G]."""
    c = points.shape[-1]
    return torch.gather(points, 2, order.long()[..., None].expand(-1, -1, -1, c))


def select_group(values, idx):
    """Pick one fan per point: values [B, N, G, C], idx [B, N] -> [B, N, C]."""
    c = values.shape[-1]
    sel = idx.long()[:, :, None, None].expand(-1, -1, 1, c)
    return torch.gather(values, 2, sel)[:, :, 0]
