"""Masking helpers for padded point batches (repsurf_tpu/ops/masking.py).

A batch ``[B, N, C]`` carries a per-sample count ``valid: [B]``; rows
``[0, valid[b])`` are real points.
"""

import torch

# Sentinel squared distance for invalid / missing neighbors (the reference
# kernels' ``best_dist[i] = 1e10`` init).
BIG_DIST2 = 1e10


def counts_to_mask(valid, n):
    """[B] int counts -> [B, n] bool mask (True = real point)."""
    if valid is None:
        raise ValueError("valid must not be None")
    ar = torch.arange(n, dtype=valid.dtype, device=valid.device)
    return ar[None, :] < valid[:, None]
