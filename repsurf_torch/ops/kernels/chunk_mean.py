"""The per-chunk mean of the whole-scene normalisation: the CUDA kernel
``csrc/chunk_mean.cu`` and its plain version.

Replaces no Pallas kernel: the JAX package normalises a room's chunks with
numpy on the host (``eval_s3dis.input_normalize``: ``coord -
np.mean(coord, 0)``), and the port cuts them on the card.  numpy's mean of a
C-contiguous [n, D] float array sums the rows one after another in index
order, in the array's dtype, then divides once by n; a tree reduction would
round otherwise.  The kernel keeps numpy's order (one thread a chunk and
axis), so for the same rows in the same order a chunk normalised on the
card is bit-equal to the host's.  The plain version is numpy's ``np.mean``
itself, chunk by chunk; ``chunk_mean`` runs it for a tensor on the CPU and
the kernel for a tensor on a CUDA device, counting launches in
``chunk_mean.launches``.
"""

import numpy as np
import torch

from . import build
from .common import check_launch, counts_i32, ptr, stream


def chunk_mean_plain(x, valid=None):
    """numpy's ``np.mean(x[b, :valid[b]], 0)`` for each chunk b.

    Args:
      x: [B, N, D] float32 or float64.
      valid: optional [B] counts of each chunk's real rows (None: all N).

    Returns:
      [B, D] of x's dtype, on x's device.
    """
    arr = x.detach().cpu().numpy()
    counts = [arr.shape[1]] * arr.shape[0] if valid is None else valid.tolist()
    mean = [np.mean(np.ascontiguousarray(c[:m]), 0) for c, m in zip(arr, counts)]
    return torch.from_numpy(np.stack(mean)).to(x.device)


def chunk_mean(x, valid=None):
    """The mean of each chunk's first ``valid[b]`` rows, summed in index
    order as numpy does; the plain version on the CPU, the kernel on a CUDA
    device.  Same arguments and return as ``chunk_mean_plain``."""
    if x.device.type == "cpu":
        return chunk_mean_plain(x, valid)
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x: expected float32 or float64, got {x.dtype}")
    if x.ndim != 3 or not 1 <= x.shape[2] <= 4 or min(x.shape[:2]) < 1:
        raise ValueError(f"x: expected [B, N, D] with B, N >= 1 and D in 1..4, got "
                         f"{tuple(x.shape)}")
    b, n, d = x.shape
    x = x.contiguous()
    counts = counts_i32(valid, b, x.device)
    out = torch.empty((b, d), dtype=x.dtype, device=x.device)
    status = build.library().repsurf_chunk_mean(
        ptr(x), ptr(counts), b, n, d, int(x.dtype == torch.float64), ptr(out), stream(x.device))
    check_launch(status, "repsurf_chunk_mean")
    chunk_mean.launches += 1
    return out


chunk_mean.launches = 0
