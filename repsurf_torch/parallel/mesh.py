"""Batch padding and per-rank slices (repsurf_tpu/parallel/mesh.py
``pad_to_multiple``, ``shard_batch``), numpy only.

JAX shards a global batch over the mesh's data axis, device d taking rows
[d * B / n, (d + 1) * B / n); the port's rank r takes the same rows of the
same global batch.
"""

import numpy as np


def pad_to_multiple(batch, multiple, ignore_index=255):
    """Pad the leading axis of a host batch dict to a multiple of
    ``multiple`` (DistributedSampler's padding).  Added samples have
    ``valid`` 0 and all-ignore labels, so they count nowhere."""
    b = next(iter(batch.values())).shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return batch
    out = {k: np.pad(v, [(0, rem)] + [(0, 0)] * (v.ndim - 1)) for k, v in batch.items()}
    if "label" in out:
        out["label"][b:] = ignore_index
    if "valid" in out:
        out["valid"][b:] = 0
    return out


def shard_rows(b, rank, world_size):
    """The slice of a global batch of ``b`` samples that ``rank`` steps."""
    if b % world_size:
        raise ValueError(f"batch {b} not divisible over {world_size} ranks (pad_to_multiple)")
    per = b // world_size
    return slice(rank * per, (rank + 1) * per)


def shard_batch(batch, rank, world_size):
    """Rank ``rank``'s rows of every leaf of a batch dict (numpy arrays or
    tensors), the counterpart of placing it on mesh device ``rank``."""
    rows = shard_rows(next(iter(batch.values())).shape[0], rank, world_size)
    return {k: v[rows] for k, v in batch.items()}
