"""Voxel-grid downsampling via coordinate hashing (repsurf_tpu/data/voxelize.py),
numpy only.

A copy, not an import: importing ``repsurf_tpu.data`` pulls in jax, and the
machine with the card has none.  FNV-1a (or ravel) hash of the floored
voxel coordinates; train mode keeps one random point per voxel, val mode
returns the sort order and per-voxel counts for the exhaustive multi-pass
whole-scene protocol (segmentation/tool/test_s3dis.py:114-130).
"""

import numpy as np


def fnv_hash_vec(arr):
    """FNV64-1A over integer coordinate rows."""
    if arr.ndim != 2:
        raise ValueError(f"expected [N, D] coordinates, got shape {arr.shape}")
    arr = arr.copy().astype(np.uint64, copy=False)
    hashed = np.uint64(14695981039346656037) * np.ones(arr.shape[0], dtype=np.uint64)
    for j in range(arr.shape[1]):
        hashed *= np.uint64(1099511628211)
        hashed = np.bitwise_xor(hashed, arr[:, j])
    return hashed


def ravel_hash_vec(arr):
    """Row-major ravel of min-shifted integer coordinates."""
    if arr.ndim != 2:
        raise ValueError(f"expected [N, D] coordinates, got shape {arr.shape}")
    arr = arr.copy()
    arr -= arr.min(0)
    arr = arr.astype(np.uint64, copy=False)
    arr_max = arr.max(0).astype(np.uint64) + 1
    keys = np.zeros(arr.shape[0], dtype=np.uint64)
    for j in range(arr.shape[1] - 1):
        keys += arr[:, j]
        keys *= arr_max[j + 1]
    keys += arr[:, -1]
    return keys


def voxelize(coord, voxel_size=0.05, hash_type="fnv", mode=0, rng=None):
    """Args:
      coord: [N, 3] float coordinates (callers min-shift first).
      mode: 0 = train (one random point per voxel -> index array);
            1 = val (returns (sorted index order, per-voxel counts)).
      rng: optional np.random.RandomState for the train-mode pick.
    """
    if rng is None:
        rng = np.random
    discrete = np.floor(coord / np.array(voxel_size))
    key = ravel_hash_vec(discrete) if hash_type == "ravel" else fnv_hash_vec(discrete)
    idx_sort = np.argsort(key)
    key_sort = key[idx_sort]
    _, count = np.unique(key_sort, return_counts=True)
    if mode == 0:
        idx_select = (
            np.cumsum(np.insert(count, 0, 0)[0:-1])
            + rng.randint(0, count.max(), count.size) % count
        )
        return idx_sort[idx_select]
    return idx_sort, count
