"""Whole-scene S3DIS inference (repsurf_tpu/train/eval_s3dis.py): exhaustive
multi-pass voxel cover, potential-field chunking, overlapping-chunk vote
accumulation, kNN median filtering and visualisation dumps.

The scene protocol (voxel passes, chunk cropping, normalisation) is numpy
on the host, as in the JAX package (segmentation/tool/test_s3dis.py:105-256);
the forwards and the median filter's kNN run on the model's device.
"""

import os
from collections import OrderedDict

import numpy as np
import torch

from ..data.s3dis import S3DIS_RGB_MEAN, S3DIS_RGB_STD, pad_batch
from ..data.voxelize import voxelize
from ..ops.neighbors import knn

# class palette for visualisation dumps (test_s3dis.py:25-31)
LABEL2COLOR = OrderedDict(
    [
        ("ceiling", [0, 255, 0]),
        ("floor", [0, 0, 255]),
        ("wall", [0, 255, 255]),
        ("beam", [255, 255, 0]),
        ("column", [255, 0, 255]),
        ("window", [100, 100, 255]),
        ("door", [200, 200, 100]),
        ("chair", [170, 120, 200]),
        ("table", [255, 0, 0]),
        ("bookcase", [200, 100, 100]),
        ("sofa", [10, 200, 100]),
        ("board", [200, 200, 200]),
        ("clutter", [50, 50, 50]),
    ]
)
LABEL2CLASS = list(LABEL2COLOR.keys())
PALETTE = np.array(list(LABEL2COLOR.values()), dtype=np.int64)

# a batch's point count is the largest chunk rounded up to this, so scenes
# share few distinct model shapes (the JAX package's recompile bound)
BUCKET = 4096


def voxel_passes(coord, voxel_size):
    """Index sets that jointly cover every point: pass i takes the i-th point
    of every voxel (test_s3dis.py:114-130)."""
    if not voxel_size:
        return [np.arange(coord.shape[0])]
    idx_sort, count = voxelize(coord - np.min(coord, 0), voxel_size, mode=1)
    passes = []
    for i in range(count.max()):
        idx_select = np.cumsum(np.insert(count, 0, 0)[0:-1]) + i % count
        passes.append(idx_sort[idx_select])
    return passes


def input_normalize(coord, feat, data_norm="mean", rgb_mean=S3DIS_RGB_MEAN,
                    rgb_std=S3DIS_RGB_STD):
    """Per-chunk normalisation (test_s3dis.py:162-174)."""
    if data_norm == "mean":
        coord = coord - np.mean(coord, 0)
    elif data_norm == "min":
        coord = coord - np.min(coord, 0)
    else:
        raise ValueError(data_norm)
    feat = feat / 255.0
    if rgb_mean is not None and rgb_std is not None:
        feat = (feat - rgb_mean) / rgb_std
    return coord.astype(np.float32), feat.astype(np.float32)


def chunk_scene(coord, feat, idx_data, voxel_max=80000, data_norm="mean", seed=None):
    """Potential-field chunk cropper (test_s3dis.py:133-159): repeatedly crop
    voxel_max points around the lowest-potential point, raising the potential
    of cropped points, until every index of the pass is covered.

    Returns lists of (global_idx, coord, feat) chunks.
    """
    rng = np.random.RandomState(seed) if seed is not None else np.random
    idx_list, coord_list, feat_list = [], [], []
    for idx_part in idx_data:
        coord_part, feat_part = coord[idx_part], feat[idx_part]
        if voxel_max and coord_part.shape[0] > voxel_max:
            potential = rng.rand(coord_part.shape[0]) * 1e-3
            covered = np.array([], dtype=idx_part.dtype)
            while covered.size != idx_part.shape[0]:
                init_idx = np.argmin(potential)
                dist = np.sum(np.square(coord_part - coord_part[init_idx]), 1)
                idx_crop = np.argsort(dist)[:voxel_max]
                dist_c = dist[idx_crop]
                potential[idx_crop] += np.square(1 - dist_c / np.max(dist_c))
                c, f = input_normalize(
                    coord_part[idx_crop].copy(), feat_part[idx_crop].copy(), data_norm
                )
                idx_list.append(idx_part[idx_crop])
                coord_list.append(c)
                feat_list.append(f)
                covered = np.unique(np.concatenate((covered, idx_part[idx_crop])))
        else:
            c, f = input_normalize(coord_part.copy(), feat_part.copy(), data_norm)
            idx_list.append(idx_part)
            coord_list.append(c)
            feat_list.append(f)
    return idx_list, coord_list, feat_list


def padded_size(coord_list, voxel_max):
    """The batches' point count: the largest chunk rounded up to BUCKET,
    at most voxel_max."""
    n_max = max(c.shape[0] for c in coord_list)
    n_max = -(-n_max // BUCKET) * BUCKET
    return min(n_max, voxel_max) if voxel_max else n_max


def _to_device(array, device):
    t = torch.from_numpy(array)
    if device.type == "cuda":
        # pinned, so the copy is asynchronous and can overlap a forward
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def predict_scene(forward_fn, coord, feat, num_class, **kwargs):
    """[N] int64 labels of one scene: the argmax of ``scene_votes`` (same
    arguments), taken where the votes are."""
    votes = scene_votes(forward_fn, coord, feat, num_class, **kwargs)
    if isinstance(votes, np.ndarray):
        return np.argmax(votes, 1)
    return votes.argmax(dim=1).cpu().numpy()


def scene_votes(forward_fn, coord, feat, num_class, voxel_size=0.04, voxel_max=80000,
                batch_size=4, data_norm="mean", seed=1000, accumulate="auto", device="cuda"):
    """Vote-accumulate softmax predictions over all chunks of one scene.

    Args:
      forward_fn: callable(batch) -> [B, n_max, num_class] logits, where
        batch is a dict of ``coord`` [B, n_max, 3], ``feat`` [B, n_max, C]
        and ``valid`` [B] tensors on ``device``.
      coord / feat: [N, 3] raw scene arrays (feat in 0..255 RGB).
      device: where the batches and votes live; the card unless the caller
        asks for the CPU, as every entry point of the port does.
      accumulate: 'host' keeps the reference-shaped accumulation, float64
        numpy votes with one logits read-back per batch; 'device' keeps a
        float64 [N, C] vote buffer on ``device``, adds each batch's softmax
        into it with ``index_add_`` and stages the next batch's upload while
        the current one runs, one label read-back per scene.  The two differ
        only in summation order.  'auto': device on a CUDA device.
      The tail batch holds the chunks that are left: samples are
      independent in eval mode, so it is not padded with copies.

    Returns:
      [N, num_class] float64 vote-averaged softmax: a numpy array ('host')
      or a tensor on ``device`` ('device').
    """
    device = torch.device(device)
    passes = voxel_passes(coord, voxel_size)
    idx_list, coord_list, feat_list = chunk_scene(coord, feat, passes, voxel_max, data_norm,
                                                  seed=seed)
    n_max = padded_size(coord_list, voxel_max)
    n_scene = coord.shape[0]
    if accumulate == "auto":
        accumulate = "device" if device.type == "cuda" else "host"
    if accumulate not in ("host", "device"):
        raise ValueError(f"accumulate must be auto, host or device; got {accumulate!r}")
    starts = list(range(0, len(idx_list), batch_size))

    def stage(s):
        """Chunks s..s+batch_size on the device, and each slot's scene
        index (n_scene, a spare row, for padding)."""
        chunks = range(s, min(s + batch_size, len(idx_list)))
        batch = pad_batch([(coord_list[j], feat_list[j], None) for j in chunks], n_max)
        rows = np.full((len(chunks), n_max), n_scene, np.int64)
        for r, j in enumerate(chunks):
            rows[r, :len(idx_list[j])] = idx_list[j]
        tensors = {k: _to_device(batch[k], device) for k in ("coord", "feat", "valid")}
        return tensors, rows

    if accumulate == "host":
        pred = np.zeros((n_scene + 1, num_class), np.float64)
        count = np.zeros((n_scene + 1, 1), np.float64)
        for s in starts:
            batch, rows = stage(s)
            logits = forward_fn(batch)
            probs = torch.softmax(logits.float(), dim=-1).cpu().numpy()
            for r in range(rows.shape[0]):
                pred[rows[r]] += probs[r]
                count[rows[r]] += 1.0
        return pred[:n_scene] / np.maximum(count[:n_scene], 1.0)

    pred = torch.zeros((n_scene + 1, num_class), dtype=torch.float64, device=device)
    count = torch.zeros((n_scene + 1,), dtype=torch.float64, device=device)
    staged = stage(starts[0])
    for i in range(len(starts)):
        batch, rows = staged
        logits = forward_fn(batch)  # queued on the device
        if i + 1 < len(starts):
            staged = stage(starts[i + 1])  # built and uploaded under the forward
        idx = _to_device(rows.reshape(-1), device)
        probs = torch.softmax(logits.float(), dim=-1).reshape(-1, num_class)
        pred.index_add_(0, idx, probs.double())
        count.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float64))
    return pred[:n_scene] / torch.clamp(count[:n_scene], min=1.0)[:, None]


def median_filter(coord, labels, group_size=32, device="cuda"):
    """kNN median relabelling (segmentation/util/utils.py:235-245): each
    point takes the lower-middle label of its group_size nearest neighbours
    (torch.median's order statistic, not an average).  The kNN is the
    routed ``knn`` on ``device``: the window kernel for a scene on a CUDA
    device."""
    device = torch.device(device)
    xyz = torch.from_numpy(np.ascontiguousarray(coord, np.float32))[None].to(device)
    idx, _ = knn(group_size, xyz, xyz)
    group = torch.from_numpy(np.asarray(labels)).to(device)[idx[0].long()]
    med = torch.sort(group, dim=1).values[:, (group_size - 1) // 2]
    return med.cpu().numpy().astype(np.asarray(labels).dtype)


def visualize_scene(result_dir, name, coord, pred, label):
    """Dump coloured xyz text files (test_s3dis.py:177-183)."""
    os.makedirs(result_dir, exist_ok=True)
    for suffix, lab in (("pred", pred), ("label", label)):
        np.savetxt(
            os.path.join(result_dir, f"{name}_{suffix}.txt"),
            np.hstack([coord, PALETTE[lab.astype(np.int64)]]),
            fmt="%f " * 3 + "%d " * 3,
        )
