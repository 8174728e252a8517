"""Whole-scene S3DIS inference (repsurf_tpu/train/eval_s3dis.py): exhaustive
multi-pass voxel cover, potential-field chunking, overlapping-chunk vote
accumulation, kNN median filtering and visualisation dumps.

The scene protocol (voxel passes, chunk cropping, normalisation) is numpy
on the host, as in the JAX package (segmentation/tool/test_s3dis.py:105-256),
except on a CUDA device: there the voxel passes stay numpy on the host and
``device_batches`` cuts, normalises and pads the chunks on the card: the
same chunks, each point's values numpy's but for the order of points tied
in distance, which can move a chunk's mean by a few ulps.  The forwards
and the median filter's kNN run on the model's device.
"""

import os
from collections import Counter, OrderedDict

import numpy as np
import torch

from ..data.s3dis import S3DIS_RGB_MEAN, S3DIS_RGB_STD, pad_batch
from ..data.voxelize import voxelize
from ..ops.kernels.chunk_mean import chunk_mean
from ..ops.neighbors import knn
from ..utils.spans import span

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
    with span("scene.voxel_passes"):
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
    with span("scene.chunk"):
        rng = np.random.RandomState(seed) if seed is not None else np.random
        idx_list, coord_list, feat_list = [], [], []
        for idx_part in idx_data:
            coord_part, feat_part = coord[idx_part], feat[idx_part]
            if voxel_max and coord_part.shape[0] > voxel_max:
                potential = rng.rand(coord_part.shape[0]) * 1e-3
                covered = np.array([], dtype=idx_part.dtype)
                while covered.size != idx_part.shape[0]:
                    with span("scene.crop"):
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


def padded_size(sizes, voxel_max):
    """The batches' point count: the largest of the chunks' ``sizes``
    rounded up to BUCKET, at most voxel_max."""
    n_max = -(-max(sizes) // BUCKET) * BUCKET
    return min(n_max, voxel_max) if voxel_max else n_max


def _raise_potential(potential, covered, crop, dist_c, dist_max):
    """numpy's ``potential[crop] += np.square(1 - dist_c / np.max(dist_c))``
    (in the distances' dtype, added in float64) and ``covered[crop] = True``,
    out of place, so that a crop can be cut again from the state before it."""
    t = dist_c / dist_max
    u = 1 - t
    return (potential.index_add(0, crop, (u * u).to(potential.dtype)),
            covered.index_fill(0, crop, True))


def _crop_pass(cp, potential, voxel_max):
    """``chunk_scene``'s crops of one pass, on ``cp``'s device: [voxel_max]
    int64 pass positions each, in the protocol's order.

    Each crop takes the first minimum of the potential, the squared
    distances ``(dx*dx + dy*dy) + dz*dz`` in the coordinates' dtype (numpy's
    order for ``np.sum(np.square(...), 1)``, op by op, so the same bits), and
    the ``voxel_max`` nearest by a stable sort.  A stable sort and
    ``np.argsort`` take the same set unless the distance at the boundary
    ties the next one; that crop is cut on the host by ``np.argsort`` on the
    same distances (span ``scene.crop_host``).  One read-back a crop: the
    tie and the covered count together.  ``device_batches.crops`` counts the
    crops by where they were cut."""
    p = cp.shape[0]
    covered = torch.zeros(p, dtype=torch.bool, device=cp.device)
    crops, count = [], 0
    while count != p:
        with span("scene.crop"):
            diff = cp - cp.index_select(0, torch.argmin(potential).view(1))
            sq = diff * diff
            dist = (sq[:, 0] + sq[:, 1]) + sq[:, 2]
            dist_s, order = torch.sort(dist, stable=True)
            crop = order[:voxel_max]
            dist_max = dist_s[voxel_max - 1:voxel_max]
            raised = _raise_potential(potential, covered, crop, dist_s[:voxel_max], dist_max)
            tie = (dist_s[voxel_max - 1] == dist_s[voxel_max]).long()
            tie, count = torch.stack((tie, raised[1].sum())).tolist()
            if tie:
                with span("scene.crop_host"):
                    crop = np.argsort(dist.cpu().numpy())[:voxel_max]
                    crop = torch.from_numpy(crop).to(cp.device)
                raised = _raise_potential(potential, covered, crop,
                                          dist.index_select(0, crop), dist_max)
                count = int(raised[1].sum())
            device_batches.crops["host" if tie else "device"] += 1
            potential, covered = raised
            crops.append(crop)
    return crops


def device_batches(coord, feat, passes, voxel_max=80000, batch_size=4, data_norm="mean",
                   seed=1000, device="cuda"):
    """``scene_batches``'s batches from the voxel ``passes``, cut, normalised
    and padded on ``device``: the same draws of the potential from ``seed``,
    the same chunks in the same order, padded as ``pad_batch`` pads.  One
    upload a room (span ``scene.upload``).

    The crops are ``_crop_pass``'s.  Inside a crop cut by the stable sort,
    points at exactly equal distances come in ascending pass position,
    where numpy's order is unspecified.  Each point's colour is bit-equal to
    ``chunk_scene``'s, and its coordinates are numpy's normalisation of the
    chunk in this order (``chunk_mean`` is numpy's sequential mean); where
    tied points sit in another order than numpy's, the chunk's mean, and so
    every coordinate of the chunk, can round a few ulps of the mean apart
    (2 in one chunk of the benchmark's 224).
    ``device_batches.crops`` counts the crops: ``device`` cut by the stable
    sort, ``host`` cut on the host at a boundary tie.

    Returns:
      [(batch, rows)] as ``scene_batches``, every tensor on ``device``.
    """
    dev = torch.device(device)
    rng = np.random.RandomState(seed) if seed is not None else np.random
    sizes = [len(p) for p in passes]
    cropped = [bool(voxel_max) and n > voxel_max for n in sizes]
    draws = [rng.rand(n) * 1e-3 for n, c in zip(sizes, cropped) if c]
    with span("scene.upload"):  # pageable: the first crop waits for it anyway
        coord_t = torch.from_numpy(np.ascontiguousarray(coord)).to(dev)
        feat_t = torch.from_numpy(np.ascontiguousarray(feat)).to(dev)
        passes_t = torch.from_numpy(np.concatenate(passes)).to(dev).split(sizes)
        draws_t = iter(torch.from_numpy(np.concatenate(draws)).to(dev)
                       .split([len(d) for d in draws]) if draws else ())
    with span("scene.chunk"):
        chunks = []  # each chunk's scene rows, in protocol order
        for part, c in zip(passes_t, cropped):
            if c:
                crops = _crop_pass(coord_t.index_select(0, part), next(draws_t), voxel_max)
                chunks.extend(part[crop] for crop in crops)
            else:
                chunks.append(part)
    with span("scene.pad"):
        n_max = padded_size([len(c) for c in chunks], voxel_max)
        rows = torch.empty((len(chunks), n_max), dtype=torch.int64, device=dev)
        for j, r in enumerate(chunks):
            rows[j, :len(r)] = r
            rows[j, len(r):] = r[:1]  # padding repeats the chunk's first point
        valid = torch.tensor([len(c) for c in chunks], dtype=torch.int32).to(dev)
        xyz = coord_t[rows]
        if data_norm == "mean":
            xyz = xyz - chunk_mean(xyz, valid)[:, None]
        elif data_norm == "min":  # the padding repeats a real point
            xyz = xyz - xyz.amin(1, keepdim=True)
        else:
            raise ValueError(data_norm)
        rgb = feat_t[rows]
        if not rgb.is_floating_point():
            rgb = rgb.double()  # numpy's integer / 255.0
        stats = [torch.from_numpy(a).to(dev) for a in (S3DIS_RGB_MEAN, S3DIS_RGB_STD)]
        # a divisor on the device: a CPU scalar divisor multiplies by its reciprocal
        rgb = (rgb / torch.full((1,), 255.0, dtype=rgb.dtype, device=dev) - stats[0]) / stats[1]
        live = torch.arange(n_max, device=dev)[None] < valid[:, None]
        rgb = torch.where(live[..., None], rgb.float(), 0.0)
        rows = torch.where(live, rows, coord.shape[0])
        xyz = xyz.float()
        return [({"coord": xyz[s:s + batch_size], "feat": rgb[s:s + batch_size],
                  "valid": valid[s:s + batch_size]}, rows[s:s + batch_size])
                for s in range(0, len(chunks), batch_size)]


device_batches.crops = Counter()


def predict_scene(forward_fn, coord, feat, num_class, **kwargs):
    """[N] int64 labels of one scene: the argmax of ``scene_votes`` (same
    arguments), taken where the votes are."""
    votes = scene_votes(forward_fn, coord, feat, num_class, **kwargs)
    if isinstance(votes, np.ndarray):
        return np.argmax(votes, 1)
    return votes.argmax(dim=1).cpu().numpy()


def scene_batches(coord, feat, voxel_size=0.04, voxel_max=80000, batch_size=4,
                  data_norm="mean", seed=1000, device="cpu"):
    """The chunk batches of one scene: voxel passes, chunks, each batch
    padded to ``padded_size``.  The tail batch holds the chunks that are
    left: samples are independent in eval mode, so it is not padded with
    copies.  On a CUDA ``device`` the chunks are cut there
    (``device_batches``); otherwise on the host, numpy as in the JAX package.

    Returns:
      [(batch, rows)]: ``batch`` a dict of ``coord`` [b, n_max, 3],
      ``feat`` [b, n_max, C] and ``valid`` [b], ``rows`` [b, n_max] int64
      each slot's scene index (N, a spare row, for padding): numpy arrays,
      or tensors on a CUDA ``device``.
    """
    with span("scene.prepare"):
        passes = voxel_passes(coord, voxel_size)
        if torch.device(device).type == "cuda":
            return device_batches(coord, feat, passes, voxel_max, batch_size, data_norm,
                                  seed, device)
        idx_list, coord_list, feat_list = chunk_scene(coord, feat, passes, voxel_max,
                                                      data_norm, seed=seed)
        with span("scene.pad"):
            n_max = padded_size([len(c) for c in coord_list], voxel_max)
            out = []
            for s in range(0, len(idx_list), batch_size):
                chunks = range(s, min(s + batch_size, len(idx_list)))
                batch = pad_batch([(coord_list[j], feat_list[j], None) for j in chunks], n_max)
                rows = np.full((len(chunks), n_max), coord.shape[0], np.int64)
                for r, j in enumerate(chunks):
                    rows[r, :len(idx_list[j])] = idx_list[j]
                out.append(({k: batch[k] for k in ("coord", "feat", "valid")}, rows))
        return out


def add_votes(pred, count, logits, idx):
    """Add one batch's softmax into the float64 vote buffers on the device:
    ``pred`` [N + 1, C] and ``count`` [N + 1] at ``idx`` [b * n_max], the
    batch's ``rows`` flattened."""
    probs = torch.softmax(logits.float(), dim=-1).reshape(-1, pred.shape[1])
    pred.index_add_(0, idx, probs.double())
    count.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float64))


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
        float64 [N, C] vote buffer on ``device`` and adds each batch's
        softmax into it with ``index_add_``, one label read-back per scene.
        The two differ only in summation order.  'auto': device on a CUDA
        device.
      The batches are ``scene_batches``'s on ``device``: cut on the card on
      a CUDA device, uploaded batch by batch (span ``scene.upload``)
      otherwise.

    Returns:
      [N, num_class] float64 vote-averaged softmax: a numpy array ('host')
      or a tensor on ``device`` ('device').
    """
    device = torch.device(device)
    batches = scene_batches(coord, feat, voxel_size, voxel_max, batch_size, data_norm, seed,
                            device)
    n_scene = coord.shape[0]
    if accumulate == "auto":
        accumulate = "device" if device.type == "cuda" else "host"
    if accumulate not in ("host", "device"):
        raise ValueError(f"accumulate must be auto, host or device; got {accumulate!r}")

    def upload(batch):
        if isinstance(batch["coord"], torch.Tensor):  # cut on the card
            return batch
        with span("scene.upload"):
            return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    if accumulate == "host":
        pred = np.zeros((n_scene + 1, num_class), np.float64)
        count = np.zeros((n_scene + 1, 1), np.float64)
        for batch, rows in batches:
            staged = upload(batch)
            with span("scene.forward"):
                logits = forward_fn(staged)
            with span("scene.vote"):
                probs = torch.softmax(logits.float(), dim=-1).cpu().numpy()
                rows = rows.cpu().numpy() if isinstance(rows, torch.Tensor) else rows
                for r in range(rows.shape[0]):
                    pred[rows[r]] += probs[r]
                    count[rows[r]] += 1.0
        return pred[:n_scene] / np.maximum(count[:n_scene], 1.0)

    pred = torch.zeros((n_scene + 1, num_class), dtype=torch.float64, device=device)
    count = torch.zeros((n_scene + 1,), dtype=torch.float64, device=device)
    for batch, rows in batches:
        staged = upload(batch)
        with span("scene.forward"):
            logits = forward_fn(staged)  # queued on the device
        with span("scene.vote"):
            add_votes(pred, count, logits, torch.as_tensor(rows, device=device).reshape(-1))
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
