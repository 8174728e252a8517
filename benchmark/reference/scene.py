"""The whole-scene test protocol of RepSurf's S3DIS evaluation
(hancyran/RepSurf ``segmentation/tool/test_s3dis.py:105-256``), numpy on
the host and the reference model on the device: every point of the room
covered by voxel passes, each pass cropped into chunks of at most
``voxel_max`` points around the lowest potential, each chunk normalised,
chunks batched and padded to the largest chunk (rounded up to 4,096, at most
``voxel_max``), the softmax of each chunk's logits summed per point in
float64 and averaged, the label its argmax.  The voxel hash and chunker are
frozen copies of the program's (``data/voxelize.py``,
``train/eval_s3dis.py``), so that both sides cut a room alike.
"""

import numpy as np
import torch

from . import models

BUCKET = 4096


def fnv_hash(arr):
    arr = arr.copy().astype(np.uint64, copy=False)
    hashed = np.uint64(14695981039346656037) * np.ones(arr.shape[0], dtype=np.uint64)
    for j in range(arr.shape[1]):
        hashed *= np.uint64(1099511628211)
        hashed = np.bitwise_xor(hashed, arr[:, j])
    return hashed


def voxel_passes(coord, voxel_size):
    """Index sets that together cover every point: pass i takes the i-th
    point of every voxel."""
    key = fnv_hash(np.floor((coord - np.min(coord, 0)) / np.array(voxel_size)))
    idx_sort = np.argsort(key)
    _, count = np.unique(key[idx_sort], return_counts=True)
    start = np.cumsum(np.insert(count, 0, 0)[0:-1])
    return [idx_sort[start + i % count] for i in range(count.max())]


def normalize(coord, feat, rgb_mean, rgb_std):
    coord = coord - np.mean(coord, 0)
    feat = (feat / 255.0 - rgb_mean) / rgb_std
    return coord.astype(np.float32), feat.astype(np.float32)


def chunks(coord, feat, proto):
    """[(global idx, coord, feat)] of one room: the potential-field crops of
    each pass, in the protocol's order."""
    rng = np.random.RandomState(proto["chunk_seed"])
    mean, std = (np.array(proto[k], np.float32) for k in ("rgb_mean", "rgb_std"))
    vmax = proto["voxel_max"]
    out = []
    for part in voxel_passes(coord, proto["voxel_size"]):
        cp, fp = coord[part], feat[part]
        if cp.shape[0] <= vmax:
            out.append((part, *normalize(cp.copy(), fp.copy(), mean, std)))
            continue
        potential = rng.rand(cp.shape[0]) * 1e-3
        covered = np.array([], dtype=part.dtype)
        while covered.size != part.shape[0]:
            d = np.sum(np.square(cp - cp[np.argmin(potential)]), 1)
            crop = np.argsort(d)[:vmax]
            dc = d[crop]
            potential[crop] += np.square(1 - dc / np.max(dc))
            out.append((part[crop], *normalize(cp[crop].copy(), fp[crop].copy(), mean, std)))
            covered = np.unique(np.concatenate((covered, part[crop])))
    return out


def padded(chunk_list, vmax):
    n = -(-max(c[1].shape[0] for c in chunk_list) // BUCKET) * BUCKET
    return min(n, vmax)


def batch_shapes(chunk_list, proto):
    """[{"points": padded points, "valid": [each chunk's points]}] of the
    forwards that serve the room."""
    n, b = padded(chunk_list, proto["voxel_max"]), proto["batch_size"]
    sizes = [c[1].shape[0] for c in chunk_list]
    return [{"points": n, "valid": sizes[s:s + b]} for s in range(0, len(sizes), b)]


def room_probs(p, arch, coord, feat, proto, device, model, prec=models.Precision()):
    """[N, classes] float64 vote-averaged softmax of one room; ``model`` the
    reference's (plan, forward)."""
    plan_fn, forward = model
    chunk_list = chunks(coord, feat, proto)
    n = padded(chunk_list, proto["voxel_max"])
    k = len(chunk_list)
    xyz = np.zeros((k, n, 3), np.float32)
    fea = np.zeros((k, n, feat.shape[1]), np.float32)
    valid = np.zeros(k, np.int64)
    for j, (_, c, f) in enumerate(chunk_list):
        xyz[j, :len(c)], fea[j, :len(c)], valid[j] = c, f, len(c)
        xyz[j, len(c):] = c[0]
    pred = torch.zeros((coord.shape[0], arch["num_class"]), dtype=torch.float64, device=device)
    count = torch.zeros((coord.shape[0], 1), dtype=torch.float64, device=device)
    with torch.no_grad():
        # the geometry of every chunk at once (FPS is round by round, so one
        # call for all chunks), then the layers batch by batch
        plan = plan_fn(arch, torch.from_numpy(xyz).to(device),
                       torch.from_numpy(valid).to(device), train=False)
        for s in range(0, k, proto["batch_size"]):
            e = min(s + proto["batch_size"], k)
            logits = forward(p, arch, plan.rows(s, e), torch.from_numpy(fea[s:e]).to(device),
                             train=False, prec=prec)
            prob = torch.softmax(logits, -1).double()
            for r, j in enumerate(range(s, e)):
                idx = torch.from_numpy(chunk_list[j][0]).to(device)
                pred.index_add_(0, idx, prob[r, :valid[j]])
                count.index_add_(0, idx, torch.ones((int(valid[j]), 1), dtype=torch.float64,
                                                    device=device))
    return pred / torch.clamp(count, min=1.0)
