"""Exact brute-force k-nearest neighbours: the CUDA kernels ``csrc/knn.cu``
and their plain PyTorch version.

Replaces repsurf_tpu/ops/pallas/knn.py:_knn_kernel.  ``knn_brute`` runs the
plain version for a tensor on the CPU and a kernel for a tensor on a CUDA
device.  On the card it takes one of two routes, by shape alone
(``brute_lanes``): one thread per query (``thread``), or an aligned group of
8, 16 or 32 lanes per query, each over every L-th candidate with its own
list, the group's lists merged in k shuffle rounds (``split``), for calls
with too few queries to fill the card.  ``knn_brute.launches_by_route``
counts the launches by route.  ``knn_plain`` is also the plain version of
the window kernel (``knn_window.py``), which computes the same function.

Semantics: squared distances from direct differences, ``dx*dx + dy*dy +
dz*dz`` summed left to right; points at or beyond ``valid[b]`` never count;
ascending, the lowest index first on ties; a missing slot (fewer than k
valid points) is (0, sqrt(1e10)); the distance returned is the sqrt.
"""

import collections
import functools

import torch

from ..masking import BIG_DIST2, counts_to_mask
from . import build
from .common import check_launch, counts_i32, cuda_f32, ptr, stream

# bytes of one [B, chunk, N] float32 distance block of the plain version
_CHUNK_BYTES = 2**28
# lanes a query of the split route; 1 is the thread-per-query route
LANES = (1, 8, 16, 32)


def pairwise_dist2(q, p):
    """[B, M, 3], [B, N, 3] -> [B, M, N] squared distances."""
    dx = p[:, None, :, 0] - q[:, :, None, 0]
    dy = p[:, None, :, 1] - q[:, :, None, 1]
    dz = p[:, None, :, 2] - q[:, :, None, 2]
    return dx * dx + dy * dy + dz * dz


def knn_plain(k, xyz, new_xyz, valid=None, chunk=None):
    """Plain batched masked kNN, over chunks of queries.

    Each chunk's [B, chunk, N] distances become int64 keys ``bits(d2) << 32
    | index``: non-negative float32 values order as their bit patterns, and
    the index makes every key unique, so ``topk`` on the keys is exact and
    breaks ties on the lowest index, at a fraction of a full sort's cost.

    Args:
      k: neighbours per query.
      xyz: [B, N, 3] reference points; new_xyz: [B, M, 3] queries.
      valid: optional [B] counts of real reference points.
      chunk: queries per chunk; None sizes a [B, chunk, N] float32 block to
        about 256 MB.

    Returns:
      idx [B, M, k] int32 and dist [B, M, k] float32 (see the module doc).
    """
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    if chunk is None:
        chunk = max(1, _CHUNK_BYTES // (4 * b * max(n, 1)))
    ok = None if valid is None else counts_to_mask(valid.to(xyz.device), n)
    col = torch.arange(n, device=xyz.device, dtype=torch.int64)
    kk = min(k, n)
    idx_parts, d2_parts = [], []
    for s in range(0, m, chunk):
        d2 = pairwise_dist2(new_xyz[:, s : s + chunk], xyz)
        if ok is not None:
            d2 = torch.where(ok[:, None, :], d2, BIG_DIST2)
        key = (d2.view(torch.int32).to(torch.int64) << 32) | col
        top = torch.topk(key, kk, dim=-1, largest=False, sorted=True).values
        idx_parts.append(top & 0xFFFFFFFF)
        d2_parts.append((top >> 32).to(torch.int32).view(torch.float32))
    idx = torch.cat(idx_parts, dim=1)
    d2k = torch.cat(d2_parts, dim=1)
    if kk < k:  # fewer points than k: the rest are missing
        pad = (b, m, k - kk)
        idx = torch.cat([idx, idx.new_zeros(pad)], dim=-1)
        d2k = torch.cat([d2k, d2k.new_full(pad, BIG_DIST2)], dim=-1)
    missing = d2k >= BIG_DIST2
    d2k = torch.clamp(d2k, max=BIG_DIST2)
    idx = torch.where(missing, 0, idx).to(torch.int32)
    return idx, torch.sqrt(d2k)


def check_knn_args(k, xyz, new_xyz, valid, max_k):
    """The CUDA wrappers' argument check: contiguous float32 inputs on one
    device, 1 <= k <= max_k; returns (xyz, new_xyz, valid as int32)."""
    b, n = xyz.shape[0], xyz.shape[1]
    xyz = cuda_f32(xyz.detach(), "xyz", (b, n, 3))
    new_xyz = cuda_f32(new_xyz.detach(), "new_xyz", (b, None, 3))
    if new_xyz.device != xyz.device:
        raise ValueError(f"new_xyz on {new_xyz.device}, xyz on {xyz.device}")
    if not 1 <= k <= max_k:
        raise ValueError(f"k must lie in [1, {max_k}], got {k}")
    if n < 1 or new_xyz.shape[1] < 1:
        raise ValueError("empty reference cloud or query set")
    return xyz, new_xyz, counts_i32(valid, b, xyz.device)


def brute_lanes(queries, k, sms):
    """Lanes per query for ``queries`` = B*M queries of k neighbours on a
    card of ``sms`` SMs: the fewest of 1 (a thread a query), 8, 16 and 32
    whose threads reach 8192 / k an SM, kept within [256, 1024], and 32
    when none does.  Every lane of the split route keeps its own k-best
    list, so the lists' upkeep grows with the lanes times k, and a larger k
    wants fewer lanes (measured on an H100: PERF.md, kernel table row 6)."""
    want = sms * max(256, min(1024, 8192 // k))
    for lanes in LANES:
        if queries * lanes >= want:
            return lanes
    return LANES[-1]


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def knn_brute(k, xyz, new_xyz, valid=None, lanes=None):
    """Exact kNN (see the module doc); the plain version on the CPU, a
    CUDA kernel on a CUDA device, where the inputs are cut from the graph
    (indices carry no gradient).  Same arguments and returns as
    ``knn_plain``; ``lanes`` (1, 8, 16 or 32) forces a route on the card,
    None takes ``brute_lanes``'s."""
    if lanes is not None and lanes not in LANES:
        raise ValueError(f"lanes must be one of {LANES}, got {lanes}")
    if xyz.device.type == "cpu":
        return knn_plain(k, xyz, new_xyz, valid=valid)
    lib = build.library()
    xyz, new_xyz, valid = check_knn_args(k, xyz, new_xyz, valid, lib.repsurf_knn_max_k())
    b, n, m = xyz.shape[0], xyz.shape[1], new_xyz.shape[1]
    if lanes is None:
        lanes = brute_lanes(b * m, k, _sm_count(xyz.device.index))
    idx = torch.empty((b, m, k), dtype=torch.int32, device=xyz.device)
    dist = torch.empty((b, m, k), dtype=torch.float32, device=xyz.device)
    status = lib.repsurf_knn(
        ptr(xyz), ptr(new_xyz), ptr(valid), b, n, m, k, lanes, ptr(idx), ptr(dist),
        stream(xyz.device),
    )
    check_launch(status, "repsurf_knn")
    knn_brute.launches += 1
    knn_brute.launches_by_route["thread" if lanes == 1 else "split"] += 1
    knn_brute.launches_by_k[k] += 1
    knn_brute.launches_by_shape[f"{b}x{n}->{m},k={k}"] += 1
    return idx, dist


knn_brute.launches = 0
knn_brute.launches_by_route = collections.Counter()
knn_brute.launches_by_k = collections.Counter()
knn_brute.launches_by_shape = collections.Counter()  # "BxN->M,k=K"
