"""Exact kNN at scene scale over a 3-D grid of cells: the CUDA kernel
``csrc/knn_window.cu``, with ``knn.knn_plain`` as its plain version.

Replaces repsurf_tpu/ops/pallas/knn_window.py:_window_kernel.  It computes
the same function as the brute kernel, bit for bit (see ``knn.py``).
``knn_window`` runs the plain version for a tensor on the CPU and the kernel
for a tensor on a CUDA device.

A call is three steps on one stream, and the host waits on none of them:

* ``window_tables``, the data preparation, plain torch ops on the device as
  the JAX package does it in XLA: the grid sized from (N, k), the points
  sorted by cell with the start of every cell's run, and the queries in
  cell order;
* ``window_pass``, the window kernel: each query scans the 3 x 3 x 3 cells
  around its own; a query whose k-th distance the window cannot vouch for
  is appended to its sample's list of failing queries instead;
* ``window_resolve``, the re-solve kernel: a block of lanes scans the whole
  valid cloud for each listed query, skipping every point beyond the last
  distance of the window's list, a bound on the k-th (the JAX package's compacted brute re-solve,
  knn_window.py:447-533).

``knn_window.launches`` counts the window kernel's launches,
``knn_window.resolve_launches`` the re-solve kernel's;
``knn_window.resolved`` holds the last call's per-sample count of failing
queries, ``knn_window.resolved_total`` the sum over calls since it was last
set to 0.
"""

import collections

import torch

from . import build
from .common import check_launch, ptr, stream
from .knn import _sm_count, check_knn_args, knn_plain

# the guard's allowance for the float32 rounding of the cell assignment,
# relative to the largest coordinate magnitude of the grid's bounding box
_SLACK = 1e-5
# re-solve blocks a call, over all samples, for each SM of the card
_RESOLVE_BLOCKS_PER_SM = 2


def window_grid(n, k):
    """(cells per x/y axis, cells along z) for N points and k neighbours:
    the JAX package's sizing (knn_window.py:235-239), so that the cells
    around a query hold a few times k points at average density, in the
    room-shaped 32:12 aspect."""
    gxy = max(4, min(32, int((9 * n / (32 * k)) ** 0.5)))
    return gxy, max(2, int(round(gxy * 12 / 32)))


def window_tables(k, xyz, new_xyz, valid=None):
    """The kernel's inputs for one call.

    Returns a dict: ``pts`` [B, N, 4] float32 (x, y, z and the original
    index as int32 bits) sorted by cell id, invalid points last; ``starts``
    [B, cells + 1] int32, the sorted position where each cell's run begins
    (``starts[:, cells]`` = valid count); ``qorder`` [B, M] int32, the
    queries in cell order; ``lo``, ``cs`` [B, 3] grid origin and cell size;
    ``slack`` [B]; ``gxy``, ``gz`` the grid's shape.  Cell ids run
    ``(cx * gxy + cy) * gz + cz``, so a column's z-range is contiguous.
    """
    b, n, _ = xyz.shape
    dev = xyz.device
    gxy, gz = window_grid(n, k)
    cells = gxy * gxy * gz
    col = torch.arange(n, device=dev)
    ok = torch.ones((b, n), dtype=torch.bool, device=dev) if valid is None else (
        col[None, :] < valid.to(dev)[:, None]
    )
    inf = torch.tensor(float("inf"), device=dev)
    lo = torch.where(ok[..., None], xyz, inf).amin(dim=1)
    hi = torch.where(ok[..., None], xyz, -inf).amax(dim=1)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    hi = torch.where(torch.isfinite(hi), hi, 0.0)
    shape = torch.tensor([gxy, gxy, gz], dtype=torch.float32, device=dev)
    cs = torch.clamp(hi - lo, min=1e-6) / shape
    cmax = (shape - 1).to(torch.int64)

    def cell_ids(p):
        c = torch.floor((p - lo[:, None]) / cs[:, None]).to(torch.int64)
        c = torch.minimum(torch.clamp(c, min=0), cmax)
        return (c[..., 0] * gxy + c[..., 1]) * gz + c[..., 2]

    pid = torch.where(ok, cell_ids(xyz), cells)
    pid_sorted, order = torch.sort(pid, dim=1, stable=True)
    bounds = torch.arange(cells + 1, device=dev).expand(b, -1).contiguous()
    starts = torch.searchsorted(pid_sorted, bounds).to(torch.int32)
    order32 = order.to(torch.int32)
    pts = torch.cat(
        [torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3)),
         order32.view(torch.float32)[..., None]],
        dim=-1,
    ).contiguous()
    qorder = torch.sort(cell_ids(new_xyz), dim=1, stable=True).indices.to(torch.int32)
    scale = torch.maximum(lo.abs(), hi.abs()).amax(dim=1)
    return dict(pts=pts, starts=starts, qorder=qorder.contiguous(), lo=lo.contiguous(),
                cs=cs.contiguous(), slack=(scale * _SLACK).contiguous(), gxy=gxy, gz=gz)


def window_pass(k, new_xyz, tables):
    """The window kernel on ``window_tables``'s output: (idx, dist,
    resolved, fails, fail_kth), the rows of the failing queries unwritten,
    ``resolved`` [B] int32 their count, ``fails`` [B, M] int32 their
    indices in its first ``resolved[b]`` slots, in no set order, and
    ``fail_kth`` [B, M] float32 beside it the last squared distance of
    each one's window list.  CUDA tensors only."""
    lib = build.library()
    b, m = new_xyz.shape[0], new_xyz.shape[1]
    n = tables["pts"].shape[1]
    dev = new_xyz.device
    idx = torch.empty((b, m, k), dtype=torch.int32, device=dev)
    dist = torch.empty((b, m, k), dtype=torch.float32, device=dev)
    resolved = torch.zeros((b,), dtype=torch.int32, device=dev)
    fails = torch.empty((b, m), dtype=torch.int32, device=dev)
    fail_kth = torch.empty((b, m), dtype=torch.float32, device=dev)
    t = tables
    status = lib.repsurf_knn_window(
        ptr(t["pts"]), ptr(t["starts"]), ptr(new_xyz), ptr(t["qorder"]),
        ptr(t["lo"]), ptr(t["cs"]), ptr(t["slack"]), b, n, m, k, t["gxy"], t["gz"],
        ptr(idx), ptr(dist), ptr(resolved), ptr(fails), ptr(fail_kth), stream(dev),
    )
    check_launch(status, "repsurf_knn_window")
    knn_window.launches += 1
    knn_window.launches_by_k[k] += 1
    knn_window.launches_by_shape[f"{b}x{n}->{m},k={k}"] += 1
    return idx, dist, resolved, fails, fail_kth


def window_resolve(k, new_xyz, tables, idx, dist, resolved, fails, fail_kth):
    """The re-solve kernel: writes the listed queries' rows of idx and dist
    (``window_pass``'s outputs) in place.  A fixed grid of blocks strides
    over each sample's count on the device."""
    lib = build.library()
    b, m = new_xyz.shape[0], new_xyz.shape[1]
    n = tables["pts"].shape[1]
    cells = tables["starts"].shape[1] - 1
    total = _RESOLVE_BLOCKS_PER_SM * _sm_count(new_xyz.device.index)
    blocks = max(1, min(m, -(-total // b)))
    status = lib.repsurf_knn_window_resolve(
        ptr(tables["pts"]), ptr(tables["starts"]), ptr(new_xyz), ptr(fails), ptr(fail_kth),
        ptr(resolved), b, n, m, k, cells, blocks, ptr(idx), ptr(dist), stream(new_xyz.device),
    )
    check_launch(status, "repsurf_knn_window_resolve")
    knn_window.resolve_launches += 1


def knn_window(k, xyz, new_xyz, valid=None):
    """Exact kNN (the semantics of ``knn.knn_plain``); the plain version on
    the CPU, the window and re-solve kernels on a CUDA device, where the
    inputs are cut from the graph.  Returns idx [B, M, k] int32, dist
    [B, M, k] float32."""
    if xyz.device.type == "cpu":
        return knn_plain(k, xyz, new_xyz, valid=valid)
    lib = build.library()
    xyz, new_xyz, valid = check_knn_args(k, xyz, new_xyz, valid,
                                         lib.repsurf_knn_window_max_k())
    t = window_tables(k, xyz, new_xyz, valid)
    idx, dist, resolved, fails, fail_kth = window_pass(k, new_xyz, t)
    window_resolve(k, new_xyz, t, idx, dist, resolved, fails, fail_kth)
    knn_window.resolved = resolved
    knn_window.resolved_total = knn_window.resolved_total + resolved.sum()
    return idx, dist


knn_window.launches = 0
knn_window.launches_by_k = collections.Counter()  # window passes keyed by k
knn_window.launches_by_shape = collections.Counter()  # window passes, "BxN->M,k=K"
knn_window.resolve_launches = 0
knn_window.resolved = None  # [B] int32 on the device, the last call's count
knn_window.resolved_total = 0  # summed on the device; set to 0 to restart
