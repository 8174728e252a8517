"""Exact kNN at scene scale over a 3-D grid of cells: the CUDA kernel
``csrc/knn_window.cu``, with ``knn.knn_plain`` as its plain version.

Replaces repsurf_tpu/ops/pallas/knn_window.py:_window_kernel.  It computes
the same function as the brute kernel, bit for bit (see ``knn.py``).
``knn_window`` runs the plain version for a tensor on the CPU and the kernel
for a tensor on a CUDA device.

``window_tables`` is the data preparation, plain torch ops on the device as
the JAX package does it in XLA: the grid sized from (N, k), the points
sorted by cell with the start of every cell's run, and the queries in cell
order.  The kernel scans the 3 x 3 x 3 cells around each query and rescans
the whole cloud for a query whose k-th distance the window cannot vouch
for; ``knn_window.resolved`` holds the last call's per-sample count of such
queries, ``knn_window.resolved_total`` the sum over calls since it was last
set to 0.
"""

import torch

from . import build
from .common import check_launch, ptr, stream
from .knn import check_knn_args, knn_plain

# the guard's allowance for the float32 rounding of the cell assignment,
# relative to the largest coordinate magnitude of the grid's bounding box
_SLACK = 1e-5


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


def knn_window(k, xyz, new_xyz, valid=None):
    """Exact kNN (the semantics of ``knn.knn_plain``); the plain version on
    the CPU, the window kernel on a CUDA device, where the inputs are cut
    from the graph.  Returns idx [B, M, k] int32, dist [B, M, k] float32."""
    if xyz.device.type == "cpu":
        return knn_plain(k, xyz, new_xyz, valid=valid)
    lib = build.library()
    xyz, new_xyz, valid = check_knn_args(k, xyz, new_xyz, valid,
                                         lib.repsurf_knn_window_max_k())
    b, n, m = xyz.shape[0], xyz.shape[1], new_xyz.shape[1]
    t = window_tables(k, xyz, new_xyz, valid)
    idx = torch.empty((b, m, k), dtype=torch.int32, device=xyz.device)
    dist = torch.empty((b, m, k), dtype=torch.float32, device=xyz.device)
    resolved = torch.zeros((b,), dtype=torch.int32, device=xyz.device)
    status = lib.repsurf_knn_window(
        ptr(t["pts"]), ptr(t["starts"]), ptr(new_xyz), ptr(t["qorder"]),
        ptr(t["lo"]), ptr(t["cs"]), ptr(t["slack"]), b, n, m, k, t["gxy"], t["gz"],
        ptr(idx), ptr(dist), ptr(resolved), stream(xyz.device),
    )
    check_launch(status, "repsurf_knn_window")
    knn_window.launches += 1
    knn_window.resolved = resolved
    knn_window.resolved_total = knn_window.resolved_total + resolved.sum()
    return idx, dist


knn_window.launches = 0
knn_window.resolved = None  # [B] int32 on the device, the last call's count
knn_window.resolved_total = 0  # summed on the device; set to 0 to restart
