"""Fused umbrella geometry: the CUDA kernels of ``csrc/umbrella.cu`` and
their plain PyTorch version.

``umbrella_features_kernel`` is the counterpart of the JAX package's
``umbrella_features_pallas`` (repsurf_tpu/ops/pallas/umbrella.py:866-989),
with the same arguments, dispatch and refusals.  Three kernels compute one
function:

  * 'tq' (replaces ``_umbrella_tq_kernel``): an aligned group of 4 lanes
    per query, the kNN scan and the fan geometry split over the group,
    G <= 16;
  * 'full' (replaces ``_umbrella_kernel``): one warp per query, G*C <= 128;
  * 'slab' (replaces ``_umbrella_slab_kernel``): each sample x-sorted and cut
    into slabs of 128 points, every query searched in the 3-slab window
    around its own; a guard flags each query whose k-th neighbour could lie
    outside the window, and those are re-solved with the brute kNN kernel
    (``knn.knn_brute``) and the plain composition.  G*C <= 128, N a multiple
    of 128 and at least 384.

'auto' takes 'tq' for G <= 16, else 'full'; 'slab' runs only when asked.
``umbrella_fan_features_plain`` is the one plain version, the composition of
the geometry functions (geometry/umbrella.py); the entry runs it for a
tensor on the CPU, whatever the impl, and a kernel for a tensor on a CUDA
device.  Neither applies the per-sample normal inversion;
geometry.umbrella.umbrella_features does.

Gradient: the kernels have no backward of their own.  As in the JAX package
(repsurf_tpu/geometry/umbrella.py:198-249, _umbrella_pallas_xla_vjp), the
gradient with respect to xyz is that of the plain composition, recomputed
on the same inputs in the backward pass, for every style.  The stock models
feed data coordinates, so this backward never runs in them.

Counters: ``umbrella_features_kernel.launches`` counts launches by impl,
``launches_by_style`` by style; ``slab_resolved`` holds the last slab call's
[B] count of re-solved queries.
"""

import torch

from ..gather import index_points
from ..masking import BIG_DIST2
from . import build
from .common import check_launch, counts_i32, cuda_f32, ptr, stream
from .knn import knn_brute, knn_plain, pairwise_dist2

MAX_FANS = 16  # tq: the JAX auto bound (umbrella.py:909)
MAX_LANES = 128  # full and slab: G * C (umbrella.py:920-921)
SLAB = 128  # points per slab, queries per block of the slab kernel
IMPLS = ("tq", "full", "slab")


def fan_shape(k, drop_self, return_dist):
    """(G, C): fans per point and channels per fan."""
    return (k - 1 if drop_self else k), (10 if return_dist else 9)


def umbrella_fan_features_plain(xyz, k, drop_self=False, rotate=False, return_dist=True,
                                style="cls", valid=None):
    """Plain version: the composition of the geometry functions over the
    plain kNN (same arguments as ``umbrella_features_kernel``).

    Returns:
      [B, N, G, C] float32, G = k - 1 (drop_self) or k, C = 10 or 9.
    """
    from ...geometry.umbrella import umbrella_composition

    return umbrella_composition(xyz, k, drop_self=drop_self, rotate=rotate,
                                return_dist=return_dist, style=style, valid=valid,
                                knn_fn=knn_plain)


def slab_table(xyz, valid=None):
    """Each sample x-sorted by a stable sort, invalid points last (key
    +inf), as [B, N, 4] rows (x, y, z, original index) float32."""
    b, n, _ = xyz.shape
    col = torch.arange(n, device=xyz.device)
    key = xyz[..., 0]
    if valid is not None:
        key = torch.where(col[None, :] < valid.to(xyz.device)[:, None], key, float("inf"))
    order = torch.sort(key, dim=1, stable=True).indices
    rows = torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3))
    return torch.cat([rows, order.to(torch.float32)[..., None]], dim=-1).contiguous()


def slab_guard(kth, margin, valid=None):
    """The queries the slab window cannot vouch for (umbrella.py:827-830):
    the k-th squared distance reaches the margin to the nearest excluded x,
    or no k valid points lay in the window.  [B, N] bool, original order."""
    n = kth.shape[1]
    bad = (kth >= (0.999 * margin).square()) | (kth >= BIG_DIST2)
    if valid is not None:
        bad = bad & (torch.arange(n, device=kth.device)[None, :] < valid.to(kth.device)[:, None])
    return bad


def slab_guard_plain(xyz, k, valid=None):
    """Plain replay of the slab kernel's guard: the x-sort, each slab's
    window, the k-th squared distance in it and the margin, then
    ``slab_guard``.  Returns the [B, N] bool re-solve mask."""
    b, n, _ = xyz.shape
    table = slab_table(xyz, valid)
    n_slabs = n // SLAB
    c0 = torch.clamp(torch.arange(n_slabs, device=xyz.device) - 1, 0, n_slabs - 3)
    win = table[:, (c0[:, None] * SLAB + torch.arange(3 * SLAB, device=xyz.device)).reshape(-1)]
    win = win.reshape(b, n_slabs, 3 * SLAB, 4)
    q = table.reshape(b, n_slabs, SLAB, 4)
    nv = torch.full((b,), n, device=xyz.device) if valid is None else valid.to(xyz.device)
    d2 = pairwise_dist2(q[..., :3].reshape(b * n_slabs, SLAB, 3),
                        win[..., :3].reshape(b * n_slabs, 3 * SLAB, 3))
    d2 = d2.reshape(b, n_slabs, SLAB, 3 * SLAB)
    ok = win[..., 3] < nv[:, None, None]
    d2 = torch.where(ok[:, :, None, :], d2, BIG_DIST2)
    kth = torch.clamp(torch.kthvalue(d2, k, dim=-1).values, max=BIG_DIST2)
    qx = q[..., 0]
    wlo, whi = win[:, :, :1, 0], win[:, :, -1:, 0]
    right_ok = ok[:, :, -1:]
    big = torch.tensor(BIG_DIST2, device=xyz.device)
    ml = torch.where((c0 > 0)[None, :, None], qx - wlo, big)
    mr = torch.where((c0 < n_slabs - 3)[None, :, None] & right_ok, whi - qx, big)
    margin = torch.clamp(torch.minimum(ml, mr), min=0.0)
    # back to the original order
    orig = table[..., 3].long()
    kth_o = torch.empty_like(kth.reshape(b, n)).scatter_(1, orig, kth.reshape(b, n))
    margin_o = torch.empty_like(kth_o).scatter_(1, orig, margin.reshape(b, n))
    return slab_guard(kth_o, margin_o, valid)


def _resolve(feat, bad, xyz, k, drop_self, rotate, return_dist, style, valid):
    """Re-solve the flagged queries: the brute kNN kernel and the plain
    composition over its indices (umbrella.py:714-751), scattered into
    ``feat`` in place.  Returns the [B] count of re-solved queries."""
    from ...geometry.umbrella import umbrella_for_queries

    count = bad.sum(dim=1)
    pos = bad.nonzero()  # [T, 2] (sample, point), row-major
    if pos.shape[0] == 0:
        return count
    first = torch.cumsum(count, 0) - count
    slot = torch.arange(pos.shape[0], device=bad.device) - first[pos[:, 0]]
    qidx = torch.zeros((bad.shape[0], int(count.max())), dtype=torch.long, device=bad.device)
    qidx[pos[:, 0], slot] = pos[:, 1]
    queries = index_points(xyz, qidx)
    idx, _ = knn_brute(k, xyz, queries, valid=valid)
    if drop_self:
        idx = idx[:, :, 1:]
    fix = umbrella_for_queries(xyz, queries, idx, rotate=rotate, return_dist=return_dist,
                               style=style)
    feat[pos[:, 0], pos[:, 1]] = fix[pos[:, 0], slot]
    return count


def _flags(k, drop_self, rotate, return_dist, style):
    return (k, int(drop_self), int(rotate), int(return_dist), int(style == "seg"))


def _launch(impl, xyz, valid, k, drop_self, rotate, return_dist, style):
    b, n = xyz.shape[0], xyz.shape[1]
    g, c = fan_shape(k, drop_self, return_dist)
    flags = _flags(k, drop_self, rotate, return_dist, style)
    lib = build.library()
    out = torch.empty((b, n, g, c), dtype=torch.float32, device=xyz.device)
    dev = stream(xyz.device)
    if impl == "slab":
        table = slab_table(xyz, valid)
        kth = torch.empty((b, n), dtype=torch.float32, device=xyz.device)
        margin = torch.empty_like(kth)
        status = lib.repsurf_umbrella_slab(ptr(table), ptr(xyz), ptr(valid), b, n, *flags,
                                           ptr(out), ptr(kth), ptr(margin), dev)
    else:
        fn = lib.repsurf_umbrella_tq if impl == "tq" else lib.repsurf_umbrella_full
        status = fn(ptr(xyz), ptr(valid), b, n, *flags, ptr(out), dev)
    check_launch(status, f"repsurf_umbrella_{impl}")
    umbrella_features_kernel.launches[impl] += 1
    umbrella_features_kernel.launches_by_style[style] += 1
    if impl == "slab":
        umbrella_features_kernel.slab_resolved = _resolve(
            out, slab_guard(kth, margin, valid), xyz, k, drop_self, rotate, return_dist,
            style, valid)
    return out


class _UmbrellaFans(torch.autograd.Function):
    """A kernel forward; the plain composition's vector-Jacobian product as
    the backward (see the module doc)."""

    @staticmethod
    def forward(ctx, xyz, valid, k, drop_self, rotate, return_dist, style, impl):
        ctx.save_for_backward(xyz, valid)
        ctx.args = (k, drop_self, rotate, return_dist, style)
        return _launch(impl, xyz, valid, k, drop_self, rotate, return_dist, style)

    @staticmethod
    def backward(ctx, g):
        xyz, valid = ctx.saved_tensors
        k, drop_self, rotate, return_dist, style = ctx.args
        with torch.enable_grad():
            x = xyz.detach().requires_grad_(True)
            feat = umbrella_fan_features_plain(x, k, drop_self=drop_self, rotate=rotate,
                                               return_dist=return_dist, style=style, valid=valid)
            (dx,) = torch.autograd.grad(feat, x, g)
        return dx, None, None, None, None, None, None, None


def umbrella_features_kernel(xyz, k, drop_self=False, rotate=False, return_dist=True,
                             style="cls", valid=None, impl="auto"):
    """Fused umbrella geometry: points -> per-fan surface features.

    Args:
      xyz: [B, N, 3] float32 cloud (the fan centers are the same cloud).
      k: kNN size (group_size + 1).
      drop_self: kNN column 0 removed (cls), G = k - 1; else G = k.
      rotate: azimuth in the fixed rotated frame (seg).
      return_dist: include the plane-constant channel (C = 10, else 9).
      style: 'cls' | 'seg' channel order.
      valid: optional [B] valid counts.
      impl: 'auto' | 'tq' | 'full' | 'slab' (see the module doc).

    Returns:
      [B, N, G, C] float32.
    """
    if style not in ("cls", "seg"):
        raise ValueError(f"style must be 'cls' or 'seg', got {style!r}")
    if impl not in ("auto", *IMPLS):
        raise ValueError(f"impl must be one of auto, {', '.join(IMPLS)}; got {impl!r}")
    b, n = xyz.shape[0], xyz.shape[1]
    g, c = fan_shape(k, drop_self, return_dist)
    if g < 1:
        raise ValueError(f"k={k} leaves no fan")
    if impl == "auto":
        impl = "tq" if g <= MAX_FANS else "full"
    if impl == "tq" and g > MAX_FANS:
        raise ValueError(f"the tq umbrella kernel takes at most {MAX_FANS} fans, got {g}")
    if impl != "tq" and g * c > MAX_LANES:
        raise ValueError(f"umbrella fans*channels {g * c} exceed {MAX_LANES} lanes")
    if impl == "slab" and (n % SLAB or n < 3 * SLAB):
        raise ValueError(
            f"the slab umbrella takes N a multiple of {SLAB} and at least {3 * SLAB}, got "
            f"{n}: the JAX slab route covers only N // {SLAB} slabs and clips its window "
            "for at least 3 of them (repsurf_tpu/ops/pallas/umbrella.py:629,764,791), so "
            "it returns wrong rows for other N")
    if xyz.device.type == "cpu":
        return umbrella_fan_features_plain(xyz, k, drop_self=drop_self, rotate=rotate,
                                           return_dist=return_dist, style=style, valid=valid)
    xyz = cuda_f32(xyz, "xyz", (b, n, 3))
    valid = counts_i32(valid, b, xyz.device)
    return _UmbrellaFans.apply(xyz, valid, k, drop_self, rotate, return_dist, style, impl)


def umbrella_tq_scan_floor(xyz, k, drop_self=False, rotate=False, return_dist=True,
                           style="cls", valid=None):
    """The tq kernel's launch without its fan geometry and feature stores
    (repsurf_umbrella_tq_scan_floor), on a CUDA device: each query's k best
    squared distances summed, [B, N].  A measurement of the scan and the
    merge, the floor under the kernel's time; not counted as a launch."""
    b, n = xyz.shape[0], xyz.shape[1]
    xyz = cuda_f32(xyz, "xyz", (b, n, 3))
    valid = counts_i32(valid, b, xyz.device)
    out = torch.empty((b, n), dtype=torch.float32, device=xyz.device)
    status = build.library().repsurf_umbrella_tq_scan_floor(
        ptr(xyz), ptr(valid), b, n, *_flags(k, drop_self, rotate, return_dist, style), ptr(out),
        stream(xyz.device))
    check_launch(status, "repsurf_umbrella_tq_scan_floor")
    return out


umbrella_features_kernel.launches = dict.fromkeys(IMPLS, 0)
umbrella_features_kernel.launches_by_style = {"cls": 0, "seg": 0}
umbrella_features_kernel.slab_resolved = None  # [B] on the device, the last slab call's
