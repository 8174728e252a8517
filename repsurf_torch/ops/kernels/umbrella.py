"""Fused umbrella geometry: the CUDA kernels of ``csrc/umbrella.cu`` and
their plain PyTorch version.

``umbrella_features_kernel`` is the counterpart of the JAX package's
``umbrella_features_pallas`` (repsurf_tpu/ops/pallas/umbrella.py:866-989),
with the same arguments, dispatch and refusals.  Three routes compute one
function, bit-equal to one another on every row they define:

  * 'tq' (replaces ``_umbrella_tq_kernel``): an aligned group of 4 lanes
    per query, the kNN scan and the fan geometry split over the group,
    G <= 16;
  * 'full' (replaces ``_umbrella_kernel``): one warp per query, the same
    scan and epilogue over 32 lanes, G*C <= 128;
  * 'slab' (replaces ``_umbrella_slab_kernel``): each sample x-sorted and cut
    into slabs of 128 points (``slab_order``, a torch sort, as the JAX
    package sorts in XLA), every query searched in the 3-slab window
    around its own by ``slab_pass``, whose kernel also computes the guard
    and lists each query whose k-th neighbour could lie outside the window;
    ``slab_resolve``, a second kernel on the same stream, re-solves the
    listed queries over the whole cloud.  The host waits on neither.
    G*C <= 128, N a multiple of 128 and at least 384; rows past a sample's
    valid count are left as the window found them.

'auto' takes 'tq' for G <= 16, else 'full'; 'slab' runs only when asked.
``umbrella_fan_features_plain`` is the one plain version, the composition of
the geometry functions (geometry/umbrella.py), and ``slab_guard_plain`` the
plain replay of the slab's guard; the entry runs the plain version for a
tensor on the CPU, whatever the impl, and a kernel for a tensor on a CUDA
device.  Neither applies the per-sample normal inversion;
geometry.umbrella.umbrella_features does.

Gradient: the kernels have no backward of their own.  As in the JAX package
(repsurf_tpu/geometry/umbrella.py:198-249, _umbrella_pallas_xla_vjp), the
gradient with respect to xyz is that of the plain composition, recomputed
on the same inputs in the backward pass, for every style.  The stock models
feed data coordinates, so this backward never runs in them.

Counters: ``umbrella_features_kernel.launches`` counts launches by impl (a
slab call's window pass under 'slab'), ``launches_by_style`` by style,
``slab_resolve_launches`` the slab's re-solve passes; ``slab_resolved``
holds the last slab call's [B] count of re-solved queries, on the device.
"""

import torch

from ..masking import BIG_DIST2
from . import build
from .common import check_launch, counts_i32, cuda_f32, ptr, stream
from .knn import _sm_count, knn_plain, pairwise_dist2

MAX_FANS = 16  # tq: the JAX auto bound (umbrella.py:909)
MAX_LANES = 128  # full and slab: G * C (umbrella.py:920-921)
SLAB = 128  # points per slab
IMPLS = ("tq", "full", "slab")
# slab re-solve blocks a call, over all samples, for each SM of the card,
# and the listed queries a block takes
_RESOLVE_BLOCKS_PER_SM, _RESOLVE_QUERIES = 8, 32


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


def slab_order(xyz, valid=None):
    """Each sample's points by ascending x, a stable sort with invalid
    points last (key +inf): [B, N] int32 original indices, the window
    kernel's input (the JAX package sorts in XLA)."""
    n = xyz.shape[1]
    key = xyz[..., 0]
    if valid is not None:
        col = torch.arange(n, device=xyz.device)
        key = torch.where(col[None, :] < valid.to(xyz.device)[:, None], key, float("inf"))
    return torch.sort(key, dim=1, stable=True).indices.to(torch.int32)


def slab_table(xyz, valid=None):
    """``slab_order`` as the window kernel stages it: [B, N, 4] rows (x, y,
    z, original index) float32, each sample x-sorted."""
    order = slab_order(xyz, valid).long()
    rows = torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3))
    return torch.cat([rows, order.to(torch.float32)[..., None]], dim=-1)


def slab_guard(kth, margin, valid=None):
    """The queries the slab window cannot vouch for (umbrella.py:827-830):
    the k-th squared distance reaches the margin to the nearest excluded x,
    or no k valid points lay in the window.  [B, N] bool, original order.
    The window kernel computes the same test per query."""
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


def _flags(k, drop_self, rotate, return_dist, style):
    return (k, int(drop_self), int(rotate), int(return_dist), int(style == "seg"))


def slab_pass(xyz, valid, order, k, drop_self=False, rotate=False, return_dist=True,
              style="cls"):
    """The slab's window kernel on ``slab_order``'s output: (out, resolved,
    fails), out [B, N, G, C] with the rows of the failing queries unwritten,
    ``resolved`` [B] int32 their count, ``fails`` [B, N] int32 their indices
    in its first ``resolved[b]`` slots, in no set order.  CUDA tensors
    only; ``valid`` int32 [B] or None."""
    b, n = xyz.shape[0], xyz.shape[1]
    g, c = fan_shape(k, drop_self, return_dist)
    out = torch.empty((b, n, g, c), dtype=torch.float32, device=xyz.device)
    resolved = torch.zeros((b,), dtype=torch.int32, device=xyz.device)
    fails = torch.empty((b, n), dtype=torch.int32, device=xyz.device)
    status = build.library().repsurf_umbrella_slab(
        ptr(order), ptr(xyz), ptr(valid), b, n, *_flags(k, drop_self, rotate, return_dist, style),
        ptr(out), ptr(resolved), ptr(fails), stream(xyz.device))
    check_launch(status, "repsurf_umbrella_slab")
    umbrella_features_kernel.launches["slab"] += 1
    return out, resolved, fails


def slab_resolve(xyz, valid, out, resolved, fails, k, drop_self=False, rotate=False,
                 return_dist=True, style="cls"):
    """The slab's re-solve kernel: writes the listed queries' rows of out
    (``slab_pass``'s outputs) in place, each over the whole valid cloud.  A
    fixed grid of blocks strides over each sample's count on the device."""
    b, n = xyz.shape[0], xyz.shape[1]
    per_sample = -(-_RESOLVE_BLOCKS_PER_SM * _sm_count(xyz.device.index) // b)
    blocks = min(per_sample, -(-n // _RESOLVE_QUERIES))  # no more than the list can fill
    status = build.library().repsurf_umbrella_slab_resolve(
        ptr(xyz), ptr(valid), b, n, *_flags(k, drop_self, rotate, return_dist, style),
        ptr(resolved), ptr(fails), blocks, ptr(out), stream(xyz.device))
    check_launch(status, "repsurf_umbrella_slab_resolve")
    umbrella_features_kernel.slab_resolve_launches += 1


def _launch(impl, xyz, valid, k, drop_self, rotate, return_dist, style):
    args = (k, drop_self, rotate, return_dist, style)
    if impl == "slab":
        out, resolved, fails = slab_pass(xyz, valid, slab_order(xyz, valid), *args)
        slab_resolve(xyz, valid, out, resolved, fails, *args)
        umbrella_features_kernel.slab_resolved = resolved
    else:
        b, n = xyz.shape[0], xyz.shape[1]
        g, c = fan_shape(k, drop_self, return_dist)
        out = torch.empty((b, n, g, c), dtype=torch.float32, device=xyz.device)
        fn = getattr(build.library(), f"repsurf_umbrella_{impl}")
        status = fn(ptr(xyz), ptr(valid), b, n, *_flags(*args), ptr(out), stream(xyz.device))
        check_launch(status, f"repsurf_umbrella_{impl}")
        umbrella_features_kernel.launches[impl] += 1
    umbrella_features_kernel.launches_by_style[style] += 1
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


def umbrella_full_warps(xyz, k, warps, drop_self=False, rotate=False, return_dist=True,
                        style="cls", valid=None):
    """The full kernel at ``warps`` queries a block (8, 16 or 32; k <= 9)
    on a CUDA device (repsurf_umbrella_full_warps): the block-size sweep
    behind the kernel's constant, a measurement; not counted as a launch.
    Returns [B, N, G, C], the entry's features."""
    b, n = xyz.shape[0], xyz.shape[1]
    xyz = cuda_f32(xyz, "xyz", (b, n, 3))
    valid = counts_i32(valid, b, xyz.device)
    g, c = fan_shape(k, drop_self, return_dist)
    out = torch.empty((b, n, g, c), dtype=torch.float32, device=xyz.device)
    status = build.library().repsurf_umbrella_full_warps(
        ptr(xyz), ptr(valid), b, n, *_flags(k, drop_self, rotate, return_dist, style), warps,
        ptr(out), stream(xyz.device))
    check_launch(status, "repsurf_umbrella_full_warps")
    return out


umbrella_features_kernel.launches = dict.fromkeys(IMPLS, 0)
umbrella_features_kernel.launches_by_style = {"cls": 0, "seg": 0}
umbrella_features_kernel.slab_resolve_launches = 0
umbrella_features_kernel.slab_resolved = None  # [B] on the device, the last slab call's
