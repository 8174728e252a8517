"""Fused ball query + grouping: the CUDA kernels ``csrc/ball_group.cu``,
their backward, and their plain PyTorch versions.

Replaces repsurf_tpu/ops/pallas/ball_group.py:

* ``ball_group_feature``: _ball_feat_kernel and :_ball_feat_t_kernel, the
  TPU's wide and narrow layouts of one function (the SA-CD input split,
  reached through ball_group_feature_pallas); one kernel serves both.
* ``ball_group_channels``: _ball_kernel (ball_group_pallas), the grouping of
  every channel, reached through ``ops/neighbors.ball_group``.
* ``ball_scatter``: the backward of both, the custom VJPs _ball_feat_bwd and
  _ball_group_bwd: a scatter-add of the cotangent through the selection.

Each wrapper runs the plain version for a tensor on the CPU, where autograd
differentiates it, and on a CUDA device a ``torch.autograd.Function`` whose
forward is the kernel and whose backward is the scatter kernel.  The
forward saves the selection it made ([B, M, S] int32; 4 MB at the first SA
stage) rather than search again in the backward;
``ball_group_feature_selection`` returns it beside pos and feat.

Gradients, as the JAX kernel route defines them (``(None, None, dtcat,
None)``): the grouped channels get the scatter-add of their cotangent;
``pos`` (coordinates relative to the query, and their polar angles) carries
none, and nothing flows to ``xyz`` or ``new_xyz`` through the selection or
through ``pos``.  In ``ball_group_feature`` channels 0:3 of the grouped
tensor are the coordinates themselves, so their gradient is 0.  The models
treat coordinates as data, so no gradient is lost there; the plain version
on the CPU would differentiate ``pos`` as well.
"""

import collections
import functools

import torch

from ...geometry.polar import xyz2sphere
from ..gather import index_points
from ..neighbors import ball_query
from . import build
from .common import check_launch, counts_i32, cuda_f32, ptr, stream


def _concat(tensors):
    live = [t for t in tensors if t is not None]
    return torch.cat(live, dim=-1) if len(live) > 1 else live[0]


@functools.lru_cache(maxsize=64)
def _radius2(radius):
    """float32(radius**2), the radius test's bound, as a Python float."""
    return float(torch.tensor(float(radius) ** 2, dtype=torch.float32))


@functools.lru_cache(maxsize=1)
def _max_nsample():
    """The kernels' largest group size S (csrc/ball_group.cu kMaxS)."""
    return build.library().repsurf_ball_feature_max_nsample()


def ball_group_feature_plain(radius, nsample, xyz, new_xyz, tensors, valid=None,
                             return_polar=False):
    """Plain version: ball query, gather, relative coordinates, polar.

    Args:
      radius: ball radius; the test is d2 <= float32(radius**2).
      nsample: group size S.
      xyz: [B, N, 3] reference cloud.
      new_xyz: [B, M, 3] ball centers.
      tensors: channel tensors [B, N, C_i] (None passes), tensors[0] being
        xyz itself, as the SA stages group (center, normal, feature).
      valid: optional [B] counts of real reference points.
      return_polar: append xyz2sphere of the relative coordinates to pos.

    Returns:
      pos [B, M, S, 3|6] and feat [B, M, S, C-3], C the summed channels.
    """
    idx = ball_query(radius, nsample, xyz, new_xyz, valid=valid)
    grouped = index_points(_concat(tensors), idx)
    rel = index_points(xyz, idx) - new_xyz[:, :, None, :]
    pos = torch.cat([rel, xyz2sphere(rel)], dim=-1) if return_polar else rel
    return pos, grouped[..., 3:]


def ball_group_channels_plain(radius, nsample, xyz, new_xyz, tcat, valid=None):
    """Plain version of the row grouping: ``index_points(tcat,
    ball_query(...))``, [B, N, C] -> [B, M, S, C]."""
    return index_points(tcat, ball_query(radius, nsample, xyz, new_xyz, valid=valid))


def ball_scatter_plain(sel, g, n, coff=0):
    """Plain version of the backward: ``index_add_`` of the cotangent rows
    g [B, M, S, C] into the points sel [B, M, S] selected -> [B, N, coff + C],
    channels 0:coff zero.  In g's dtype (float64 for a reference)."""
    b, c = sel.shape[0], g.shape[-1]
    key = (sel.to(torch.int64)
           + torch.arange(b, device=sel.device)[:, None, None] * n).reshape(-1)
    out = torch.zeros((b * n, c), dtype=g.dtype, device=g.device)
    out.index_add_(0, key, g.reshape(-1, c))
    if coff:
        out = torch.cat([out.new_zeros((b * n, coff)), out], dim=-1)
    return out.reshape(b, n, coff + c)


def selection_csr(sel, n):
    """The plain version of the runs the backward kernel builds: the slots
    of sel [B, M, S] grouped by point.  Returns (order [B*M*S] int32, the
    flat slot indices sorted by b*N + sel, stably, so each point's slots
    stay in ascending (m, s) order; starts [B*N + 1] int32, where each
    point's run begins)."""
    b = sel.shape[0]
    key = (sel.to(torch.int64)
           + torch.arange(b, device=sel.device)[:, None, None] * n).reshape(-1)
    sorted_key, order = torch.sort(key, stable=True)
    bounds = torch.arange(b * n + 1, device=sel.device)
    starts = torch.searchsorted(sorted_key, bounds)
    return order.to(torch.int32).contiguous(), starts.to(torch.int32).contiguous()


def ball_scatter(sel, g, n, coff=0, return_runs=False):
    """The backward kernel: sel [B, M, S] int32 (values in [0, n)) and g
    [B, M, S, C] float32 on a CUDA device -> [B, N, coff + C],
    deterministic, in one launch that builds the point runs itself (see
    csrc/ball_group.cu); the plain version for tensors on the CPU.

    ``return_runs`` also returns the runs (order, starts) as
    ``selection_csr`` gives them: written by the kernel on a CUDA device, a
    check of its counting sort; ``selection_csr`` itself on the CPU."""
    if g.device.type == "cpu":
        out = ball_scatter_plain(sel, g, n, coff)
        return (out, *selection_csr(sel, n)) if return_runs else out
    b, m, s = sel.shape
    g = cuda_f32(g, "g", (b, m, s, None))
    if sel.dtype != torch.int32 or sel.device != g.device:
        raise TypeError(f"sel: expected int32 on {g.device}, got {sel.dtype} on {sel.device}")
    sel = sel.contiguous()
    c, q, dev = g.shape[-1], m * s, g.device
    lib = build.library()
    words = _scratch_words(b, n, q)
    scratch = torch.empty(words, dtype=torch.int32, device=dev) if words else None
    out = torch.empty((b, n, coff + c), dtype=torch.float32, device=dev)
    order = starts = None
    if return_runs:
        order = torch.empty(b * q, dtype=torch.int32, device=dev)
        starts = torch.empty(b * n + 1, dtype=torch.int32, device=dev)
    status = lib.repsurf_ball_scatter(
        ptr(sel), ptr(g), b, n, q, c, coff, ptr(scratch), ptr(out), ptr(order), ptr(starts),
        stream(dev),
    )
    check_launch(status, "repsurf_ball_scatter")
    return (out, order, starts) if return_runs else out


@functools.lru_cache(maxsize=64)
def _scratch_words(b, n, q):
    """Global scratch ints the scatter kernel needs (0: its runs fit in
    shared memory), by shape."""
    return build.library().repsurf_ball_scatter_scratch(b, n, q)


def _cuda_args(nsample, xyz, new_xyz, tcat, valid, min_c):
    b, n = xyz.shape[0], xyz.shape[1]
    xyz = cuda_f32(xyz.detach(), "xyz", (b, n, 3))
    new_xyz = cuda_f32(new_xyz.detach(), "new_xyz", (b, None, 3))
    if new_xyz.device != xyz.device:
        raise ValueError(f"new_xyz on {new_xyz.device}, xyz on {xyz.device}")
    tcat = cuda_f32(tcat, "tensors", (b, n, None))
    max_s = _max_nsample()
    if tcat.shape[-1] < min_c or not 0 < nsample <= max_s:
        raise ValueError(
            f"ball kernel needs C >= {min_c} and 0 < nsample <= {max_s}, "
            f"got C={tcat.shape[-1]}, nsample={nsample}"
        )
    return xyz, new_xyz, tcat, counts_i32(valid, b, xyz.device)


def _feature_launch(tcat, xyz, new_xyz, valid, radius, nsample, return_polar, keep_sel):
    """One launch of the feature kernel on checked CUDA inputs: (pos, feat,
    sel [B, M, S] int32 when ``keep_sel``, else None)."""
    b, n, c = tcat.shape
    m = new_xyz.shape[1]
    dev = tcat.device
    pos = torch.empty((b, m, nsample, 6 if return_polar else 3),
                      dtype=torch.float32, device=dev)
    feat = torch.empty((b, m, nsample, c - 3), dtype=torch.float32, device=dev)
    sel = torch.empty((b, m, nsample), dtype=torch.int32, device=dev) if keep_sel else None
    status = build.library().repsurf_ball_feature(
        ptr(xyz), ptr(new_xyz), ptr(tcat), ptr(valid), b, n, m, c, nsample,
        _radius2(radius), int(return_polar), ptr(pos), ptr(feat), ptr(sel),
        stream(dev),
    )
    check_launch(status, "repsurf_ball_feature")
    ball_group_feature.launches += 1
    ball_group_feature.launches_by_channels[c] += 1
    ball_group_feature.launches_by_shape[f"{b}x{n}->{m},S={nsample},C={c}"] += 1
    return pos, feat, sel


class _BallFeature(torch.autograd.Function):
    """The feature kernel with the scatter kernel as its backward."""

    @staticmethod
    def forward(ctx, tcat, xyz, new_xyz, valid, radius, nsample, return_polar):
        keep = ctx.needs_input_grad[0]
        pos, feat, sel = _feature_launch(tcat, xyz, new_xyz, valid, radius, nsample,
                                         return_polar, keep)
        ctx.mark_non_differentiable(pos)
        if keep:
            ctx.save_for_backward(sel)
            ctx.n = tcat.shape[1]
        return pos, feat

    @staticmethod
    def backward(ctx, g_pos, g_feat):
        (sel,) = ctx.saved_tensors
        dtcat = ball_scatter(sel, g_feat.contiguous(), ctx.n, coff=3)
        ball_group_feature.backward_launches_by_channels[dtcat.shape[-1]] += 1
        return dtcat, None, None, None, None, None, None


def ball_group_feature(radius, nsample, xyz, new_xyz, tensors, valid=None,
                       return_polar=False):
    """Ball-group features (see the module doc); the plain version on the
    CPU, the CUDA kernel on a CUDA device.  Same arguments and returns as
    ``ball_group_feature_plain``."""
    if xyz.device.type == "cpu":
        return ball_group_feature_plain(
            radius, nsample, xyz, new_xyz, tensors, valid=valid,
            return_polar=return_polar,
        )
    xyz, new_xyz, tcat, valid = _cuda_args(nsample, xyz, new_xyz, _concat(tensors),
                                           valid, min_c=3)
    return _BallFeature.apply(tcat, xyz, new_xyz, valid, radius, nsample, return_polar)


def ball_group_feature_selection(radius, nsample, xyz, new_xyz, tensors, valid=None,
                                 return_polar=False):
    """``ball_group_feature`` with the selection it made, without a graph:
    (pos, feat, sel [B, M, S] int32).  The kernel and the selection it
    writes on a CUDA device (what the forward saves for its backward);
    the plain version and ``ball_query`` on the CPU."""
    if xyz.device.type == "cpu":
        pos, feat = ball_group_feature_plain(radius, nsample, xyz, new_xyz, tensors, valid=valid,
                                             return_polar=return_polar)
        return pos, feat, ball_query(radius, nsample, xyz, new_xyz, valid=valid)
    xyz, new_xyz, tcat, valid = _cuda_args(nsample, xyz, new_xyz, _concat(tensors), valid,
                                           min_c=3)
    with torch.no_grad():
        return _feature_launch(tcat.detach(), xyz, new_xyz, valid, radius, nsample,
                               return_polar, True)


ball_group_feature.launches = 0
# launches keyed by the grouped channel count C (13 and 141 in the classifier)
ball_group_feature.launches_by_channels = collections.Counter()
ball_group_feature.backward_launches_by_channels = collections.Counter()
# launches keyed by "BxN->M,S=nsample,C=channels": points, queries, group size
# and grouped channels (self-queries read N->N)
ball_group_feature.launches_by_shape = collections.Counter()


class _BallGroup(torch.autograd.Function):
    """The row-grouping kernel with the scatter kernel as its backward."""

    @staticmethod
    def forward(ctx, tcat, xyz, new_xyz, valid, radius, nsample):
        b, n, c = tcat.shape
        m = new_xyz.shape[1]
        dev = tcat.device
        out = torch.empty((b, m, nsample, c), dtype=torch.float32, device=dev)
        keep = ctx.needs_input_grad[0]
        sel = torch.empty((b, m, nsample), dtype=torch.int32, device=dev) if keep else None
        status = build.library().repsurf_ball_group(
            ptr(xyz), ptr(new_xyz), ptr(tcat), ptr(valid), b, n, m, c, nsample,
            _radius2(radius), ptr(out), ptr(sel), stream(dev),
        )
        check_launch(status, "repsurf_ball_group")
        ball_group_channels.launches_by_channels[c] += 1
        if keep:
            ctx.save_for_backward(sel)
            ctx.n = n
        return out

    @staticmethod
    def backward(ctx, g):
        (sel,) = ctx.saved_tensors
        dtcat = ball_scatter(sel, g.contiguous(), ctx.n)
        ball_group_channels.backward_launches_by_channels[dtcat.shape[-1]] += 1
        return dtcat, None, None, None, None, None


def ball_group_channels(radius, nsample, xyz, new_xyz, tcat, valid=None):
    """Ball query + grouping of every channel of tcat [B, N, C] -> [B, M, S,
    C]; the plain version on the CPU, the CUDA kernel on a CUDA device
    (S <= 128)."""
    if xyz.device.type == "cpu":
        return ball_group_channels_plain(radius, nsample, xyz, new_xyz, tcat, valid=valid)
    xyz, new_xyz, tcat, valid = _cuda_args(nsample, xyz, new_xyz, tcat, valid, min_c=1)
    return _BallGroup.apply(tcat, xyz, new_xyz, valid, radius, nsample)


def ball_group_select_floor(radius, nsample, xyz, new_xyz, channels, valid=None):
    """The row kernel's launch for ``channels`` channels without its output
    walk (repsurf_ball_group_select_floor), on a CUDA device: the selection
    alone, sel [B, M, S] int32.  A measurement of the staged selection, the
    floor under the row kernel's time; not counted as a launch."""
    b, n = xyz.shape[0], xyz.shape[1]
    xyz = cuda_f32(xyz.detach(), "xyz", (b, n, 3))
    new_xyz = cuda_f32(new_xyz.detach(), "new_xyz", (b, None, 3))
    m = new_xyz.shape[1]
    valid = counts_i32(valid, b, xyz.device)
    sel = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz.device)
    status = build.library().repsurf_ball_group_select_floor(
        ptr(xyz), ptr(new_xyz), ptr(valid), b, n, m, channels, nsample, _radius2(radius),
        ptr(sel), stream(xyz.device))
    check_launch(status, "repsurf_ball_group_select_floor")
    return sel


# launches keyed by the channel count C
ball_group_channels.launches_by_channels = collections.Counter()
ball_group_channels.backward_launches_by_channels = collections.Counter()
