"""Batch norm over the trailing channel axis of a channels-last tensor,
with masked training statistics and the ReLU that follows it: the CUDA
kernels of ``csrc/batch_norm.cu`` and their plain PyTorch versions.

Replaces no Pallas kernel: the JAX package leaves ``MaskedBatchNorm`` to
XLA.  ``nn.layers.MaskedBatchNorm`` calls ``batch_norm`` for a CUDA tensor.
Three entry points, each running its plain version for a tensor on the CPU
and its kernels for a tensor on a CUDA device (float32 or float64):

  * ``batch_norm_stats``: the masked count, mean and biased variance of the
    counted rows, the running buffers updated in place -> (mean, invstd,
    cnt);
  * ``batch_norm_normalize``: y = (x - mean) * (invstd * weight) + bias,
    optionally ReLU'd; invstd given, or from a variance (the running one);
  * ``batch_norm_backward``: the gradient of both, every row's output
    feeding it while the statistics come from the counted rows alone.

Each computes what the module's torch composition computes, and its
backward what autograd computes for that composition, operation for
operation: the plain versions write those operations out (on the CPU they
equal autograd of the composition bit for bit), and the kernels take the
same float operations on each element and each sum in the order of
torch's own CUDA reduction (see the source), so that a training step on
the card is the composition's, bit for bit.  With g' the gradient where
the ReLU passed it, k = invstd * weight, d = x - mean and w the rows' count
flags: dbias = sum g', dweight = invstd * sum g' d, and dx = (g' k + (dcs w)
(2 d)) + ds w, where dcs = (-0.5 * sum(g' d) * weight) * invstd^3 / cnt and
ds = (-sum(g' k) - sum((dcs w) (2 d))) / cnt are the variance's and the
mean's paths.

A mask is given as ``row_groups`` makes it: a contiguous bool [G] and the
rows a group spans, S = rows / G (row r counts where groups[r // S]), so a
[B, N, 1] mask over [B, N, 16, C] is read as one byte per 16 rows and no
float weight of x's rows is ever built on the card.  ``batch_norm`` runs the
three in an autograd Function: the statistics outside the graph, the
normalisation inside, which saves x, mean, invstd (or the running
variance), cnt and the mask, and finds the ReLU's mask by recomputing y's
sign from x.

Counters: ``batch_norm.launches`` by route, a call each on a CUDA device:
'stats', 'normalize' (training statistics), 'eval' (running statistics),
'backward'.
"""

import functools
import math

import torch

from . import build
from .common import check_launch, ptr, stream


def row_groups(mask, lead):
    """A row mask broadcastable to ``lead`` (x.shape[:-1]; a trailing
    singleton axis is dropped, as the module's [..., 1] masks have) ->
    (contiguous bool [G], S): row r of x's flattened rows counts where
    groups[r // S].  A mask over the leading axes broadcast over the rest
    is kept at its size; any other broadcast is expanded to every row.
    (None, 1) for no mask."""
    if mask is None:
        return None, 1
    lead = tuple(lead)
    m = mask[..., 0] if mask.ndim == len(lead) + 1 and mask.shape[-1] == 1 else mask
    m = m.reshape((1,) * (len(lead) - m.ndim) + tuple(m.shape))
    k = max((i for i, s in enumerate(m.shape) if s != 1), default=-1)
    if tuple(m.shape[:k + 1]) == lead[:k + 1]:
        return m.reshape(-1).to(torch.bool).contiguous(), math.prod(lead[k + 1:])
    return torch.broadcast_to(m, lead).reshape(-1).to(torch.bool).contiguous(), 1


def _row_weight(x, groups, group_rows):
    """The rows' count flags as the composition's float weight, x.shape[:-1]
    + (1,), or None without a mask."""
    if groups is None:
        return None
    g = groups.to(x.dtype)[:, None].expand(groups.shape[0], group_rows)
    return g.reshape(*x.shape[:-1], 1)


def batch_norm_stats_plain(x, groups, group_rows, running_mean, running_var, momentum, eps):
    """The module's two-pass masked statistics, its operations in its
    order, the running buffers updated in place -> (mean [C], invstd [C],
    cnt [1]: the counted rows clamped to 1, in x's dtype)."""
    x = x.detach()
    axes = tuple(range(x.ndim - 1))
    w = _row_weight(x, groups, group_rows)
    if w is None:
        cnt = torch.full((), float(math.prod(x.shape[:-1])), dtype=x.dtype, device=x.device)
        s = x.sum(dim=axes)
    else:
        cnt = w.sum()
        s = (x * w).sum(dim=axes)
    cnt = torch.clamp(cnt, min=1.0)
    mean = s / cnt
    sq = torch.square(x - mean)
    cs = (sq if w is None else sq * w).sum(dim=axes)
    var = torch.clamp(cs / cnt, min=0.0)
    with torch.no_grad():
        unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
        running_mean.mul_(1 - momentum).add_(momentum * mean)
        running_var.mul_(1 - momentum).add_(momentum * unbiased)
    return mean, torch.rsqrt(var + eps), cnt.reshape(1)


def _invstd(scale, from_var, eps):
    return torch.rsqrt(scale + eps) if from_var else scale


def batch_norm_normalize_plain(x, mean, scale, from_var, eps, weight, bias, relu):
    """(x - mean) * (invstd * weight) + bias, ReLU'd when ``relu``; invstd
    is ``scale``, or rsqrt(scale + eps) when ``from_var``."""
    y = (x - mean) * (_invstd(scale, from_var, eps) * weight) + bias
    return torch.relu(y) if relu else y


def batch_norm_backward_plain(grad, x, groups, group_rows, mean, scale, from_var, eps, weight,
                              bias, cnt, relu):
    """The backward (module docstring) in autograd's operations and order
    -> (dx, dweight, dbias); ``cnt`` None: the statistics were the running
    ones."""
    inv = _invstd(scale, from_var, eps)
    k = inv * weight
    d = x - mean
    g = torch.where(d * k + bias <= 0, 0.0, grad) if relu else grad
    axes = tuple(range(x.ndim - 1))
    dbias, gd = g.sum(dim=axes), (g * d).sum(dim=axes)
    dweight = gd * inv
    c1 = g * k
    if cnt is None:
        return c1, dweight, dbias
    w = _row_weight(x, groups, group_rows)
    dcs = ((-0.5 * (gd * weight)) * (inv * inv * inv)) / cnt
    c2 = (dcs if w is None else dcs * w) * (2.0 * d)
    ds = (-c1.sum(dim=axes) + -c2.sum(dim=axes)) / cnt
    return (c1 + c2) + (ds if w is None else ds * w), dweight, dbias


def _check(x, *channel_tensors, groups=None):
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x: expected float32 or float64, got {x.dtype}")
    if groups is not None and (groups.device != x.device or groups.dtype != torch.bool):
        raise ValueError(f"groups: expected bool on {x.device}, got {groups.dtype} on "
                         f"{groups.device}")
    c = x.shape[-1] if x.ndim else 0
    for t in channel_tensors:
        if t.dtype != x.dtype or t.shape != (c,) or t.device != x.device:
            raise ValueError(f"per-channel tensors must be {x.dtype} [{c}] on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    rows = x.numel() // c if c else 0
    return _aligned(x), rows, c


def _aligned(t):
    """t contiguous and 16-byte aligned, copied only where it is not (a
    view into the middle of a buffer)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=None)
def _card(device):
    """(SMs, threads a multiprocessor) of a card: torch's reduction sizes
    its launch from them, so the sums in its order do too."""
    p = torch.cuda.get_device_properties(device)
    return p.multi_processor_count, p.max_threads_per_multi_processor


def _scratch(lib, x, rows, c):
    card = _card(x.device)
    n = lib.repsurf_bn_scratch_bytes(rows, c, int(x.dtype == torch.float64), *card)
    if n < 0:
        raise ValueError(f"batch_norm kernels: no launch for {rows} rows of {c} channels")
    return torch.empty(n, dtype=torch.uint8, device=x.device), card


def batch_norm_stats(x, groups, group_rows, running_mean, running_var, momentum, eps):
    """Training statistics of x [..., C] over the rows ``groups`` counts
    (``row_groups``), the running buffers updated in place -> (mean [C],
    invstd [C], cnt [1]).  The plain version on the CPU; on a CUDA device
    the kernels, with no host sync."""
    if x.device.type == "cpu":
        return batch_norm_stats_plain(x, groups, group_rows, running_mean, running_var,
                                      momentum, eps)
    x, rows, c = _check(x, running_mean, running_var, groups=groups)
    if not running_mean.is_contiguous() or not running_var.is_contiguous():
        raise ValueError("running_mean / running_var: expected contiguous buffers")
    lib = build.library()
    scratch, card = _scratch(lib, x, rows, c)
    out = torch.empty(2 * c + 1, dtype=x.dtype, device=x.device)
    base, item = out.data_ptr(), x.element_size()
    status = lib.repsurf_bn_stats(
        ptr(x), ptr(groups), rows, c, 0 if groups is None else groups.numel(), group_rows,
        int(x.dtype == torch.float64), momentum, eps, ptr(running_mean), ptr(running_var), base,
        base + c * item, base + 2 * c * item, ptr(scratch), *card, stream(x.device))
    check_launch(status, "repsurf_bn_stats")
    batch_norm.launches["stats"] += 1
    return out[:c], out[c:2 * c], out[2 * c:]


def batch_norm_normalize(x, mean, scale, from_var, eps, weight, bias, relu):
    """y = (x - mean) * (invstd * weight) + bias over x [..., C], ReLU'd
    when ``relu``; invstd = ``scale``, or rsqrt(scale + eps) when
    ``from_var``.  The plain version on the CPU; on a CUDA device one
    launch."""
    if x.device.type == "cpu":
        return batch_norm_normalize_plain(x, mean, scale, from_var, eps, weight, bias, relu)
    x, rows, c = _check(x, mean, scale, weight, bias)
    y = torch.empty_like(x)
    status = build.library().repsurf_bn_normalize(
        ptr(x), rows, c, int(x.dtype == torch.float64), ptr(mean), ptr(scale), int(from_var),
        eps, ptr(weight), ptr(bias), int(relu), ptr(y), stream(x.device))
    check_launch(status, "repsurf_bn_normalize")
    batch_norm.launches["eval" if from_var else "normalize"] += 1
    return y


def batch_norm_backward(grad, x, groups, group_rows, mean, scale, from_var, eps, weight, bias,
                        cnt, relu):
    """The backward of ``batch_norm_normalize`` (and, with ``cnt``, of the
    statistics) -> (dx, dweight, dbias).  The plain version on the CPU; on
    a CUDA device the kernels."""
    if x.device.type == "cpu":
        return batch_norm_backward_plain(grad, x, groups, group_rows, mean, scale, from_var, eps,
                                         weight, bias, cnt, relu)
    x, rows, c = _check(x, mean, scale, weight, bias, groups=groups)
    if grad.shape != x.shape or grad.dtype != x.dtype:
        raise ValueError(f"grad: expected {x.dtype} {tuple(x.shape)}, got {grad.dtype} "
                         f"{tuple(grad.shape)}")
    grad = _aligned(grad)
    lib = build.library()
    scratch, card = _scratch(lib, x, rows, c)
    dx = torch.empty_like(x)
    dparams = torch.empty((2, c), dtype=x.dtype, device=x.device)
    base = dparams.data_ptr()
    status = lib.repsurf_bn_backward(
        ptr(grad), ptr(x), ptr(groups), rows, c, group_rows, int(x.dtype == torch.float64),
        ptr(mean), ptr(scale), int(from_var), eps, ptr(weight), ptr(bias), ptr(cnt), int(relu),
        ptr(dx), base, base + c * x.element_size(), ptr(scratch), *card, stream(x.device))
    check_launch(status, "repsurf_bn_backward")
    batch_norm.launches["backward"] += 1
    dweight, dbias = dparams.unbind(0)
    return dx, dweight, dbias


class _Normalize(torch.autograd.Function):
    """``batch_norm_normalize`` with ``batch_norm_backward``; the statistics
    (mean, scale, cnt) come in as constants."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, scale, cnt, groups, group_rows, from_var, eps, relu):
        ctx.save_for_backward(x, weight, bias, mean, scale, cnt, groups)
        ctx.config = (group_rows, from_var, eps, relu)
        return batch_norm_normalize(x, mean, scale, from_var, eps, weight, bias, relu)

    @staticmethod
    def backward(ctx, grad):
        x, weight, bias, mean, scale, cnt, groups = ctx.saved_tensors
        group_rows, from_var, eps, relu = ctx.config
        dx, dweight, dbias = batch_norm_backward(grad, x, groups, group_rows, mean, scale,
                                                 from_var, eps, weight, bias, cnt, relu)
        return dx, dweight, dbias, None, None, None, None, None, None, None, None


def batch_norm(x, weight, bias, running_mean, running_var, mask=None, training=True,
               momentum=0.1, eps=1e-5, relu=False):
    """``MaskedBatchNorm``'s function on the entry points above: training
    statistics over the rows ``mask`` counts (broadcastable to
    x.shape[:-1]), the running buffers updated; or, with ``training``
    False, the running statistics.  Differentiable in x, weight and bias."""
    x = x.contiguous()
    if training:
        groups, group_rows = row_groups(mask, x.shape[:-1])
        mean, scale, cnt = batch_norm_stats(x, groups, group_rows, running_mean, running_var,
                                            momentum, eps)
        from_var = False
    else:
        groups, group_rows, mean, scale, cnt, from_var = (
            None, 1, running_mean, running_var, None, True)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _Normalize.apply(x, weight, bias, mean, scale, cnt, groups, group_rows,
                                from_var, eps, relu)
    return batch_norm_normalize(x, mean, scale, from_var, eps, weight, bias, relu)


batch_norm.launches = {"stats": 0, "normalize": 0, "backward": 0, "eval": 0}
