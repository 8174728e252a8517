"""Linear layers with torch-default init, and batch norm with masked
statistics (repsurf_tpu/nn/layers.py).

Both work on the trailing channel axis of channels-last tensors, the
reference's 1x1 convolutions.  Parameters are drawn from an explicit
``torch.Generator`` when one is given.
"""

import math

import torch
from torch import nn

from ..parallel.distributed import all_reduce_sum


class Linear(nn.Linear):
    """``nn.Linear`` whose torch-default init, U(+-1/sqrt(fan_in)) for the
    weight and the bias, is drawn from an explicit generator."""

    def __init__(self, in_features, out_features, bias=True, generator=None):
        self._generator = generator
        super().__init__(in_features, out_features, bias=bias)
        del self._generator

    def reset_parameters(self):
        bound = 1.0 / math.sqrt(self.in_features) if self.in_features > 0 else 0.0
        gen = getattr(self, "_generator", None)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=gen)
            if self.bias is not None:
                self.bias.uniform_(-bound, bound, generator=gen)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over every non-channel axis, with optional row masking.

    torch BatchNorm semantics: biased variance to normalize, unbiased for
    the running estimate, momentum 0.1, eps 1e-5.  In eval mode the running
    statistics are used.  Training statistics use the two-pass masked form
    (mean first, then the centered second moment) of the JAX package.
    Parameters are named as torch's (weight, bias, running_mean,
    running_var).

    With a ``process_group`` (the JAX module's ``axis_name``), training
    statistics span the group's ranks: the masked count and sum are
    all-reduced, then the centred second moment, and the gradient flows
    back through both (``parallel.distributed.all_reduce_sum``).  The
    running buffers update from those statistics on every rank.
    """

    def __init__(self, num_features, momentum=0.1, eps=1e-5, process_group=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.process_group = process_group
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x, mask=None):
        """x: [..., C]; mask: optional bool, broadcastable to x.shape[:-1],
        True rows count in the statistics."""
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.ndim - 1))
            group = self.process_group
            if mask is None:
                w = None
                cnt = torch.tensor(float(math.prod(x.shape[:-1])), device=x.device)
                s = x.sum(dim=axes)
            else:
                if mask.ndim == x.ndim and mask.shape[-1] == 1:
                    mask = mask[..., 0]
                w = torch.broadcast_to(mask, x.shape[:-1]).to(x.dtype)[..., None]
                cnt = w.sum()
                s = (x * w).sum(dim=axes)
            if group is not None:
                cnt = all_reduce_sum(cnt, group)
                s = all_reduce_sum(s, group)
            cnt = torch.clamp(cnt, min=1.0)
            mean = s / cnt
            sq = torch.square(x - mean)
            cs = (sq if w is None else sq * w).sum(dim=axes)
            if group is not None:
                cs = all_reduce_sum(cs, group)
            var = torch.clamp(cs / cnt, min=0.0)
            with torch.no_grad():
                unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        inv = torch.rsqrt(var + self.eps)
        return (x - mean) * (inv * self.weight) + self.bias


class Dropout(nn.Module):
    """Inverted dropout whose mask comes from an explicit generator
    (``nn.Dropout`` reads torch's global RNG).

    In training, ``forward(x, generator)`` keeps each element with
    probability 1 - p, drawn as ``torch.rand(...) < 1 - p`` from
    ``generator`` (on x's device), and scales the kept ones by 1 / (1 - p),
    flax's ``nn.Dropout`` formula.  In eval mode, or at p = 0, it is the
    identity and draws nothing.
    """

    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x, generator=None):
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("training-mode dropout needs an explicit generator")
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / torch.tensor(keep, dtype=x.dtype, device=x.device), 0.0)
