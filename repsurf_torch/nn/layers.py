"""Linear layers with torch-default init, batch norm with masked
statistics and the ReLU fused after it (repsurf_tpu/nn/layers.py), and the
runner of the models' layer stacks.

Both work on the trailing channel axis of channels-last tensors, the
reference's 1x1 convolutions.  Parameters are drawn from an explicit
``torch.Generator`` when one is given.

``MaskedBatchNorm`` has two routes.  On a CUDA tensor (outside a process
group in training) it is the hand-written kernels of
``ops/kernels/batch_norm.py``: the masked statistics, the normalisation and
the ReLU, forward and backward, launched with no host copy, and equal bit
for bit to the other route on the same card.  On the CPU, and for
statistics shared over a process group, it is the torch composition of the
JAX package's two-pass form.  ``forward(x, mask, relu=True)`` applies the
ReLU that follows the norm; ``run_layers`` passes it wherever an
``nn.ReLU`` follows a norm in a stack, so the stacks' modules and
state-dict keys stay the reference's.
"""

import math

import torch
from torch import nn

from ..ops.kernels.batch_norm import batch_norm
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
    """BatchNorm over every non-channel axis, with optional row masking and
    the ReLU after it.

    torch BatchNorm semantics: biased variance to normalize, unbiased for
    the running estimate, momentum 0.1, eps 1e-5.  In eval mode the running
    statistics are used.  Training statistics are those of the two-pass
    masked form (mean first, then the centered second moment) of the JAX
    package; an unmasked call counts every row.  Parameters are named as
    torch's (weight, bias, running_mean, running_var).

    On a CUDA tensor the kernels compute it (``ops.kernels.batch_norm``),
    bit for bit the torch composition below and autograd's backward of it;
    on the CPU, and with a ``process_group`` in training, that composition.

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

    def forward(self, x, mask=None, relu=False):
        """x: [..., C]; mask: optional bool, broadcastable to x.shape[:-1],
        True rows count in the statistics; relu: apply the ReLU that
        follows the norm."""
        if x.is_cuda and (self.process_group is None or not self.training):
            return batch_norm(x, self.weight, self.bias, self.running_mean, self.running_var,
                              mask, self.training, self.momentum, self.eps, relu)
        y = self._composition(x, mask)
        return torch.relu(y) if relu else y

    def _composition(self, x, mask):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.ndim - 1))
            group = self.process_group
            if mask is None:  # every row counts; the count filled on x's device, no copy
                w, cnt = 1.0, x.new_full((), float(math.prod(x.shape[:-1])))
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
            cs = (torch.square(x - mean) * w).sum(dim=axes)
            if group is not None:
                cs = all_reduce_sum(cs, group)
            var = torch.clamp(cs / cnt, min=0.0)
            with torch.no_grad():
                unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        inv = torch.rsqrt(var + self.eps)
        return (x - mean) * (inv * self.weight) + self.bias


def run_layers(layers, x, mask=None, generator=None):
    """Run a stack of layers in order: a ``MaskedBatchNorm`` takes ``mask``
    and, where an ``nn.ReLU`` follows it, applies that ReLU itself (the
    ReLU module is then skipped); a ``Dropout`` takes ``generator``."""
    norm = None  # a norm waiting to see whether a ReLU follows
    for layer in layers:
        if norm is not None:
            fused = isinstance(layer, nn.ReLU)
            x, norm = norm(x, mask=mask, relu=fused), None
            if fused:
                continue
        if isinstance(layer, MaskedBatchNorm):
            norm = layer
        elif isinstance(layer, Dropout):
            x = layer(x, generator=generator)
        else:
            x = layer(x)
    return x if norm is None else norm(x, mask=mask)


class Dropout(nn.Module):
    """Inverted dropout whose mask comes from an explicit generator
    (``nn.Dropout`` reads torch's global RNG).

    In training, ``forward(x, generator)`` keeps each element with
    probability 1 - p, drawn as ``torch.rand(...) < 1 - p`` from
    ``generator`` (on x's device), and scales the kept ones by 1 / (1 - p),
    flax's ``nn.Dropout`` formula, dividing by 1 - p filled on x's device (no
    copy from the host).  In eval mode, or at p = 0, it is the identity and
    draws nothing.
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
        return torch.where(mask, x / x.new_full((), keep), 0.0)
