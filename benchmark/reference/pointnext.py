"""Plain PyTorch forward of PointNeXt's segmentation network as its S3DIS
recipe builds it (Qian et al., *PointNeXt: Revisiting PointNet++ with
Improved Training and Scaling Strategies*, NeurIPS 2022, arXiv:2206.04670;
guochengqian/PointNeXt ``cfgs/s3dis/pointnext-xl.yaml``,
``cfgs/s3dis/default.yaml``, openpoints ``models/backbone/pointnext.py``
and ``models/segmentation/base_seg.py``), over a dict of parameters and
buffers under the port's module names, in float32 with TF32 off (the
harness clears torch's TF32 flags before the program or this runs).
Nothing here imports the program.

Every 1x1 convolution is a Linear over the trailing channel axis, without a
bias where a batch norm follows.  With widths C_0 = ``width`` and C_i =
2^i C_0:

    f_0  = stem [rgb, height]                  (Linear with a bias; height
                                                z - the cloud's lowest z)
    stage i = 1..4, stride 4, radius r_i = radius * scaling^(i - 1):
      SA:  q = FPS(p, n // 4);  f_i = max_j ReLU(BN(W [(p_j - q) / r_i, f_j]))
           over the ball of q at r_i in the previous stage's points
      blocks[i] - 1 times, over the stage's own points at 2 r_i:
           a = max_j ReLU(BN(W_a [(p_j - p) / (2 r_i), f_j]))
           f = ReLU(BN(W_2 ReLU(BN(W_1 a))) + f)       (W_1: C -> 4C)
    decoder i = 4..1: f_{i-1} = two Linear + BN + ReLU of
           [f_{i-1}, 3-NN interpolation of f_i onto the points of i - 1]
    head:  Linear + BN + ReLU, Dropout(0.5), Linear to the classes

A ball is the first ``nsample`` points of the cloud within the radius in
index order, a short ball padded with its first hit (openpoints'
``ball_query``); the interpolation weighs the 3 nearest coarse points by
1 / (d + 1e-8), normalised (``three_interpolation``).

Departures from openpoints (the program's semantics, which the check holds
it to):

* the ball test is d2 <= float32(r**2), where openpoints' CUDA tests
  d2 < r**2; d2 is summed from direct coordinate differences;
* FPS starts at index 0 and breaks ties on the lowest index; kNN ties too;
* clouds are padded to one [B, N] layout with ``valid`` counts: stage i
  keeps valid // 4 points, padded rows are never chosen, and every batch
  norm takes its training statistics over the live rows of all the batch's
  clouds (biased variance, eps 1e-5), over every slot of a live query in a
  [B, M, nsample, C] tensor.

``pnx_plan`` works out the geometry, which needs only coordinates, once
for the whole forward: each stage's FPS, its set abstraction's balls, the
balls of its points in themselves (one selection serves all the stage's
blocks, as a selection of their own would give the same indices) and the
3-NN weights of each decoder stage, the balls chunked over queries so
that a batch of 8 x 24,000 points fits.
"""

import dataclasses

import torch

from . import ops
from .models import Precision, _mask, batch_norm, dropout, lin

# queries of a ball chunk: about this many squared distances a chunk
BALL_CHUNK = 2**26


@dataclasses.dataclass
class PnxPlan:
    centers: list  # [B, N_i, 3] of stage i, stage 0 the input cloud
    valids: list  # [B] real points of each stage, or None
    down: list  # [B, N_i, nsample] ball of stage i's points in stage i - 1 (i >= 1)
    near: list  # [B, N_i, nsample] ball of stage i's points in themselves (i >= 1)
    interp: list  # (idx, weight) [B, N_i, 3] from stage i + 1 onto stage i


def radii(arch):
    """(set abstraction radius, blocks' radius) of stages 1..4."""
    r, out = arch["radius"], []
    for _ in arch["strides"][1:]:
        out.append((r, r * arch["radius_scaling"]))
        r *= arch["radius_scaling"]
    return out


def ball(radius, nsample, xyz, q, valid):
    """``ops.ball_query`` over chunks of the queries."""
    b, n = xyz.shape[:2]
    step = max(1, BALL_CHUNK // (b * n))
    return torch.cat([ops.ball_query(radius, nsample, xyz, q[:, s:s + step], valid)
                      for s in range(0, q.shape[1], step)], 1)


def pnx_plan(arch, coord, valid, train):
    """The geometry of the forward of clouds ``coord`` [B, N, 3] with
    ``valid`` [B] real points (or None); ``train`` changes nothing (the
    recipe samples by plain FPS)."""
    k = arch["nsample"]
    with torch.no_grad():
        centers, valids, down, near = [coord], [valid], [None], [None]
        for stride, (r_sa, r_block) in zip(arch["strides"][1:], radii(arch)):
            c, v = centers[-1], valids[-1]
            m = max(c.shape[1] // stride, 1)
            nv = None if v is None else v // stride
            nc = ops.gather(c, ops.fps(c, m, v))
            down.append(ball(r_sa, k, c, nc, v))
            near.append(ball(r_block, k, nc, nc, nv))
            centers.append(nc)
            valids.append(nv)
        interp = [ops.interpolation(centers[i + 1], centers[i], valids[i + 1])
                  for i in range(len(centers) - 1)]
    return PnxPlan(centers, valids, down, near, interp)


def aggregate(p, prec, name, pos, new_pos, x, idx, radius, mask, train):
    """``LocalAggregation``: [(p_j - q) / r, f_j] of each query's ball,
    Linear, BN, ReLU, max over the slots -> [B, M, C]."""
    dp = ops.div(ops.gather(pos, idx) - new_pos[:, :, None], radius)
    g = torch.cat([dp, ops.gather(x, idx)], -1)
    h = torch.relu(batch_norm(p, f"{name}.bn", lin(p, prec, f"{name}.conv", g), mask, train))
    return h.amax(2)


def inv_res(p, prec, name, pos, x, idx, radius, mask, train):
    """``InvResMLP``: the aggregation over the stage's own points, the
    expanding and the projecting pointwise layers, the residual."""
    a = aggregate(p, prec, f"{name}.aggregate", pos, pos, x, idx, radius, mask, train)
    u = torch.relu(batch_norm(p, f"{name}.bn1", lin(p, prec, f"{name}.pw1", a), mask, train))
    return torch.relu(batch_norm(p, f"{name}.bn2", lin(p, prec, f"{name}.pw2", u), mask, train)
                      + x)


def propagate(p, prec, name, skip, coarse, interp, mask, train):
    """``FeaturePropogation``: the skip features beside the interpolated
    coarse ones, two Linear + BN + ReLU."""
    idx, weight = interp
    x = torch.cat([skip, (ops.gather(coarse, idx) * weight[..., None]).sum(2)], -1)
    for j in (1, 2):
        x = torch.relu(batch_norm(p, f"{name}.bn{j}", lin(p, prec, f"{name}.conv{j}", x), mask,
                                  train))
    return x


def pnx_forward(p, arch, plan, feature, train, sign=None, gen=None, prec=Precision()):
    """Logits [B, N, classes] of pointnext on ``plan``'s clouds with
    ``feature`` [B, N, in_channel - 1] (the colours).  ``sign`` is taken for
    ``models.seg_forward``'s signature (the network draws no inversion);
    ``gen`` draws the head's dropout in training."""
    coord, valid = plan.centers[0], plan.valids[0]
    masks = [_mask(v, c.shape[1]) for v, c in zip(plan.valids, plan.centers)]
    z = coord[..., 2]
    low = z if valid is None else torch.where(ops.counts_mask(valid, z.shape[1]), z, float("inf"))
    height = z - low.amin(1, keepdim=True)
    x = lin(p, prec, "stem", torch.cat([feature, height[..., None]], -1))
    feats = [x]
    for i, (blocks, (r_sa, r_block)) in enumerate(zip(arch["blocks"][1:], radii(arch)), start=1):
        pos = plan.centers[i]
        x = aggregate(p, prec, f"enc{i}.0.aggregate", plan.centers[i - 1], pos, x, plan.down[i],
                      r_sa, masks[i], train)
        for j in range(1, blocks):
            x = inv_res(p, prec, f"enc{i}.{j}", pos, x, plan.near[i], r_block, masks[i], train)
        feats.append(x)
    for i in range(len(feats) - 1, 0, -1):
        x = propagate(p, prec, f"dec{i}", feats[i - 1], x, plan.interp[i - 1], masks[i - 1],
                      train)
    x = torch.relu(batch_norm(p, "head.1", lin(p, prec, "head.0", x), masks[0], train))
    x = dropout(x, arch["head_dropout"], gen, train)
    return lin(p, prec, "head.4", x)


def smoothed_ce(logits, target, eps, ignore):
    """torch's ``cross_entropy(logits, target, ignore_index=ignore,
    label_smoothing=eps)`` written out: over the points whose target is not
    ``ignore``, the mean of (1 - eps) * -log p_target + eps * the mean of
    -log p over the K classes."""
    k = logits.shape[-1]
    logits, target = logits.reshape(-1, k), target.reshape(-1)
    keep = target != ignore
    logp = torch.log_softmax(logits, -1)
    nll = -logp.gather(1, torch.where(keep, target, 0)[:, None])[:, 0]
    smooth = -logp.sum(-1) / k
    per = (1.0 - eps) * nll + eps * smooth
    return torch.where(keep, per, 0.0).sum() / keep.sum()
