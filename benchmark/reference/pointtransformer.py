"""Plain PyTorch forward of Point Transformer's segmentation network as
RepSurf's repository ships it for S3DIS (hancyran/RepSurf
``segmentation/models/pointtransformer/pointtransformer.py:6-61`` and
``segmentation/modules/pointtransformer_utils.py:7-134``; Zhao, Jiang, Jia,
Torr, Koltun, *Point Transformer*, ICCV 2021, arXiv:2012.09164), over a dict
of parameters and buffers under the published modules' names, in float32
with TF32 off (the harness clears torch's TF32 flags before the program or
this runs).  Nothing here imports the program.

Five encoder stages (``planes``, ``enc_blocks``, ``strides``): a
TransitionDown, then ``enc_blocks[i] - 1`` residual blocks; five decoder
stages of a TransitionUp and one block; a Linear + BN + ReLU + Linear head.
A block is Linear + BN + ReLU, the vector attention, BN + ReLU, Linear +
BN, plus its input, ReLU.  The attention of point i over its ``nsample``
nearest points j (itself included), as ``PointTransformerLayer.forward``
writes it:

    delta_ij = linear_p(p_j - p_i)                      (Linear, BN, ReLU, Linear)
    w_ij     = softmax_j linear_w(x_k[j] - x_q[i] + delta_ij)
                                   (BN, ReLU, Linear C -> C/s, BN, ReLU, Linear)
    y_i      = sum_j (x_v[j] + delta_ij) * w_ij[c mod (C/s)]

with ``s`` = ``share_planes``: the code's ``view(n, nsample, s, C // s) *
w.unsqueeze(2)``, so weight j multiplies the channels c with c mod (C/s) = j.

Departures from the paper:

* the weight takes x_k[j] - x_q[i] + delta (the code's sign), not eq. 3's
  phi(x_i) - psi(x_j) + delta;
* one weight is shared by ``s`` channel groups (the code's
  ``share_planes``), and ``linear_w`` / ``linear_p`` hold batch norms the
  paper's two-layer MLPs do not name;
* the stage-2 sampling is RepSurf's sectorized FPS in training
  (``ops.sectorized_fps``), plain FPS elsewhere.

Departures from the code (the first two change no number at the cell's
sizes, where every cloud is whole and holds far more than ``nsample``
points):

* clouds are padded to one [B, N] layout with ``valid`` counts (the code
  concatenates them with offsets); padded rows are never chosen, and every
  batch norm takes its training statistics over the live rows of all the
  batch's clouds (biased variance, eps 1e-5), over every neighbour row of a
  live point in a [B, N, nsample, C] tensor;
* a point with fewer than ``nsample`` real points in its cloud gets missing
  slots (index 0, ``ops.knn``), which take part in the softmax, the batch
  norms and the max-pool (the code's kNN never leaves one at RepSurf's
  sizes);
* neighbour ties, which clouds on a voxel grid hold many of, break on the
  lowest index, as the program's kNN breaks them.

``pt_plan`` works out the geometry, which needs only coordinates, once for
the whole forward: each stage's FPS, one kNN at ``nsample`` a stage (exact,
so every attention layer and the stage's TransitionDown grouping use the
same indices as a kNN of their own would give) and the 3-NN interpolation
weights of each TransitionUp.
"""

import dataclasses

import torch

from . import ops
from .models import Precision, _mask, batch_norm, lin


@dataclasses.dataclass
class PtPlan:
    centers: list  # [B, N_i, 3] of stage i + 1, stage 1 the input cloud
    valids: list  # [B] real points of each stage, or None
    down: list  # [B, N_i, nsample] neighbours in stage i of stage i + 1's centres (i >= 1)
    near: list  # [B, N_i, nsample] each point's neighbours in its own stage
    interp: list  # (idx, weight) [B, N_i, 3] from stage i + 2 onto stage i + 1 (i < 4)


def pt_plan(arch, coord, valid, train):
    """The geometry of the forward of clouds ``coord`` [B, N, 3] with
    ``valid`` [B] real points (or None); sectorized FPS at stage 2 in
    training."""
    k = arch["nsample"]
    with torch.no_grad():
        centers, valids, down = [coord], [valid], [None]
        for i, stride in enumerate(arch["strides"][1:], start=1):
            c, v = centers[-1], valids[-1]
            m = max(c.shape[1] // stride, 1)
            nv = None if v is None else v // stride
            if i == 1 and train and arch["num_sector"] > 1:
                b, n = c.shape[:2]
                v_all = v if v is not None else torch.full((b,), n, device=c.device)
                nv_all = nv if nv is not None else torch.full_like(v_all, m)
                idx = ops.sectorized_fps(c, m, arch["num_sector"], v_all, nv_all)
            else:
                idx = ops.fps(c, m, v)
            nc = ops.gather(c, idx)
            down.append(ops.knn(k, c, nc, v)[0])
            centers.append(nc)
            valids.append(nv)
        near = [ops.knn(k, c, c, v)[0] for c, v in zip(centers, valids)]
        interp = [ops.interpolation(centers[i + 1], centers[i], valids[i + 1])
                  for i in range(len(centers) - 1)]
    return PtPlan(centers, valids, down, near, interp)


def _bn_relu(p, name, x, mask, train):
    return torch.relu(batch_norm(p, name, x, mask, train))


def attention(p, prec, name, share, pos, x, idx, mask, train):
    """``PointTransformerLayer``: x [B, N, C], idx [B, N, K] -> [B, N, C]."""
    x_q, x_k, x_v = (lin(p, prec, f"{name}.linear_{t}", x) for t in "qkv")
    delta = lin(p, prec, f"{name}.linear_p.0", ops.gather(pos, idx) - pos[:, :, None])
    delta = lin(p, prec, f"{name}.linear_p.3", _bn_relu(p, f"{name}.linear_p.1", delta, mask,
                                                         train))
    w = ops.gather(x_k, idx) - x_q[:, :, None] + delta
    w = lin(p, prec, f"{name}.linear_w.2", _bn_relu(p, f"{name}.linear_w.0", w, mask, train))
    w = lin(p, prec, f"{name}.linear_w.5", _bn_relu(p, f"{name}.linear_w.3", w, mask, train))
    w = torch.softmax(w, dim=2)
    v = ops.gather(x_v, idx) + delta
    b, n, k, c = v.shape
    y = (v.view(b, n, k, share, c // share) * w.unsqueeze(3)).sum(2)
    return y.reshape(b, n, c)


def block(p, prec, name, share, pos, x, idx, mask, train):
    """``PointTransformerBlock``, the residual block."""
    h = _bn_relu(p, f"{name}.bn1", lin(p, prec, f"{name}.linear1", x), mask, train)
    h = attention(p, prec, f"{name}.transformer2", share, pos, h, idx, mask, train)
    h = _bn_relu(p, f"{name}.bn2", h, mask, train)
    h = batch_norm(p, f"{name}.bn3", lin(p, prec, f"{name}.linear3", h), mask, train)
    return torch.relu(h + x)


def transition_down(p, prec, name, pos, new_pos, x, idx, mask, train):
    """Strided ``TransitionDown``: [p_j - p_i, x_j] of each centre's
    neighbours, Linear (no bias), BN, ReLU, max over the neighbours."""
    g = torch.cat([ops.gather(pos, idx) - new_pos[:, :, None], ops.gather(x, idx)], -1)
    return _bn_relu(p, f"{name}.bn", lin(p, prec, f"{name}.linear", g), mask, train).amax(2)


def transition_up_head(p, prec, name, x, valid, mask, train):
    """``TransitionUp`` without a coarser stage: each point beside its
    cloud's mean feature through ``linear2``, then ``linear1``."""
    if valid is None:
        mean = x.sum(1, keepdim=True) / x.shape[1]
    else:
        live = ops.counts_mask(valid, x.shape[1])[..., None].to(x.dtype)
        mean = (x * live).sum(1, keepdim=True) / valid.to(x.dtype)[:, None, None]
    g = torch.relu(lin(p, prec, f"{name}.linear2.0", mean)).expand(-1, x.shape[1], -1)
    return _bn_relu(p, f"{name}.linear1.1", lin(p, prec, f"{name}.linear1.0",
                                                torch.cat([x, g], -1)), mask, train)


def transition_up(p, prec, name, x_fine, x_coarse, interp, mask_fine, mask_coarse, train):
    """``TransitionUp``: ``linear1`` of the fine features plus the 3-NN
    interpolation of ``linear2`` of the coarse ones."""
    a = _bn_relu(p, f"{name}.linear1.1", lin(p, prec, f"{name}.linear1.0", x_fine), mask_fine,
                 train)
    b = _bn_relu(p, f"{name}.linear2.1", lin(p, prec, f"{name}.linear2.0", x_coarse),
                 mask_coarse, train)
    idx, weight = interp
    return a + (ops.gather(b, idx) * weight[..., None]).sum(2)


def pt_forward(p, arch, plan, feature, train, sign=None, gen=None, prec=Precision()):
    """Logits [B, N, classes] of pointtransformer on ``plan``'s clouds with
    ``feature`` [B, N, in_channel - 3].  ``sign`` and ``gen`` are taken for
    ``models.seg_forward``'s signature: the network draws no inversion and
    has no dropout."""
    share = arch["share_planes"]
    pos = plan.centers
    # [B, N, 1] live rows, broadcast over the neighbours of [B, N, K, C]
    masks = [_mask(v, c.shape[1]) for v, c in zip(plan.valids, pos)]
    x = pos[0] if arch["in_channel"] == 3 else torch.cat([pos[0], feature], -1)
    stages = []
    for i, blocks in enumerate(arch["enc_blocks"]):
        name = f"enc{i + 1}"
        if i == 0:
            x = _bn_relu(p, f"{name}.0.bn", lin(p, prec, f"{name}.0.linear", x), masks[0], train)
        else:
            x = transition_down(p, prec, f"{name}.0", pos[i - 1], pos[i], x, plan.down[i],
                                masks[i], train)
        for j in range(1, blocks):
            x = block(p, prec, f"{name}.{j}", share, pos[i], x, plan.near[i], masks[i], train)
        stages.append(x)
    last = len(stages) - 1
    x = transition_up_head(p, prec, f"dec{last + 1}.0", stages[last], plan.valids[last],
                           masks[last], train)
    x = block(p, prec, f"dec{last + 1}.1", share, pos[last], x, plan.near[last], masks[last],
              train)
    for i in range(last - 1, -1, -1):
        x = transition_up(p, prec, f"dec{i + 1}.0", stages[i], x, plan.interp[i], masks[i],
                          masks[i + 1], train)
        x = block(p, prec, f"dec{i + 1}.1", share, pos[i], x, plan.near[i], masks[i], train)
    x = _bn_relu(p, "cls.1", lin(p, prec, "cls.0", x), masks[0], train)
    return lin(p, prec, "cls.3", x)
