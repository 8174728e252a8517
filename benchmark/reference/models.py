"""Plain PyTorch forwards of the two RepSurf models, over a dict of
parameters and buffers under the reference's names (hancyran/RepSurf
``classification/models/repsurf/repsurf_ssg_umb.py`` and
``segmentation/models/repsurf/repsurf_umb_ssg.py``).

The geometry of a batch (samples, neighbours, interpolation weights) needs
only coordinates, so ``*_plan`` works it out first, for any number of
clouds at once, and ``*_forward`` runs the layers on it.  1x1 convolutions
are Linears over the trailing channel axis; batch norm takes the masked
batch statistics in training (biased variance, eps 1e-5) and the running
ones in evaluation.

``Precision`` says how a Linear multiplies: in float32, or with both
operands rounded to TF32 (10 mantissa bits, as the tensor cores take
them), the control that the comparison has to catch.
"""

import dataclasses
import torch

from . import ops


@dataclasses.dataclass
class Precision:
    tf32: bool = False

    def linear(self, x, w, b=None):
        if self.tf32:
            x, w = tf32_round(x), tf32_round(w)
        y = torch.matmul(x, w.t())
        return y if b is None else y + b


def tf32_round(x):
    """x rounded to the nearest TF32 value (ties away from zero), kept in a
    float32 tensor; differentiable as the identity."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()


def batch_norm(p, name, x, mask, train):
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if not train:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    else:
        axes = tuple(range(x.ndim - 1))
        if mask is None:
            cnt = float(x[..., 0].numel())
            mean = x.sum(axes) / cnt
            var = torch.square(x - mean).sum(axes) / cnt
        else:
            if mask.ndim == x.ndim:
                mask = mask[..., 0]
            m = torch.broadcast_to(mask, x.shape[:-1]).to(x.dtype)[..., None]
            cnt = torch.clamp(m.sum(), min=1.0)
            mean = (x * m).sum(axes) / cnt
            var = (torch.square(x - mean) * m).sum(axes) / cnt
    return (x - mean) * (torch.rsqrt(var + 1e-5) * w) + b


def dropout(x, p, gen, train):
    """Inverted dropout, the mask ``rand < 1 - p`` drawn from ``gen``."""
    if not train or p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / torch.tensor(keep, dtype=x.dtype, device=x.device), 0.0)


def lin(p, prec, name, x):
    return prec.linear(x, p[f"{name}.weight"], p.get(f"{name}.bias"))


def shared_mlp(p, prec, name, x, mask, train, n_layers):
    for j in range(n_layers):
        x = torch.relu(batch_norm(p, f"{name}.mlp_bns.{j}", lin(p, prec, f"{name}.mlp_convs.{j}", x),
                                  mask, train))
    return x


def _mask(valid, n):
    return None if valid is None else ops.counts_mask(valid, n)[:, :, None]


def _sa_first(p, prec, name, pos, feat, mask, train):
    loc = batch_norm(p, f"{name}.bn_l0", lin(p, prec, f"{name}.mlp_l0", pos), mask, train)
    fea = batch_norm(p, f"{name}.bn_f0", lin(p, prec, f"{name}.mlp_f0", feat), mask, train)
    return torch.relu(loc + fea)


# -- segmentation: repsurf_umb_ssg ------------------------------------------

@dataclasses.dataclass
class SegPlan:
    centers: list  # [B, N_i, 3] per level, level 0 the input
    valids: list  # [B] per level, or None
    fps: list  # [B, N_i] picks of level i from level i - 1, i >= 1
    group: list  # [B, N_i, 32] neighbours in level i - 1
    interp: list  # (idx, weight) from level i onto level i - 1

    def rows(self, s, e):
        """The plan of clouds [s, e)."""
        cut = lambda t: None if t is None else t[s:e]  # noqa: E731
        return SegPlan([cut(t) for t in self.centers], [cut(t) for t in self.valids],
                       [cut(t) for t in self.fps], [cut(t) for t in self.group],
                       [None if t is None else (cut(t[0]), cut(t[1])) for t in self.interp])


def seg_plan(arch, coord, valid, train):
    """The geometry of the segmentation forward (sectorized FPS in the first
    stage in training)."""
    centers, valids = [coord], [valid]
    fps_idx, group, interp = [None], [None], [None]
    for i in range(len(arch["sa_mlp"])):
        c, v = centers[-1], valids[-1]
        m = max(c.shape[1] // arch["stride"], 1)
        nv = None if v is None else v // arch["stride"]
        if i == 0 and train and arch["num_sector"] > 1:
            v_all = v if v is not None else torch.full((c.shape[0],), c.shape[1], device=c.device)
            nv_all = nv if nv is not None else torch.full_like(v_all, m)
            idx = ops.sectorized_fps(c, m, arch["num_sector"], v_all, nv_all)
        else:
            idx = ops.fps(c, m, v)
        nc = ops.gather(c, idx)
        gidx, _ = ops.knn(arch["nsample"], c, nc, v)
        centers.append(nc)
        valids.append(nv)
        fps_idx.append(idx)
        group.append(gidx)
    for j in range(1, len(centers)):
        interp.append(ops.interpolation(centers[j], centers[j - 1], valids[j]))
    return SegPlan(centers, valids, fps_idx, group, interp)


def seg_forward(p, arch, plan, feature, train, sign=None, gen=None, prec=Precision()):
    """Logits [B, N, classes] of repsurf_umb_ssg."""
    coord, valid = plan.centers[0], plan.valids[0]
    mask0 = _mask(valid, coord.shape[1])
    x = ops.umbrella(coord, arch["group_size"] + 1, "seg", valid, sign)
    x = lin(p, prec, "surface_constructor.mlps.0", x)
    x = torch.relu(batch_norm(p, "surface_constructor.mlps.1", x, mask0, train))
    normal = lin(p, prec, "surface_constructor.mlps.3", x).sum(2)
    normals, feats = [normal], [torch.cat([coord, feature], -1)]
    n_sa = len(arch["sa_mlp"])
    for i in range(1, n_sa + 1):
        c, nc, gidx = plan.centers[i - 1], plan.centers[i], plan.group[i]
        pos = ops.gather(c, gidx) - nc[:, :, None]
        if arch["return_polar"]:
            pos = torch.cat([pos, ops.sphere(pos)], -1)
        feat = torch.cat([ops.gather(normals[-1], gidx), ops.gather(feats[-1], gidx)], -1)
        mask = _mask(plan.valids[i], nc.shape[1])
        h = _sa_first(p, prec, f"sa{i}", pos, feat, mask, train)
        h = shared_mlp(p, prec, f"sa{i}", h, mask, train, len(arch["sa_mlp"][i - 1]) - 1)
        normals.append(ops.gather(normals[-1], plan.fps[i]))
        feats.append(h.amax(2))
    x = feats[-1]
    for j in range(n_sa, 0, -1):
        m_fine = _mask(plan.valids[j - 1], plan.centers[j - 1].shape[1])
        m_coarse = _mask(plan.valids[j], plan.centers[j].shape[1])
        f2 = batch_norm(p, f"fp{j}.norm_f0", lin(p, prec, f"fp{j}.mlp_f0", x), m_coarse, train)
        idx, w = plan.interp[j]
        x = (ops.gather(f2, idx) * w[..., None]).sum(2)
        if j > 1:
            x = x + batch_norm(p, f"fp{j}.norm_s0", lin(p, prec, f"fp{j}.mlp_s0", feats[j - 1]),
                               m_fine, train)
        x = shared_mlp(p, prec, f"fp{j}", torch.relu(x), m_fine, train,
                       len(arch["fp_mlp"][n_sa - j]) - 1)
    x = lin(p, prec, "classifier.0", x)
    x = torch.relu(batch_norm(p, "classifier.1", x, mask0, train))
    x = dropout(x, arch["head_dropout"], gen, train)
    return lin(p, prec, "classifier.4", x)


# -- classification: repsurf_ssg_umb ----------------------------------------

@dataclasses.dataclass
class ClsPlan:
    points: torch.Tensor  # [B, num_point, 3] after the input FPS
    fps: list  # picks of each ball stage
    balls: list  # [B, M_i, S_i] ball members


def cls_plan(arch, raw):
    pts = ops.gather(raw, ops.fps(raw, arch["num_point"]))
    c, fps_idx, balls = pts, [], []
    for npoint, radius, nsample in zip(arch["sa_npoint"], arch["sa_radius"], arch["sa_nsample"]):
        idx = ops.fps(c, npoint)
        nc = ops.gather(c, idx)
        balls.append(ops.ball_query(radius, nsample, c, nc))
        fps_idx.append(idx)
        c = nc
    return ClsPlan(pts, fps_idx, balls)


def cls_forward(p, arch, plan, train, sign, gen=None, prec=Precision()):
    """Log-probabilities [B, classes] of repsurf_ssg_umb."""
    center = plan.points
    x = ops.umbrella(center, arch["group_size"] + 1, "cls", None, sign)
    x = torch.relu(batch_norm(p, "surface_constructor.mlps.1",
                              lin(p, prec, "surface_constructor.mlps.0", x), None, train))
    x = torch.relu(batch_norm(p, "surface_constructor.mlps.4",
                              lin(p, prec, "surface_constructor.mlps.3", x), None, train))
    normal = lin(p, prec, "surface_constructor.mlps.6", x).sum(2)
    feature = None
    for i, (idx, ball) in enumerate(zip(plan.fps, plan.balls), start=1):
        nc = ops.gather(center, idx)
        rel = ops.gather(center, ball) - nc[:, :, None]
        pos = torch.cat([rel, ops.sphere(rel)], -1)
        parts = [normal] if feature is None else [normal, feature]
        feat = ops.gather(torch.cat(parts, -1), ball)
        h = _sa_first(p, prec, f"sa{i}", pos, feat, None, train)
        h = shared_mlp(p, prec, f"sa{i}", h, None, train, len(arch["sa_mlp"][i - 1]) - 1)
        center, normal, feature = nc, ops.gather(normal, idx), h.amax(2)
    last = len(plan.fps) + 1
    g = center[:, None]
    pos = torch.cat([g, ops.sphere(g)], -1)
    feat = torch.cat([normal[:, None], feature[:, None]], -1)
    h = _sa_first(p, prec, f"sa{last}", pos, feat, None, train)
    h = shared_mlp(p, prec, f"sa{last}", h, None, train, len(arch["final_mlp"]) - 1)
    x = h.amax(2).reshape(h.shape[0], -1)
    j = 0
    for _ in arch["head_hidden"]:
        x = torch.relu(batch_norm(p, f"classfier.{j + 1}", lin(p, prec, f"classfier.{j}", x),
                                  None, train))
        x = dropout(x, arch["head_dropout"], gen, train)
        j += 4
    return torch.log_softmax(lin(p, prec, f"classfier.{j}", x), -1)


def random_sign(batch, gen, device):
    """The +-1 inversion a training step draws first from its generator."""
    return torch.randint(0, 2, (batch,), generator=gen, device=device).float() * 2.0 - 1.0
