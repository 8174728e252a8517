"""Measurements behind the tolerances and inputs of tests/test_torch_tri.py
and tests/test_torch_baselines.py, on the CPU (not a test module):

    JAX_PLATFORMS=cpu python -m tests.probe_torch_families

Prints, each port function against the JAX package's on shared weights:
  1. PointTransformer's train-mode logits at 512 and 2,048 points a sample,
     and at 512 each encoder stage's features (stage 5 then holds 3 live
     rows, over which train-mode BN normalises);
  2. the triangular classifier's ``sa1.bn_l0`` output in train mode, from
     bit-equal inputs, on the train step test's input (FPS 256 -> 128 of a
     grid cloud) in [-1, 1] and in [-0.5, 0.5];
  3. PointNet++'s gradient at the first Linear of sa1 and sa2, the port's
     float32 against JAX's float32, with and without a padded sample and
     with and without sectorized FPS, and the port's float32 and JAX's
     float32 against the port evaluated in float64 (its kNN and FPS
     selections taken in float32, the rest in float64);
  4. PointTransformer's first AdamW step (eps 1e-3) and first SGD step
     against JAX's: the worst leaf under the update contract of
     tests/test_train_parity.py (its error over its allowance; above 1
     fails).
Each error is the largest absolute difference, over the reference's
largest magnitude where it says "of".
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repsurf_tpu.models.pointnet2_seg as j_pointnet2_seg
import repsurf_torch.nn.blocks as t_blocks
import repsurf_torch.ops.interpolate as t_interpolate
import repsurf_torch.ops.sampling as t_sampling
from repsurf_torch.data.s3dis import CLASS_WEIGHTS
from repsurf_torch.data.transforms import fps_sample
from repsurf_torch.models import get_model as t_get_model
from repsurf_torch.nn.losses import weighted_cross_entropy as t_wce
from repsurf_torch.ops.kernels.fps import fps_plain
from repsurf_torch.ops.kernels.knn import knn_plain
from repsurf_torch.train import train_seg as tts
from repsurf_torch.train.jax_params import mapping_for, state_dict_from_flax
from repsurf_tpu.models import get_model as j_get_model
from repsurf_tpu.nn.losses import weighted_cross_entropy as j_wce
from repsurf_tpu.train import train_seg as jts
from repsurf_tpu.train.optim import make_sgd as j_make_sgd
from repsurf_tpu.train.torch_import import import_torch_checkpoint

from .test_torch_baselines import NAMES, PT_NARROW, _batch, _live, _NoDropHead, _port_model
from .test_torch_model import NARROW as CLS_NARROW
from .test_torch_model import _random_variables as _cls_variables
from .test_torch_seg import _as_dict, _grid, _optax_adamw, _random_variables, _t

torch.set_num_threads(4)
PT, PN2 = "pointtransformer.pointtransformer", "pointnet2.pointnet2_ssg"
TRI = "repsurf.repsurf_ssg_tri"


def _inputs(b):
    return [b[k] for k in ("coord", "feat", "valid")]


def pt_train_logits():
    for n in (512, 2048):
        jm = j_get_model(PT, **PT_NARROW)
        variables = _random_variables(jm, n, 7)
        tm = t_get_model(PT, **PT_NARROW)
        tm.load_state_dict(state_dict_from_flax(variables))
        b = _batch(n, 1)
        outs = {}
        for i in range(1, 6):
            getattr(tm, f"enc{i}")[-1].register_forward_hook(
                lambda m, a, o, i=i: outs.__setitem__(i, o))
        want, mut = jm.apply(variables, *(jnp.asarray(x) for x in _inputs(b)), train=True,
                             mutable=["batch_stats", "intermediates"],
                             capture_intermediates=True)
        with torch.no_grad():
            got = tm.train()(*(_t(x) for x in _inputs(b))).numpy()
        live = _live(b["valid"], n)
        print(f"1. PointTransformer train-mode logits at {n} points: max |d| "
              f"{np.abs(got[live] - np.asarray(want)[live]).max():.3g}")
        if n == 512:
            inter = mut["intermediates"]
            for i, (_, x, v) in outs.items():
                blocks = len(getattr(tm, f"enc{i}")) - 1
                key = f"enc{i}_block{blocks}" if blocks else f"enc{i}_down"
                jx = np.asarray(inter[key]["__call__"][0][1])
                rows = _live(v.numpy(), x.shape[1])
                print(f"   stage {i}: {int(rows.sum())} live rows, max |d| "
                      f"{np.abs(x.numpy()[rows] - jx[rows]).max():.3g}")


def tri_bn_l0():
    for scale in (1.0, 0.5):
        jm = j_get_model(TRI, random_inv=False, head_dropout=0.0, **CLS_NARROW)
        variables = _cls_variables(jm, 128, 12)
        tm = t_get_model(TRI, head_dropout=0.0, **CLS_NARROW)
        tm.load_state_dict(state_dict_from_flax(variables))
        # the train step test's input: FPS 256 -> 128 of a grid cloud
        pts = fps_sample(_t(_grid(13, (2, 256, 3)) * scale), 128)
        seen = {}
        for name in ("mlp_l0", "bn_l0"):
            tm.sa1.get_submodule(name).register_forward_hook(
                lambda m, a, o, name=name: seen.__setitem__(name, o))
        with torch.no_grad():
            tm.train()(pts)
        _, mut = jm.apply(variables, jnp.asarray(pts.numpy()), train=True,
                          mutable=["batch_stats", "intermediates"], capture_intermediates=True)
        inter = mut["intermediates"]["sa1"]
        d_in = np.abs(seen["mlp_l0"].numpy() - np.asarray(inter["Linear_0"]["__call__"][0])).max()
        d_bn = np.abs(seen["bn_l0"].numpy()
                      - np.asarray(inter["MaskedBatchNorm_0"]["__call__"][0])).max()
        print(f"2. repsurf_ssg_tri train mode, the step test's input in [-{scale}, {scale}]: "
              f"sa1.mlp_l0 max |d| {d_in:.3g}, sa1.bn_l0 max |d| {d_bn:.3g}")


def _port_grads(name, b, variables, num_sector, dtype=torch.float32):
    tm = _port_model(name, num_sector=num_sector)
    tm.load_state_dict(state_dict_from_flax(variables))
    tm = tm.to(dtype).train()
    x = [_t(v).to(dtype) if v.dtype == np.float32 else _t(v) for v in _inputs(b)]
    w = torch.tensor(CLASS_WEIGHTS[5], dtype=dtype)
    t_wce(tm(*x), _t(b["label"]), w, 255).backward()
    return {k: p.grad.double().numpy() for k, p in tm.named_parameters()}


def _jax_grads(name, b, variables, num_sector):
    jm = j_get_model(name, num_sector=num_sector, **NAMES[name][1])
    w = jnp.asarray(CLASS_WEIGHTS[5], jnp.float32)

    def loss(params):
        logits, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                             *(jnp.asarray(x) for x in _inputs(b)), train=True,
                             mutable=["batch_stats"])
        return j_wce(logits, jnp.asarray(b["label"]), w, 255)

    g = jax.tree_util.tree_map(np.asarray, jax.grad(loss)(variables["params"]))
    sd = state_dict_from_flax({"params": _as_dict(g), "batch_stats": variables["batch_stats"]})
    return {k: v.double().numpy() for k, v in sd.items()}


def _knn64(k, xyz, new_xyz, valid=None):
    """float32 selections, float64 distances."""
    idx, dist = knn_plain(k, xyz.float(), new_xyz.float(), valid=valid)
    rel = xyz[torch.arange(xyz.shape[0])[:, None, None], idx.long()] - new_xyz[:, :, None]
    return idx, torch.where(dist > 1e4, dist.double(), rel.square().sum(-1).sqrt())


def pn2_gradients():
    name = PN2
    n = NAMES[name][0]
    j_pointnet2_seg._SegHead = _NoDropHead
    for num_sector in (4, 1):
        for padded in (True, False):
            jm = j_get_model(name, num_sector=num_sector, **NAMES[name][1])
            variables = _random_variables(jm, n, 7)
            b = _batch(n, 2, padded=padded)
            port, ref = _port_grads(name, b, variables, num_sector), _jax_grads(
                name, b, variables, num_sector)
            saved = (t_blocks.knn, t_interpolate.knn, t_sampling.fps)
            t_blocks.knn = t_interpolate.knn = _knn64
            t_sampling.fps = lambda xyz, m, valid=None: fps_plain(xyz.float(), m, valid=valid)
            try:
                f64 = _port_grads(name, b, variables, num_sector, torch.float64)
            finally:
                t_blocks.knn, t_interpolate.knn, t_sampling.fps = saved
            for stage in ("sa1", "sa2"):
                k = f"{stage}.mlp_convs.0.weight"
                scale = np.abs(f64[k]).max()
                print(f"3. PointNet++ grad {k}, sectors {num_sector}, padded {padded}: port "
                      f"vs JAX {np.abs(port[k] - ref[k]).max() / scale:.3g}, port vs float64 "
                      f"{np.abs(port[k] - f64[k]).max() / scale:.3g}, JAX vs float64 "
                      f"{np.abs(ref[k] - f64[k]).max() / scale:.3g} (of the float64's largest)")


def pt_step_updates():
    name = PT
    n = NAMES[name][0]
    jm = j_get_model(name, **NAMES[name][1])
    variables = _random_variables(jm, n, 7)
    pre = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    b = _batch(n, 2)
    w = np.asarray(CLASS_WEIGHTS[5], np.float32)
    for label in ("AdamW eps 1e-3", "SGD"):
        adamw = label.startswith("AdamW")
        cfg = tts.SegConfig(model=name, optimizer="AdamW" if adamw else "SGD",
                            learning_rate=6e-3 if adamw else 0.05)
        jcfg = jts.SegConfig(model=name, voxel_max=n, batch_size=2)
        tx = (_optax_adamw(1e-3) if adamw
              else j_make_sgd(cfg.learning_rate, cfg.momentum, cfg.weight_decay))
        state = jts.SegTrainState.create(apply_fn=jm.apply, params=variables["params"], tx=tx,
                                         batch_stats=variables["batch_stats"])
        state, _, _ = jts.train_step(state, {k: jnp.asarray(v) for k, v in b.items()},
                                     jnp.asarray(w), jax.random.PRNGKey(0), jcfg)
        tm = _port_model(name)
        tm.load_state_dict(state_dict_from_flax(pre))
        opt = (torch.optim.AdamW(tm.parameters(), lr=cfg.learning_rate, eps=1e-3,
                                 weight_decay=cfg.weight_decay)
               if adamw else tts.make_optimizer(tm, cfg))
        tts.train_step(tm, opt, {k: _t(v) for k, v in b.items()}, _t(w), cfg)
        sd = {k: v.numpy() for k, v in tm.state_dict().items()}
        post = import_torch_checkpoint(sd, jax.tree_util.tree_map(np.copy, pre),
                                       mapping_for(pre["params"]))
        # the update contract's measure (tests/test_train_parity.py), over
        # params and BN statistics: err / max(5e-2 of the leaf's largest
        # update, 1e-3 of the largest anywhere); above 1 fails
        ref = {"params": _as_dict(state.params), "batch_stats": _as_dict(state.batch_stats)}
        paths = [jax.tree_util.tree_leaves_with_path(t) for t in (ref, pre, post)]
        leaves = [(jax.tree_util.keystr(k), np.asarray(v) - np.asarray(p),
                   np.asarray(q) - np.asarray(p)) for (k, v), (_, p), (_, q) in zip(*paths)]
        scales = [max(np.abs(a).max(), np.abs(c).max()) for _, a, c in leaves]
        floor = 1e-3 * max(scales)
        worst, where = max((np.abs(c - a).max() / max(5e-2 * sc, floor), name)
                           for (name, a, c), sc in zip(leaves, scales))
        print(f"4. PointTransformer {label} first step: worst leaf {where}, "
              f"{worst:.3g} of its allowance under the update contract")


if __name__ == "__main__":
    pt_train_logits()
    tri_bn_l0()
    pn2_gradients()
    pt_step_updates()
