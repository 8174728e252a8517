"""PointNet++'s backward on the seg recipe's own input, a padded batch with
sectorized FPS, held to the port evaluated in float64 on the CPU.

tests/test_torch_baselines.py holds PointNet++'s train step to JAX's on an
unpadded batch: on this padded one the JAX package's float32 gradient at
sa2 lies 17.9 % (of the largest element) from the float64 evaluation.  The
second test shows why: one max-pool near-tie.  At sa4 (the narrow model,
the baselines tests' seed), query 2 of sample 0 holds two neighbours whose
channel-15 activations lie 1.64e-6 apart (relative); the two frameworks'
float32 rounding puts different ones first, so the max-pool's gradient
goes to a different neighbour, and from there into every earlier stage.
Every other (query, channel) of the stage routes its gradient alike.  The
padded sample only moves sa4's batch statistics onto this tie.

The float64 evaluation takes its kNN and FPS selections in float32 (its
distances in float64), so both runs select the same points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repsurf_tpu.models.pointnet2_seg as j_pointnet2_seg
from repsurf_torch.data.s3dis import CLASS_WEIGHTS
from repsurf_torch.nn import blocks as t_blocks
from repsurf_torch.nn.losses import weighted_cross_entropy as t_wce
from repsurf_torch.ops import interpolate as t_interpolate
from repsurf_torch.ops import sampling as t_sampling
from repsurf_torch.ops.kernels.fps import fps_plain
from repsurf_torch.ops.kernels.knn import knn_plain
from repsurf_torch.train.jax_params import state_dict_from_flax
from repsurf_tpu.models import get_model as j_get_model
from repsurf_tpu.nn.losses import weighted_cross_entropy as j_wce

from .test_torch_baselines import NAMES, _batch, _NoDropHead, _port_model
from .test_torch_seg import _random_variables

torch.set_num_threads(1)

PN2 = "pointnet2.pointnet2_ssg"
# worst weight or BN-parameter gradient, port float32 against float64, of
# the float64's largest element: measured 0.026 (sa4.mlp_bns.0.bias) on
# this input; sa2's first Linear 0.012
GRAD_RTOL = 5e-2
NEAR_TIE = 1e-5  # relative top-two gap of a max-pool under which rounding may swap them


def _knn64(k, xyz, new_xyz, valid=None):
    """float32 selections, float64 distances."""
    idx, dist = knn_plain(k, xyz.float(), new_xyz.float(), valid=valid)
    rel = xyz[torch.arange(xyz.shape[0])[:, None, None], idx.long()] - new_xyz[:, :, None]
    return idx, torch.where(dist > 1e4, dist.double(), rel.square().sum(-1).sqrt())


@pytest.fixture(scope="module")
def case():
    n, narrow = NAMES[PN2]
    jm = j_get_model(PN2, num_sector=4, **narrow)
    return n, _random_variables(jm, n, 7), _batch(n, 2, padded=True)


def _port_run(variables, b, dtype, keep=()):
    """One training forward and backward of the narrow port model in
    ``dtype`` -> (parameter gradients, {name: (value, its gradient)} of the
    modules in ``keep``)."""
    model = _port_model(PN2, num_sector=4)
    model.load_state_dict(state_dict_from_flax(variables))
    model = model.to(dtype).train()
    seen = {}

    def hook(name):
        def f(mod, inp, out):
            out.retain_grad()
            seen[name] = out
        return f

    for name in keep:
        model.get_submodule(name).register_forward_hook(hook(name))
    x = [torch.from_numpy(b[k]).to(dtype) if b[k].dtype == np.float32 else torch.from_numpy(b[k])
         for k in ("coord", "feat", "valid")]
    loss = t_wce(model(*x), torch.from_numpy(b["label"]), torch.tensor(CLASS_WEIGHTS[5],
                                                                       dtype=dtype), 255)
    loss.backward()
    grads = {k: p.grad.double().numpy() for k, p in model.named_parameters()}
    return grads, {k: (v.detach().double().numpy(), v.grad.double().numpy())
                   for k, v in seen.items()}


def _float64_run(variables, b, keep=()):
    saved = (t_blocks.knn, t_interpolate.knn, t_sampling.fps)
    t_blocks.knn = t_interpolate.knn = _knn64
    t_sampling.fps = lambda xyz, m, valid=None: fps_plain(xyz.float(), m, valid=valid)
    try:
        return _port_run(variables, b, torch.float64, keep)
    finally:
        t_blocks.knn, t_interpolate.knn, t_sampling.fps = saved


def test_padded_sectorized_gradient_matches_float64(case):
    """Every weight and BN parameter's gradient within GRAD_RTOL of the
    float64 one's largest element.  A bias whose output reaches a
    train-mode BN only through per-channel shifts (the Linear biases before
    each BN, sa4's last BN bias before fp4's Linear and BN) has a zero
    gradient in exact arithmetic: float noise is all there is to compare
    there, and those are left out (float64 largest element under 1e-6 of
    the largest gradient)."""
    _, variables, b = case
    got, _ = _port_run(variables, b, torch.float32)
    want, _ = _float64_run(variables, b)
    scale = max(np.abs(w).max() for w in want.values())
    skipped = []
    for k, w in want.items():
        if np.abs(w).max() < 1e-6 * scale:
            skipped.append(k)
            continue
        err = np.abs(got[k] - w).max() / np.abs(w).max()
        assert err < GRAD_RTOL, (k, err)
    assert skipped and all(k.endswith("bias") for k in skipped)
    assert len(skipped) < len(want) // 3


def test_jax_gradient_moves_only_at_a_max_pool_near_tie(case, monkeypatch):
    """At sa4's last BN output, the neighbour that takes each (query,
    channel)'s max-pool gradient in JAX's float32 run is the float64
    run's everywhere but at the near-ties, and there is one."""
    import flax.linen as nn

    monkeypatch.setattr(j_pointnet2_seg, "_SegHead", _NoDropHead)
    n, variables, b = case
    tap = "sa4.mlp_bns.2"
    _, seen = _float64_run(variables, b, keep=(tap,))
    value, want = seen[tap]
    jm = j_get_model(PN2, num_sector=4, **NAMES[PN2][1])
    w = jnp.asarray(CLASS_WEIGHTS[5], jnp.float32)

    def loss(delta):
        def add_at_tap(next_fun, args, kwargs, ctx):
            out = next_fun(*args, **kwargs)
            m = ctx.module
            if (ctx.method_name == "__call__" and m.name == "MaskedBatchNorm_2"
                    and m.parent.parent.name == "sa4"):
                out = out + delta
            return out

        with nn.intercept_methods(add_at_tap):
            logits, _ = jm.apply(variables, *(jnp.asarray(b[k]) for k in ("coord", "feat",
                                                                           "valid")),
                                 train=True, mutable=["batch_stats"])
        return j_wce(logits, jnp.asarray(b["label"]), w, 255)

    got = np.asarray(jax.grad(loss)(jnp.zeros(value.shape, jnp.float32)))
    live = np.arange(value.shape[1]) < b["valid"][:, None] // 4 ** 4  # sa4's queries
    relu = np.maximum(value, 0.0)[live]  # [Q, S, C]
    top = np.sort(relu, axis=1)
    flowing = top[:, -1] > 0  # a channel that the ReLU zeroes everywhere passes no gradient
    gap = np.where(flowing, (top[:, -1] - top[:, -2]) / np.where(flowing, top[:, -1], 1), 1.0)
    routed = lambda g: np.abs(g[live]).argmax(axis=1)  # noqa: E731
    moved = (routed(got) != routed(want)) & flowing
    # exact ties (gap 0) are copies of one neighbour: the missing kNN slots
    # of the padded sample's queries repeat point 0, and both frameworks
    # split the gradient among the copies alike
    near = (gap > 0) & (gap < NEAR_TIE)
    assert moved.any() and near[moved].all()
    assert near.sum() == moved.sum() == 1
