"""The port's segmentation slice (seg umbrella, repsurf_umb_ssg, loss,
metrics, train and eval steps, weight transfer) against the JAX package on
the CPU.

Coordinates lie on a 2^-10 grid in [-1, 1]: squared distances and the
triangle cross products are then exact in float32 in both frameworks, so
neighbour selections and degenerate fans agree exactly and only rounding
in the continuous arithmetic is left to the tolerances.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from repsurf_torch.data.s3dis import CLASS_WEIGHTS
from repsurf_torch.geometry.polar import xyz2sphere as t_xyz2sphere
from repsurf_torch.geometry.umbrella import FIXED_ROTATION_ROWS
from repsurf_torch.geometry.umbrella import umbrella_features as t_umbrella_features
from repsurf_torch.models import get_model as t_get_model
from repsurf_torch.nn.losses import weighted_cross_entropy as t_wce
from repsurf_torch.nn.metrics import intersection_and_union as t_iou
from repsurf_torch.ops.gather import index_points as t_index_points
from repsurf_torch.ops.kernels.knn import knn_plain
from repsurf_torch.train import train_seg as tts
from repsurf_torch.train.jax_params import state_dict_from_flax
from repsurf_tpu.geometry.umbrella import umbrella_features as j_umbrella_features
from repsurf_tpu.models import get_model as j_get_model
from repsurf_tpu.nn.losses import weighted_cross_entropy as j_wce
from repsurf_tpu.nn.metrics import intersection_and_union as j_iou
from repsurf_tpu.train import train_seg as jts
from repsurf_tpu.train.optim import make_adamw as j_make_adamw
from repsurf_tpu.train.torch_import import import_torch_checkpoint, seg_umbrella_mapping

from .test_train_parity import _assert_update_parity

torch.set_num_threads(1)

B, N = 2, 2048
VALID = np.array([N, 1500], np.int32)
NARROW = dict(
    sa_mlp=((8, 8, 16), (16, 16, 32), (32, 32, 32), (32, 32, 64)),
    fp_mlp=((32, 32), (32, 32), (32, 16), (16, 16, 16)),
)
LOGIT_ATOL = 1e-4  # logits after ~20 f32 layers, two frameworks' orders
# in training mode every layer renormalises by batch statistics summed over
# up to 10^5 rows, in each framework's own order: measured 1.4e-4 at worst
TRAIN_LOGIT_ATOL = 1e-3
UMB_ATOL = 1e-5  # umbrella features: atan2/acos/sqrt/division chains
NEAR_TIE = 1e-6  # rotated-frame azimuth gap under which fans may differ
# AdamW epsilon of the train-step comparison (see that test)
STEP_EPS = 1e-3


def _grid(seed, shape):
    rs = np.random.RandomState(seed)
    return (np.round((rs.rand(*shape) * 2 - 1) * 1024) / 1024).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch(seed=0):
    rs = np.random.RandomState(seed + 100)
    label = rs.randint(0, 13, (B, N)).astype(np.int64)
    label[:, ::17] = 255
    label[1, VALID[1]:] = 255
    return {
        "coord": _grid(seed, (B, N, 3)),
        "feat": rs.rand(B, N, 3).astype(np.float32),
        "label": label,
        "valid": VALID,
    }


def _as_dict(t):
    return {k: _as_dict(v) for k, v in t.items()} if hasattr(t, "items") else t


def _random_variables(model, n, seed):
    """A flax {'params', 'batch_stats'} tree of numpy arrays: Linear kernels
    U(+-1/sqrt(fan_in)), non-trivial BN scale/bias and running statistics.
    Shapes come from jax.eval_shape, so nothing is compiled."""
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(
        functools.partial(model.init, train=False), {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, n, 3)), jnp.zeros((1, n, 3)), jnp.full((1,), n, jnp.int32),
    )

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            bound = 1.0 / np.sqrt(leaf.shape[0])
            return rs.uniform(-bound, bound, leaf.shape).astype(np.float32)
        if name in ("var", "scale"):
            return rs.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (rs.randn(*leaf.shape) * 0.1).astype(np.float32)

    return _as_dict(jax.tree_util.tree_map_with_path(draw, shapes))


@pytest.fixture(scope="module")
def narrow():
    """(JAX model without inversion or dropout, its variables, the port's
    model with those weights)."""
    jm = j_get_model("repsurf.repsurf_umb_ssg", head_dropout=0.0, random_inv=False, **NARROW)
    variables = _random_variables(jm, 64, 1)
    tm = t_get_model("repsurf.repsurf_umb_ssg", head_dropout=0.0, random_inv=False, **NARROW)
    tm.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jm, variables, tm


def _near_ties(xyz, k, valid):
    """[B, N] True where two of a point's k neighbours lie within NEAR_TIE
    in the rotated-frame azimuth: their order, and the fans, may differ.
    Copies of one point (the self column, duplicates) tie exactly in both
    frameworks and keep their index order, so they do not count."""
    idx, _ = knn_plain(k, _t(xyz), _t(xyz), valid=None if valid is None else _t(valid))
    rel = t_index_points(_t(xyz), idx) - _t(xyz)[:, :, None, :]
    phi = t_xyz2sphere(rel @ torch.tensor(FIXED_ROTATION_ROWS))[..., 2]
    phi, order = torch.sort(phi, dim=-1, stable=True)
    rel = torch.gather(rel, 2, order[..., None].expand(-1, -1, -1, 3))
    same = (rel[:, :, 1:] == rel[:, :, :-1]).all(-1)
    return ((torch.diff(phi, dim=-1) < NEAR_TIE) & ~same).any(-1).numpy()


@pytest.mark.parametrize("sign", [None, (-1.0, 1.0)])
def test_seg_umbrella_matches_jax_composition(sign):
    base = _grid(2, (B, 600, 3))
    # every point of the first 100 twice more: zero-area fans besides the
    # self column's, all to be repaired
    xyz = np.concatenate([base, base[:, :100], base[:, :100]], axis=1)
    valid = np.array([800, 650], np.int32)
    s = None if sign is None else np.array(sign, np.float32)
    got = t_umbrella_features(_t(xyz), 9, valid=_t(valid), style="seg",
                              random_inv_sign=None if s is None else _t(s)).numpy()
    want = np.asarray(j_umbrella_features(
        jnp.asarray(xyz), 9, style="seg", impl="xla", valid=jnp.asarray(valid),
        random_inv_sign=None if s is None else jnp.asarray(s),
    ))
    assert got.shape == want.shape == (B, 800, 9, 10)
    # every fan's normal was repaired to a unit vector (channels 3:6)
    live = np.arange(800)[None, :] < valid[:, None]
    norms = np.linalg.norm(got[..., 3:6], axis=-1)[live]
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)
    skip = _near_ties(xyz, 9, valid) | ~live
    assert (_near_ties(xyz, 9, valid) & live).mean() <= 2e-3
    np.testing.assert_allclose(got[~skip], want[~skip], atol=UMB_ATOL, rtol=0)


def test_seg_mapping_round_trips_and_copies(narrow):
    _, variables, _ = narrow
    tm = t_get_model("repsurf.repsurf_umb_ssg", generator=torch.Generator().manual_seed(3),
                     **NARROW)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    back = state_dict_from_flax(import_torch_checkpoint(sd, variables, seg_umbrella_mapping()))
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    copied = state_dict_from_flax(variables)
    kernel = variables["params"]["classifier"]["Linear_1"]["kernel"]
    old = kernel[0, 0].copy()
    kernel[0, 0] = 1000.0
    assert copied["classifier.4.weight"][0, 0] == old
    kernel[0, 0] = old


def test_full_width_parameter_count_matches_jax():
    jm = j_get_model("repsurf.repsurf_umb_ssg")
    want = sum(x.size for x in jax.tree_util.tree_leaves(_random_variables(jm, 64, 0)["params"]))
    tm = tts.build_model(tts.SegConfig(), generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in tm.parameters()) == want
    assert abs(want / 1e6 - 0.976) < 0.01


def test_narrow_eval_logits_match_jax(narrow):
    jm, variables, tm = narrow
    b = _batch(0)
    want = np.asarray(jm.apply(variables, jnp.asarray(b["coord"]), jnp.asarray(b["feat"]),
                               jnp.asarray(b["valid"]), train=False))
    with torch.no_grad():
        got = tm.eval()(_t(b["coord"]), _t(b["feat"]), _t(b["valid"])).numpy()
    assert got.shape == (B, N, 13)
    live = np.arange(N)[None, :] < VALID[:, None]
    np.testing.assert_allclose(got[live], want[live], atol=LOGIT_ATOL, rtol=0)


def test_narrow_train_forward_batch_statistics_match_jax(narrow):
    """Training mode: sectorized FPS on stage 1 and BN batch statistics."""
    jm, variables, _ = narrow
    tm = t_get_model("repsurf.repsurf_umb_ssg", head_dropout=0.0, random_inv=False, **NARROW)
    tm.load_state_dict(state_dict_from_flax(variables), strict=True)
    b = _batch(1)
    want, mut = jm.apply(variables, jnp.asarray(b["coord"]), jnp.asarray(b["feat"]),
                         jnp.asarray(b["valid"]), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = tm.train()(_t(b["coord"]), _t(b["feat"]), _t(b["valid"])).numpy()
    live = np.arange(N)[None, :] < VALID[:, None]
    np.testing.assert_allclose(got[live], np.asarray(want)[live], atol=TRAIN_LOGIT_ATOL, rtol=0)
    stats = state_dict_from_flax({"params": variables["params"],
                                  "batch_stats": _as_dict(mut["batch_stats"])})
    sd = tm.state_dict()
    names = [k for k in stats if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * 30  # every MaskedBatchNorm of the model
    for k in names:
        np.testing.assert_allclose(sd[k].numpy(), stats[k].numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=k)


def _optax_adamw(eps):
    return optax.inject_hyperparams(
        lambda learning_rate: optax.adamw(learning_rate, b1=0.9, b2=0.999, eps=eps,
                                          weight_decay=1e-2)
    )(learning_rate=6e-3)


def test_train_step_matches_jax(narrow):
    """One AdamW step of both trainers from the same weights.

    Both optimizers use eps 1e-3 instead of the recipe's 1e-8: a first AdamW
    step moves every element by about lr * g / (|g| + eps), so at 1e-8 the
    float-noise gradients of the Linear biases that feed train-mode BN
    (exactly zero in exact arithmetic) become lr-sized updates of arbitrary
    sign on both sides.  The recipe's eps is held by the frozen-step test,
    which compares the optimizer state with optax's."""
    jm, variables, _ = narrow
    cfg = tts.SegConfig(head_dropout=0.0)
    jcfg = jts.SegConfig(head_dropout=0.0, voxel_max=N, batch_size=B)
    b = _batch(2)
    w = np.asarray(CLASS_WEIGHTS[5], np.float32)
    pre = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    state = jts.SegTrainState.create(apply_fn=jm.apply, params=variables["params"],
                                     tx=_optax_adamw(STEP_EPS),
                                     batch_stats=variables["batch_stats"])
    jbatch = {k: jnp.asarray(v) for k, v in b.items()}
    state, jloss, (ji, ju, jt) = jts.train_step(state, jbatch, jnp.asarray(w),
                                               jax.random.PRNGKey(0), jcfg)
    jax_post = {"params": _as_dict(state.params), "batch_stats": _as_dict(state.batch_stats)}

    tm = t_get_model("repsurf.repsurf_umb_ssg", head_dropout=0.0, random_inv=False, **NARROW)
    tm.load_state_dict(state_dict_from_flax(pre), strict=True)
    opt = torch.optim.AdamW(tm.parameters(), lr=cfg.learning_rate, betas=(0.9, 0.999),
                            eps=STEP_EPS, weight_decay=cfg.weight_decay)
    tbatch = {k: _t(v) for k, v in b.items()}
    loss, (ti, tu, tt) = tts.train_step(tm, opt, tbatch, _t(w), cfg)
    assert abs(float(loss) - float(jloss)) < 1e-5
    for a, c in ((ti, ji), (tu, ju), (tt, jt)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    fresh = jax.tree_util.tree_map(np.copy, pre)
    port_post = import_torch_checkpoint(sd, fresh, seg_umbrella_mapping())
    _assert_update_parity(pre, jax_post, port_post, rtol=5e-2, median_rtol=2e-2,
                          label="seg adamw ")


def test_frozen_step_keeps_constructor_and_decays_moments(narrow):
    _, variables, _ = narrow
    cfg = tts.SegConfig(head_dropout=0.0)
    tm = t_get_model("repsurf.repsurf_umb_ssg", head_dropout=0.0, random_inv=False, **NARROW)
    tm.load_state_dict(state_dict_from_flax(variables), strict=True)
    opt = tts.make_optimizer(tm, cfg)
    w = torch.ones(13)
    tts.train_step(tm, opt, {k: _t(v) for k, v in _batch(3).items()}, w, cfg)
    sc = dict(tm.surface_constructor.named_parameters())
    grads = {k: p.grad.numpy().copy() for k, p in sc.items()}
    after1 = {k: p.detach().clone() for k, p in sc.items()}
    rest1 = {k: p.detach().clone() for k, p in tm.named_parameters()}
    tts.train_step(tm, opt, {k: _t(v) for k, v in _batch(4).items()}, w, cfg, freeze=True)
    for k, p in sc.items():
        assert torch.equal(p.detach(), after1[k]), k
    moved = [k for k, p in tm.named_parameters() if not torch.equal(p.detach(), rest1[k])]
    assert moved and not any(k.startswith("surface_constructor") for k in moved)
    # optax: a zero gradient decays mu and nu, and the step count advances
    tx = j_make_adamw(cfg.learning_rate, cfg.weight_decay)
    params = {k: np.asarray(v) for k, v in after1.items()}
    st = tx.init(params)
    for g in (grads, {k: np.zeros_like(v) for k, v in grads.items()}):
        _, st = tx.update(g, st, params)
    adam = st.inner_state[0]
    for k, p in sc.items():
        state = opt.state[p]
        np.testing.assert_allclose(state["exp_avg"].numpy(), np.asarray(adam.mu[k]),
                                   rtol=1e-6, atol=1e-12, err_msg=k)
        np.testing.assert_allclose(state["exp_avg_sq"].numpy(), np.asarray(adam.nu[k]),
                                   rtol=1e-6, atol=1e-15, err_msg=k)
        assert int(state["step"]) == int(adam.count) == 2


@pytest.mark.parametrize("all_ignored", [False, True])
def test_loss_and_metrics_match_jax(all_ignored):
    rs = np.random.RandomState(5)
    logits = rs.randn(2, 300, 13).astype(np.float32) * 3
    label = rs.randint(0, 13, (2, 300))
    label[:, ::7] = 255
    if all_ignored:
        label[:] = 255
    w = np.asarray(CLASS_WEIGHTS[2], np.float32)
    for cw in (None, w):
        got = float(t_wce(_t(logits), _t(label), None if cw is None else _t(cw)))
        want = float(j_wce(jnp.asarray(logits), jnp.asarray(label),
                           None if cw is None else jnp.asarray(cw)))
        assert np.isfinite(got)
        assert abs(got - want) < 1e-6 * max(1.0, abs(want))
    pred = logits.argmax(-1)
    for a, c in zip(t_iou(_t(pred), _t(label), 13), j_iou(jnp.asarray(pred), jnp.asarray(label), 13)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))


def test_schedule_and_freeze_condition_match_jax():
    for kw in ({}, {"freeze_epoch": 7, "lr_decay_epochs": (3, 5)}):
        tcfg, jcfg = tts.SegConfig(**kw), jts.SegConfig(**kw)
        for epoch in range(0, 100, 3):
            assert tts.epoch_lr(tcfg, epoch) == jts.epoch_lr(jcfg, epoch)
            assert tts.is_frozen(tcfg, epoch) == jts.is_frozen(jcfg, epoch)
