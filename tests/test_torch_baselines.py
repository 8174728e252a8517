"""The port's segmentation baselines (the PointNet++ blocks and pointnet2_ssg,
the PointTransformer blocks and pointtransformer), the seg trainer's model
interface and the recipes against the JAX package on the CPU.

Coordinates lie on a 2^-10 grid, as in tests/test_torch_seg.py, so kNN and
FPS selections agree exactly and only float rounding is left to the
tolerances.  PointTransformer runs at 2,048 points a sample, so its stage
5 holds 8 points (5 live in the padded sample): every kNN of 16 there has
missing slots, (index 0, sqrt(1e10)), which both packages feed the softmax
unmasked; the attention layer also runs alone on a 12-point cloud.  At
512 points stage 5 would hold 2 + 1 live rows, and train-mode BN over 3
rows amplifies float rounding about tenfold (stage 4 within 1.1e-5, stage
5 1.3e-4, the logits 3.8e-4, against 6.6e-5 at 2,048 points;
tests/probe_torch_families.py).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import repsurf_tpu.models.pointnet2_seg as j_pointnet2_seg
from repsurf_torch.config import get_preset as t_get_preset
from repsurf_torch.data.s3dis import CLASS_WEIGHTS
from repsurf_torch.models import _REGISTRY
from repsurf_torch.models import get_model as t_get_model
from repsurf_torch.models.pointnet2_seg import PointNet2Segmentor
from repsurf_torch.models.pointtransformer_seg import PointTransformerSegmentor
from repsurf_torch.nn import blocks as t_blocks
from repsurf_torch.nn import pointtransformer as t_pt
from repsurf_torch.nn.layers import Dropout, MaskedBatchNorm
from repsurf_torch.train import jax_params
from repsurf_torch.train import train_seg as tts
from repsurf_torch.train.jax_params import mapping_for, state_dict_from_flax
from repsurf_tpu.config import get_preset as j_get_preset
from repsurf_tpu.models import get_model as j_get_model
from repsurf_tpu.models.repsurf_seg import _SegHead
from repsurf_tpu.nn import blocks as j_blocks
from repsurf_tpu.nn import pointtransformer as j_pt
from repsurf_tpu.train import train_seg as jts
from repsurf_tpu.train.optim import make_sgd as j_make_sgd
from repsurf_tpu.train.torch_import import import_torch_checkpoint

from .test_torch_seg import (
    LOGIT_ATOL,
    TRAIN_LOGIT_ATOL,
    _as_dict,
    _grid,
    _random_variables,
    _t,
)
from .test_train_parity import _assert_update_parity

torch.set_num_threads(1)

B = 2
MODULE_ATOL = 1e-4  # one block's outputs on shared weights
PN2_N, PT_N = 2048, 2048
PN2_NARROW = dict(
    sa_mlp=((8, 8, 16), (16, 16, 32), (32, 32, 32), (32, 32, 64)),
    fp_mlp=((32, 32), (32, 32), (32, 16), (16, 16, 16)),
)
PT_NARROW = dict(planes=(16, 16, 32, 32, 64), enc_blocks=(1, 2, 2, 2, 2))
NAMES = {"pointnet2.pointnet2_ssg": (PN2_N, PN2_NARROW),
         "pointtransformer.pointtransformer": (PT_N, PT_NARROW)}


class _NoDropHead(_SegHead):
    """The JAX seg head without dropout, so a train-mode forward is
    deterministic (pointnet2_ssg fixes the head's dropout at 0.5)."""

    dropout: float = 0.0


@pytest.fixture(autouse=True)
def _jax_head_without_dropout(monkeypatch):
    monkeypatch.setattr(j_pointnet2_seg, "_SegHead", _NoDropHead)


def _valid(n):
    return np.array([n, n - n // 4 - 3], np.int32)


def _batch(n, seed, padded=True):
    rs = np.random.RandomState(seed + 100)
    label = rs.randint(0, 13, (B, n)).astype(np.int64)
    label[:, ::17] = 255
    valid = _valid(n) if padded else np.array([n, n], np.int32)
    label[1, valid[1]:] = 255
    return {"coord": _grid(seed, (B, n, 3)), "feat": rs.rand(B, n, 3).astype(np.float32),
            "label": label, "valid": valid}


def _port_model(name, **kw):
    """The narrow port model, its head's dropout (PointNet++) off."""
    model = t_get_model(name, **NAMES[name][1], **kw)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX model, its numpy variables) of a narrow baseline."""
    n, narrow = NAMES[name]
    jm = j_get_model(name, **narrow)
    return jm, _random_variables(jm, n, 7)


def _carried(name):
    jm, variables = _pair(name)
    tm = _port_model(name)
    tm.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jm, variables, tm


def _live(valid, n):
    return np.arange(n)[None, :] < np.asarray(valid)[:, None]


# ---- the blocks ---------------------------------------------------------


def _module_case(kind):
    """(JAX module, port module, its mapping entries under scope 'm', JAX
    call args and kwargs, port call args and kwargs, rows-valid of the
    output or None) at 512 points, one sample padded."""
    n = 512
    rs = np.random.RandomState(11)
    xyz = _grid(12, (B, n, 3))
    feat = rs.randn(B, n, 16).astype(np.float32) * 0.5
    valid = _valid(n)
    coarse = _grid(13, (B, n // 4, 3))
    cfeat = rs.randn(B, n // 4, 24).astype(np.float32) * 0.5
    cvalid = valid // 4
    j, t = (lambda *a: [jnp.asarray(x) for x in a]), (lambda *a: [_t(x) for x in a])
    if kind == "pn_sa":
        return (j_blocks.PointNetSetAbstraction(stride=4, nsample=32, mlp=(16, 16, 32),
                                                num_sector=4),
                t_blocks.PointNetSetAbstraction(19, (16, 16, 32), stride=4, nsample=32,
                                                num_sector=4),
                jax_params._shared_mlp("m", 3), j(xyz, feat), {"valid": jnp.asarray(valid)},
                t(xyz, feat), {"valid": _t(valid)}, cvalid)
    if kind == "pn_fp":
        return (j_blocks.PointNetFeaturePropagation(mlp=(32, 16)),
                t_blocks.PointNetFeaturePropagation(16 + 24, (32, 16)),
                jax_params._shared_mlp("m", 2), j(xyz, feat, coarse, cfeat),
                {"valid1": jnp.asarray(valid), "valid2": jnp.asarray(cvalid)},
                t(xyz, feat, coarse, cfeat), {"valid1": _t(valid), "valid2": _t(cvalid)}, valid)
    if kind.startswith("pt_layer"):
        if kind == "pt_layer_12":  # every query short of 16 neighbours
            xyz, feat, valid = xyz[:, :12], feat[:, :12], np.array([12, 9], np.int32)
        return (j_pt.PointTransformerLayer(out_planes=16, share_planes=4),
                t_pt.PointTransformerLayer(16, 16, share_planes=4),
                jax_params._pt_layer(["m"], "m"), j(xyz, feat), {"valid": jnp.asarray(valid)},
                t(xyz, feat), {"valid": _t(valid)}, valid)
    if kind.startswith("pt_down"):
        stride = int(kind[-1])
        return (j_pt.TransitionDown(out_planes=32, stride=stride, num_sector=4),
                t_pt.TransitionDown(16, 32, stride=stride, num_sector=4),
                jax_params._pt_down("m", "m"), j(xyz, feat), {"valid": jnp.asarray(valid)},
                t(xyz, feat), {"valid": _t(valid)}, valid // stride)
    if kind == "pt_up_head":
        return (j_pt.TransitionUp(out_planes=None), t_pt.TransitionUp(16, None),
                jax_params._pt_up("m", "m", head=True), j(xyz, feat),
                {"valid1": jnp.asarray(valid)}, t(xyz, feat), {"valid1": _t(valid)}, valid)
    if kind == "pt_up":
        return (j_pt.TransitionUp(out_planes=16), t_pt.TransitionUp(24, 16),
                jax_params._pt_up("m", "m", head=False), j(xyz, feat),
                {"valid1": jnp.asarray(valid), "pos2": jnp.asarray(coarse),
                 "feat2": jnp.asarray(cfeat), "valid2": jnp.asarray(cvalid)},
                t(xyz, feat), {"valid1": _t(valid), "pos2": _t(coarse), "feat2": _t(cfeat),
                               "valid2": _t(cvalid)}, valid)
    assert kind == "pt_block"
    return (j_pt.PointTransformerBlock(planes=16, share_planes=4),
            t_pt.PointTransformerBlock(16, share_planes=4), jax_params._pt_block("m", "m"),
            j(xyz, feat), {"valid": jnp.asarray(valid)}, t(xyz, feat), {"valid": _t(valid)},
            valid)


def _draw(rs):
    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            bound = 1.0 / np.sqrt(leaf.shape[0])
            return rs.uniform(-bound, bound, leaf.shape).astype(np.float32)
        if name in ("var", "scale"):
            return rs.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (rs.randn(*leaf.shape) * 0.1).astype(np.float32)

    return draw


def _features(out):
    """The feature tensor of a block's output: (pos, feat, valid) or
    (new_xyz, feat, valid) tuples carry it second."""
    return out[1] if isinstance(out, tuple) else out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", ["pn_sa", "pn_fp", "pt_layer", "pt_layer_12", "pt_down1",
                                  "pt_down4",
                                  "pt_up_head", "pt_up", "pt_block"])
def test_block_matches_jax_on_shared_weights(kind, train):
    """Each block in eval mode (running statistics) and in train mode
    (batch statistics; sectorized FPS in the strided blocks), on the same
    weights, the live rows of its features."""
    jmod, tmod, entries, jargs, jkw, targs, tkw, out_valid = _module_case(kind)
    shapes = jax.eval_shape(lambda: jmod.init({"params": jax.random.PRNGKey(0)}, *jargs,
                                              train=False, **jkw))
    variables = _as_dict(jax.tree_util.tree_map_with_path(_draw(np.random.RandomState(5)),
                                                          shapes))
    holder = nn.Module()
    holder.m = tmod
    wrapped = {k: {"m": v} for k, v in variables.items()}
    holder.load_state_dict(state_dict_from_flax(wrapped, mapping=entries), strict=True)
    if train:
        want, _ = jmod.apply(variables, *jargs, train=True, mutable=["batch_stats"], **jkw)
    else:
        want = jmod.apply(variables, *jargs, train=False, **jkw)
    with torch.no_grad():
        got = tmod.train(train)(*targs, **tkw)
    want, got = np.asarray(_features(want)), _features(got).numpy()
    assert got.shape == want.shape
    live = _live(out_valid, got.shape[1])
    assert np.isfinite(got[live]).all()
    atol = TRAIN_LOGIT_ATOL if train else MODULE_ATOL
    np.testing.assert_allclose(got[live], want[live], atol=atol, rtol=0)


# ---- the models ---------------------------------------------------------


@pytest.mark.parametrize("name,want_m", [("pointnet2.pointnet2_ssg", 0.968),
                                         ("pointtransformer.pointtransformer", 7.767)])
def test_full_width_parameter_count_matches_jax(name, want_m):
    jm = j_get_model(name)
    want = sum(x.size for x in jax.tree_util.tree_leaves(_random_variables(jm, 64, 0)["params"]))
    tm = tts.build_model(tts.SegConfig(model=name), generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in tm.parameters()) == want
    assert abs(want / 1e6 - want_m) < 0.001


@pytest.mark.parametrize("name", list(NAMES))
def test_mapping_round_trips_and_copies(name):
    _, variables = _pair(name)
    tm = _port_model(name, generator=torch.Generator().manual_seed(3))
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    entries = mapping_for(variables["params"])
    assert len({e[2] for e in entries}) == len(entries)
    back = state_dict_from_flax(import_torch_checkpoint(sd, variables, entries))
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    copied = state_dict_from_flax(variables)
    kind, path, tname = entries[0]
    leaf = variables["params"]
    for p in path:
        leaf = leaf[p]
    old = leaf["kernel"][0, 0].copy()
    leaf["kernel"][0, 0] = 1000.0
    assert copied[f"{tname}.weight"][0, 0] == old
    leaf["kernel"][0, 0] = old


@pytest.mark.parametrize("name", list(NAMES))
def test_eval_logits_match_jax(name):
    jm, variables, tm = _carried(name)
    n = NAMES[name][0]
    b = _batch(n, 0)
    want = np.asarray(jm.apply(variables, jnp.asarray(b["coord"]), jnp.asarray(b["feat"]),
                               jnp.asarray(b["valid"]), train=False))
    with torch.no_grad():
        got = tm.eval()(_t(b["coord"]), _t(b["feat"]), _t(b["valid"])).numpy()
    assert got.shape == (B, n, 13)
    live = _live(b["valid"], n)
    np.testing.assert_allclose(got[live], want[live], atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("name", list(NAMES))
def test_train_forward_and_batch_statistics_match_jax(name):
    """Training mode: sectorized FPS (PointNet++ stage 1, PointTransformer
    stage 2) and BN batch statistics, then every running statistic."""
    jm, variables, tm = _carried(name)
    n = NAMES[name][0]
    b = _batch(n, 1)
    want, mut = jm.apply(variables, jnp.asarray(b["coord"]), jnp.asarray(b["feat"]),
                         jnp.asarray(b["valid"]), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = tm.train()(_t(b["coord"]), _t(b["feat"]), _t(b["valid"])).numpy()
    live = _live(b["valid"], n)
    np.testing.assert_allclose(got[live], np.asarray(want)[live], atol=TRAIN_LOGIT_ATOL, rtol=0)
    stats = state_dict_from_flax({"params": variables["params"],
                                  "batch_stats": _as_dict(mut["batch_stats"])})
    sd = tm.state_dict()
    names = [k for k in stats if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * sum(isinstance(m, MaskedBatchNorm) for m in tm.modules())
    for k in names:
        np.testing.assert_allclose(sd[k].numpy(), stats[k].numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(NAMES))
def test_train_step_matches_jax(name):
    """One step of the seg recipe's SGD branch (momentum, coupled L2) of
    both trainers from the same weights, under the update contract of
    tests/test_train_parity.py; the loss within 1e-5, the IoU counters
    equal but for the step's near-tie predictions.

    SGD, not AdamW: AdamW's first step divides each gradient by |g| + eps,
    which scales float noise in the elements with |g| near eps up to the
    update's full size (PointTransformer's value kernel at eps 1e-3: 1.29
    times the contract's allowance, 0.024 times under SGD).  PointNet++
    takes a batch without padding: with a padded sample and sectorized FPS
    the JAX package's float32 gradient at sa2 lies 17.9 % (of the largest
    element) from the port evaluated in float64, the port's float32 1.2 %;
    without the padding, or without sectors, JAX's lies within 0.8 %
    (tests/probe_torch_families.py).  The padded forward is held by the two
    tests above."""
    jm, variables = _pair(name)
    n = NAMES[name][0]
    cfg = tts.SegConfig(model=name, optimizer="SGD", learning_rate=0.05)
    jcfg = jts.SegConfig(model=name, optimizer="SGD", learning_rate=0.05, voxel_max=n,
                         batch_size=B)
    b = _batch(n, 2, padded=not name.startswith("pointnet2"))
    w = np.asarray(CLASS_WEIGHTS[5], np.float32)
    pre = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    state = jts.SegTrainState.create(apply_fn=jm.apply, params=variables["params"],
                                     tx=j_make_sgd(jcfg.learning_rate, jcfg.momentum,
                                                   jcfg.weight_decay),
                                     batch_stats=variables["batch_stats"])
    state, jloss, (ji, ju, jt) = jts.train_step(state, {k: jnp.asarray(v) for k, v in b.items()},
                                               jnp.asarray(w), jax.random.PRNGKey(0), jcfg)
    jax_post = {"params": _as_dict(state.params), "batch_stats": _as_dict(state.batch_stats)}

    tm = _port_model(name)
    tm.load_state_dict(state_dict_from_flax(pre), strict=True)
    opt = tts.make_optimizer(tm, cfg)
    loss, (ti, tu, tt) = tts.train_step(tm, opt, {k: _t(v) for k, v in b.items()}, _t(w), cfg)
    assert abs(float(loss) - float(jloss)) < 1e-5
    # the step's predictions: a point whose top two logits lie within
    # LOGIT_ATOL may take either class, and moves each counter by <= 2
    logits, _ = jm.apply(pre, *(jnp.asarray(b[k]) for k in ("coord", "feat", "valid")),
                         train=True, mutable=["batch_stats"])
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    counted = _live(b["valid"], n) & (b["label"] != 255)
    ties = int((counted & (top2[..., 1] - top2[..., 0] < LOGIT_ATOL)).sum())
    assert ties <= 5e-3 * counted.sum()  # measured 0.12 % and 0.15 %
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for a, c in ((ti, ji), (tu, ju)):
        assert np.abs(a.numpy() - np.asarray(c)).sum() <= 2 * ties
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    port_post = import_torch_checkpoint(sd, jax.tree_util.tree_map(np.copy, pre),
                                        mapping_for(pre["params"]))
    _assert_update_parity(pre, jax_post, port_post, rtol=5e-2, median_rtol=2e-2,
                          label=f"{name} sgd ")


# ---- the trainer's model interface and the recipes ----------------------


@pytest.mark.parametrize("name", ["repsurf.repsurf_umb_ssg", "pointnet2.pointnet2_ssg",
                                  "pointtransformer.pointtransformer"])
def test_build_model_branches_as_jax(name):
    """Only the repsurf name takes group_size, return_polar and
    head_dropout; every name builds at JAX's parameter count."""
    cfg = tts.SegConfig(model=name, head_dropout=0.3, group_size=4, num_sector=2)
    tm = tts.build_model(cfg, generator=torch.Generator().manual_seed(0))
    jm = jts.build_model(jts.SegConfig(model=name, head_dropout=0.3, group_size=4, num_sector=2))
    want = sum(x.size for x in jax.tree_util.tree_leaves(_random_variables(jm, 64, 0)["params"]))
    assert sum(p.numel() for p in tm.parameters()) == want
    drops = [m.p for m in tm.modules() if isinstance(m, Dropout)]
    if name.startswith("repsurf"):
        assert drops == [0.3] and tm.surface_constructor.k == 5
    elif name.startswith("pointnet2"):
        assert drops == [0.5] and tm.sa1.num_sector == 2
    else:
        assert drops == [] and tm.enc2[0].num_sector == 2
    assert not hasattr(tm, "random_inv") or name.startswith("repsurf")


@pytest.mark.parametrize("name", list(NAMES))
def test_train_step_serves_the_baselines_and_freeze_is_a_no_op(name):
    """train_step on a baseline: no inversion drawn, the generator only
    where there is dropout; freeze=True leaves every parameter where
    freeze=False does (no surface constructor to freeze)."""
    cfg = tts.SegConfig(model=name)
    n = NAMES[name][0]
    batch = {k: _t(v) for k, v in _batch(n, 3).items()}
    results = []
    for freeze in (False, True):
        tm = t_get_model(name, **NAMES[name][1], generator=torch.Generator().manual_seed(4))
        opt = tts.make_optimizer(tm, cfg)
        gen = torch.Generator().manual_seed(9)
        loss, _ = tts.train_step(tm, opt, batch, torch.ones(13), cfg, generator=gen, freeze=freeze)
        assert np.isfinite(float(loss))
        results.append((float(loss), tm.state_dict(), gen.get_state()))
    (l0, sd0, g0), (l1, sd1, g1) = results
    assert l0 == l1 and all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    # only PointNet++'s head dropout draws from the generator
    fresh = torch.Generator().manual_seed(9).get_state()
    assert torch.equal(g0, fresh) == name.startswith("pointtransformer")


def test_presets_match_jax_field_for_field():
    from repsurf_tpu.config import PRESETS as J_PRESETS

    from repsurf_torch.config import PRESETS

    assert sorted(PRESETS) == sorted(J_PRESETS)
    for name in PRESETS:
        got = dataclasses.asdict(t_get_preset(name))
        want = dataclasses.asdict(j_get_preset(name))
        # pred_ignore0 (ScanNet) is not ported; every other field is.
        # the seg config's label_smoothing is the port's alone (PointNeXt's
        # recipe), 0 in every preset: the JAX package's loss
        assert got.pop("label_smoothing", 0.0) == 0.0
        assert set(want) - set(got) <= {"pred_ignore0"} and set(got) <= set(want)
        assert {k: want[k] for k in got} == got, name
    assert t_get_preset("s3dis/pointnet2", epoch=3).epoch == 3
    assert t_get_preset("s3dis/pointtransformer").freeze_epoch == int(1e6)


@pytest.mark.parametrize("name", list(NAMES))
def test_cli_trains_and_serves_the_baseline(name, tmp_path, monkeypatch):
    """``cli/train_seg.main`` with ``--model`` a baseline (narrow) on two
    synthetic rooms padded to 2,048 points for two epochs with
    validation, then ``cli/test_s3dis`` serving a room from its best
    checkpoint."""
    from repsurf_torch.cli import test_s3dis
    from repsurf_torch.cli import train_seg as cli

    cls = PointNet2Segmentor if name.startswith("pointnet2") else PointTransformerSegmentor
    monkeypatch.setitem(_REGISTRY, name, lambda num_class=13, **kw: cls(num_class, **kw,
                                                                         **NAMES[name][1]))
    root = str(tmp_path)
    run = cli.main(["--synthetic", "--synthetic_rooms", "2", "--synthetic_raw", "4000",
                    "--voxel_max", "2048", "--batch_size", "2", "--batch_size_val", "2",
                    "--loop", "1", "--min_val", "0", "--epoch", "2", "--device", "cpu",
                    "--model", name, "--log_root", root])
    assert isinstance(run.model, cls) and sorted(run.losses) == [1, 2]
    assert all(np.isfinite(x) for x in run.losses.values())
    ckpt = os.path.join(root, "S3DIS", "default", "checkpoints", "best.pt")
    assert torch.load(ckpt, weights_only=True)["epoch"] in (1, 2)
    miou, _, _ = test_s3dis.main(["--synthetic", "--synthetic_rooms", "1", "--synthetic_raw",
                                  "4000", "--voxel_max", "2048", "--device", "cpu",
                                  "--model", name, "--log_root", root])
    served = open(os.path.join(root, "S3DIS", "default", "logs", "test_s3dis.txt")).read()
    assert "checkpoint restored" in served and 0.0 <= miou <= 1.0
