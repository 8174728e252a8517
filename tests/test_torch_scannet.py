"""ScanNet in the port (``data/scannet.py``, ``SegConfig.pred_ignore0``, the
seg CLI's ``--dataset ScanNet``) against the JAX package on the CPU.

Scenes are ``scene*.npy`` files of xyzrgbl rows written inside each test
(``synthetic_scan``).  The dataset must return JAX's arrays on one
``RandomState``; the train and eval steps with ``pred_ignore0`` must give
JAX's counters and predictions on transferred weights, never class 0; the
data-parallel step with ``pred_ignore0`` gives JAX's ``train_step``
counters (JAX's own sharded step takes the plain argmax).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repsurf_torch.data import scannet as tscannet
from repsurf_torch.models import _REGISTRY, RepSurfSegmentor
from repsurf_torch.models import get_model as t_get_model
from repsurf_torch.parallel import distributed
from repsurf_torch.parallel.shard_step import make_seg_train_step
from repsurf_torch.train import train_seg as tts
from repsurf_torch.train.jax_params import state_dict_from_flax
from repsurf_tpu.data import scannet as jscannet
from repsurf_tpu.models import get_model as j_get_model
from repsurf_tpu.train import train_seg as jts
from repsurf_tpu.train.optim import make_sgd as j_make_sgd

from .test_torch_seg import NARROW, _batch, _random_variables
from .test_torch_train_seg import _assert_same, _flagged

torch.set_num_threads(1)

NAMES = ["scene0000_00", "scene0001_00", "scene0002_01", "scene0003_00", "scene0004_02",
         "scene0005_00"]


def _write_scenes(path, n=3000, names=NAMES):
    for i, name in enumerate(names):
        np.save(path / f"{name}.npy", tscannet.synthetic_scan(n, size=(3.0, 3.0, 2.5), seed=i))


def test_constants_match_jax():
    for name in ("NUM_CLASS", "VOXEL_SIZE", "VOXEL_MAX", "IGNORE_LABEL", "LOOP"):
        assert getattr(tscannet, name) == getattr(jscannet, name), name
    assert tscannet.CLASS_WEIGHTS == jscannet.CLASS_WEIGHTS
    np.testing.assert_array_equal(tscannet.SCANNET_RGB_MEAN, jscannet.SCANNET_RGB_MEAN)
    np.testing.assert_array_equal(tscannet.SCANNET_RGB_STD, jscannet.SCANNET_RGB_STD)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("listed", [True, False], ids=["split_lists", "crc32"])
def test_dataset_matches_jax(tmp_path, split, listed):
    _write_scenes(tmp_path)
    if listed:
        (tmp_path / "train.txt").write_text("\n".join(NAMES[:4]) + "\n")
        (tmp_path / "val.txt").write_text("\n".join(NAMES[4:]) + "\n\n")
    tc, tr, jc, jr = _flagged()
    kw = dict(voxel_max=1500) if split == "train" else {}
    got = tscannet.ScanNetDataset(str(tmp_path), split, coord_transform=tc, rgb_transform=tr,
                                  **kw)
    want = jscannet.ScanNetDataset(str(tmp_path), split, coord_transform=jc, rgb_transform=jr,
                                   **kw)
    assert got.rooms == want.rooms and got.split == want.split == split
    if listed:
        assert got.rooms == (NAMES[:4] if split == "train" else NAMES[4:])
    assert len(got) == len(want) == tscannet.LOOP * len(got.rooms) > 0
    for idx in (0, len(got) - 1):
        a = got.get(idx, rng=np.random.RandomState(idx + 3))
        _assert_same(a, want.get(idx, rng=np.random.RandomState(idx + 3)))
        assert len(a[0]) == 1500 if split == "train" else len(a[0]) > 1500


@pytest.fixture(scope="module")
def scannet_pair():
    """(JAX 21-class model without inversion or dropout, its variables, the
    port's model with those weights, a batch with ScanNet labels).  Class
    0's output bias is raised, so the plain argmax picks 0 at many points."""
    jm = j_get_model("repsurf.repsurf_umb_ssg", num_class=21, head_dropout=0.0,
                     random_inv=False, **NARROW)
    variables = _random_variables(jm, 64, 7)
    variables["params"]["classifier"]["Linear_1"]["bias"][0] += 2.0
    tm = t_get_model("repsurf.repsurf_umb_ssg", num_class=21, head_dropout=0.0,
                     random_inv=False, **NARROW)
    tm.load_state_dict(state_dict_from_flax(variables), strict=True)
    b = _batch(5)
    rs = np.random.RandomState(9)
    b["label"] = rs.randint(0, 21, b["label"].shape).astype(np.int64)
    b["label"][1, b["valid"][1]:] = 0
    return jm, variables, tm, b


def _configs(pred_ignore0):
    common = dict(num_class=21, ignore_label=0, pred_ignore0=pred_ignore0, head_dropout=0.0,
                  optimizer="SGD")
    return (tts.SegConfig(**common),
            jts.SegConfig(voxel_max=_batch(0)["coord"].shape[1], batch_size=2, **common))


def _jax_state(jm, variables, cfg):
    return jts.SegTrainState.create(apply_fn=jm.apply, params=variables["params"],
                                    tx=j_make_sgd(cfg.learning_rate, cfg.momentum,
                                                  cfg.weight_decay),
                                    batch_stats=variables["batch_stats"])


@pytest.mark.parametrize("pred_ignore0", [True, False])
def test_eval_step_predictions_match_jax(scannet_pair, pred_ignore0):
    jm, variables, tm, b = scannet_pair
    cfg, jcfg = _configs(pred_ignore0)
    w = np.asarray(tscannet.CLASS_WEIGHTS, np.float32)
    jloss, jpred, jparts = jts.eval_step(_jax_state(jm, variables, jcfg),
                                         {k: jnp.asarray(v) for k, v in b.items()},
                                         jnp.asarray(w), jcfg)
    loss, pred, parts = tts.eval_step(tm, {k: torch.from_numpy(v) for k, v in b.items()},
                                      torch.from_numpy(w), cfg)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    for a, c in zip(parts, jparts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    assert abs(float(loss) - float(jloss)) < 1e-5
    assert (pred.numpy() == 0).any() != pred_ignore0  # the plain argmax takes class 0 too


def test_train_step_counters_match_jax_and_never_predict_0(scannet_pair):
    jm, variables, _, b = scannet_pair
    cfg, jcfg = _configs(True)
    w = np.asarray(tscannet.CLASS_WEIGHTS, np.float32)
    _, jloss, jparts = jts.train_step(_jax_state(jm, variables, jcfg),
                                      {k: jnp.asarray(v) for k, v in b.items()},
                                      jnp.asarray(w), jax.random.PRNGKey(0), jcfg)
    tm = t_get_model("repsurf.repsurf_umb_ssg", num_class=21, head_dropout=0.0,
                     random_inv=False, **NARROW)
    tm.load_state_dict(state_dict_from_flax(variables), strict=True)
    tbatch = {k: torch.from_numpy(v) for k, v in b.items()}
    loss, parts = tts.train_step(tm, tts.make_optimizer(tm, cfg), tbatch, torch.from_numpy(w),
                                 cfg)
    assert abs(float(loss) - float(jloss)) < 1e-4
    for a, c in zip(parts, jparts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    inter, union, _ = parts
    assert union[0] == 0  # class 0 is neither predicted nor counted as a target

    # the data-parallel step at world size 1 applies the same predict
    tm.load_state_dict(state_dict_from_flax(variables), strict=True)
    distributed.init_distributed("gloo", 1, 0, timeout_s=60)
    try:
        step = make_seg_train_step(cfg, bn="sync")
        dloss, dparts = step(tm, tts.make_optimizer(tm, cfg), tbatch, torch.from_numpy(w))
    finally:
        distributed.shutdown()
    assert float(dloss) == float(loss)
    for a, c in zip(dparts, parts):
        assert torch.equal(a, c)


def test_cli_trains_scannet_and_never_predicts_0(tmp_path, monkeypatch):
    """``main(["--dataset", "ScanNet", ...])`` on four train and two val
    scenes with a narrow model: ScanNet's 21 classes and ignore label,
    voxel 0.02 (the flag left at its S3DIS default), finite losses, no
    predicted 0 in validation."""
    from repsurf_torch.cli import train_seg as cli

    monkeypatch.setitem(_REGISTRY, "repsurf.repsurf_umb_ssg",
                        lambda num_class=13, **kw: RepSurfSegmentor(num_class, **kw, **NARROW))
    _write_scenes(tmp_path)
    (tmp_path / "train.txt").write_text("\n".join(NAMES[:4]))
    (tmp_path / "val.txt").write_text("\n".join(NAMES[4:]))
    run = cli.main(["--dataset", "ScanNet", "--data_dir", str(tmp_path), "--voxel_max", "2048",
                    "--batch_size", "2", "--batch_size_val", "2", "--loop", "1", "--min_val",
                    "0", "--epoch", "2", "--device", "cpu", "--log_root", str(tmp_path / "log")])
    log = (tmp_path / "log" / "ScanNet" / "default" / "logs" / "train_seg.txt").read_text()
    assert "num_class=21, ignore_label=0, pred_ignore0=True" in log
    assert "voxel_size=0.02, voxel_max=2048" in log and "train rooms=4 val rooms=2" in log
    assert sorted(run.losses) == [1, 2] and all(np.isfinite(v) for v in run.losses.values())
    predicted = [json.loads(ln.split("predicted points by class, val epoch ", 1)[1]
                            .split(": ", 1)[1])
                 for ln in log.splitlines() if "predicted points by class" in ln]
    assert len(predicted) == 2 and all(p[0] == 0 and sum(p) > 0 for p in predicted)
    assert run.model.classifier[-1].out_features == 21
