"""The port's segmentation training pipeline against the JAX package on the
CPU: each augmentation, the flag-built compositions, ``data_prepare``,
``SyntheticRooms.get`` and ``S3DISDataset`` on the same ``RandomState``
draws (numpy in both, so the arrays must be equal), the ``SegConfig``
defaults, the optimizer choice, and a micro-run of the seg training CLI
(freeze flip, best checkpoint, resume, pretrain, then the test CLI on the
checkpoint) with a narrow model.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repsurf_torch.config import S3DIS_AUG_ARGS
from repsurf_torch.data import aug as taug
from repsurf_torch.data import s3dis as ts3dis
from repsurf_torch.data.synthetic_scene import SyntheticRooms
from repsurf_torch.models import _REGISTRY, RepSurfSegmentor
from repsurf_torch.train import train_seg as tts
from repsurf_torch.utils import AverageMeter, StepTimer
from repsurf_tpu.config.presets import S3DIS_AUG_ARGS as J_S3DIS_AUG_ARGS
from repsurf_tpu.data import aug as jaug
from repsurf_tpu.data import s3dis as js3dis
from repsurf_tpu.data.synthetic_scene import SyntheticRooms as JSyntheticRooms
from repsurf_tpu.train import train_seg as jts

from .test_torch_seg import NARROW

torch.set_num_threads(1)

# every transform of data/aug.py, with a probability of 1 where it has one,
# so each case draws and transforms
TRANSFORMS = [
    ("RandomRotate", dict(prob=1.0)),
    ("RandomRotateAligned", dict(prob=1.0)),
    ("RandomRotatePerturb", dict(prob=1.0)),
    ("RandomRotatePerturbAligned", dict(prob=1.0)),
    ("RandomScale", dict(anisotropic=True)),
    ("RandomShift", dict(prob=1.0)),
    ("RandomFlip", dict()),
    ("RandomJitter", dict(is_lidar=True)),
    ("ChromaticAutoContrast", dict(prob=1.0)),
    ("ChromaticTranslation", dict(prob=1.0)),
    ("ChromaticJitter", dict(prob=1.0)),
    ("HueSaturationTranslation", dict()),
    ("RandomDropColor", dict(prob=1.0)),
]


def _sample(seed=0, n=500):
    rs = np.random.RandomState(seed)
    coord = (rs.rand(n, 3) * 4).astype(np.float32)
    feat = (rs.rand(n, 3) * 255).astype(np.float32)
    label = rs.randint(0, 13, n).astype(np.float32)
    return coord, feat, label


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name,kw", TRANSFORMS, ids=[t[0] for t in TRANSFORMS])
def test_each_transform_matches_jax_on_the_same_draws(name, kw):
    coord, feat, label = _sample(1)
    got = getattr(taug, name)(**kw)(coord, feat, label, np.random.RandomState(7))
    want = getattr(jaug, name)(**kw)(coord, feat, label, np.random.RandomState(7))
    _assert_same(got, want)
    changed = not (np.array_equal(got[0], coord) and np.array_equal(got[1], feat))
    assert changed, f"{name} left the sample as it was"


@pytest.mark.parametrize("aug_rotate", [None, "pert", "pert_z", "rot", "rot_z"])
def test_compose_from_flags_matches_jax(aug_rotate):
    flags = dict(aug_scale=True, aug_rotate=aug_rotate, aug_flip=True, aug_shift=True,
                 color_contrast=True, color_shift=True, color_jitter=True, hs_shift=True,
                 color_drop=True)
    assert S3DIS_AUG_ARGS == J_S3DIS_AUG_ARGS
    tcfg, jcfg = tts.SegConfig(**flags), jts.SegConfig(**flags)
    tc, jc = (taug.coord_transform_from_flags(tcfg, S3DIS_AUG_ARGS),
              jaug.coord_transform_from_flags(jcfg, J_S3DIS_AUG_ARGS))
    tr, jr = taug.rgb_transform_from_flags(tcfg), jaug.rgb_transform_from_flags(jcfg)
    assert [type(t).__name__ for t in tc.transforms] == [type(t).__name__ for t in jc.transforms]
    assert [type(t).__name__ for t in tr.transforms] == [type(t).__name__ for t in jr.transforms]
    coord, feat, label = _sample(2)
    _assert_same(tc(coord, feat, label, np.random.RandomState(3)),
                 jc(coord, feat, label, np.random.RandomState(3)))
    _assert_same(tr(coord, feat, label, np.random.RandomState(4)),
                 jr(coord, feat, label, np.random.RandomState(4)))
    # no flag, no composition
    assert taug.coord_transform_from_flags(tts.SegConfig(), S3DIS_AUG_ARGS) is None
    assert taug.rgb_transform_from_flags(tts.SegConfig()) is None


def test_aug_jitter_has_no_s3dis_arguments_in_either():
    """S3DIS_AUG_ARGS (segmentation/util/utils.py:125-133) has no jitter
    factor: --aug_jitter fails in the JAX package, and in the port alike."""
    cfg = tts.SegConfig(aug_jitter=True)
    with pytest.raises(KeyError, match="jitter_factor"):
        jaug.coord_transform_from_flags(cfg, J_S3DIS_AUG_ARGS)
    with pytest.raises(KeyError, match="jitter_factor"):
        taug.coord_transform_from_flags(cfg, S3DIS_AUG_ARGS)


def _flagged():
    flags = dict(aug_scale=True, aug_rotate="rot_z", aug_flip=True, aug_shift=True,
                 color_contrast=True, color_shift=True, color_jitter=True, hs_shift=True,
                 color_drop=True)
    cfg = tts.SegConfig(**flags)
    return (taug.coord_transform_from_flags(cfg, S3DIS_AUG_ARGS),
            taug.rgb_transform_from_flags(cfg),
            jaug.coord_transform_from_flags(cfg, J_S3DIS_AUG_ARGS),
            jaug.rgb_transform_from_flags(cfg))


@pytest.mark.parametrize("split", ["train", "val"])
def test_data_prepare_matches_jax(split):
    """Augment, voxelize (one random point a voxel), crop around a random
    seed to voxel_max (train), shuffle, centre, standardise colours."""
    room = SyntheticRooms("train", n_rooms=1, raw_points=6000, seed=5).raw(0)
    coord, feat, label = room[:, :3], room[:, 3:6], room[:, 6]
    tc, tr, jc, jr = _flagged()
    kw = dict(split=split, voxel_size=0.04, voxel_max=2500)
    got = ts3dis.data_prepare(coord.copy(), feat.copy(), label.copy(), coord_transform=tc,
                              rgb_transform=tr, rng=np.random.RandomState(11), **kw)
    want = js3dis.data_prepare(coord.copy(), feat.copy(), label.copy(), coord_transform=jc,
                               rgb_transform=jr, rng=np.random.RandomState(11), **kw)
    _assert_same(got, want)
    n = got[0].shape[0]
    assert n == 2500 if split == "train" else n > 2500  # val is never cropped
    np.testing.assert_allclose(got[0].mean(0), 0.0, atol=1e-4)


@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_rooms_get_matches_jax(split):
    tc, tr, jc, jr = _flagged()
    kw = dict(n_rooms=3, raw_points=5000, loop=2, voxel_size=0.04, voxel_max=3000, seed=9)
    got_ds = SyntheticRooms(split, coord_transform=tc, rgb_transform=tr, **kw)
    want_ds = JSyntheticRooms(split, coord_transform=jc, rgb_transform=jr, **kw)
    assert len(got_ds) == len(want_ds) == 6 and got_ds.rooms == want_ds.rooms
    for idx in (0, 4):  # room 0, and room 1 on the second loop
        _assert_same(got_ds.get(idx, rng=np.random.RandomState(idx)),
                     want_ds.get(idx, rng=np.random.RandomState(idx)))
    np.testing.assert_array_equal(got_ds.raw(2), want_ds._make(2))


def test_s3dis_dataset_reads_rooms_with_the_area_split_and_loop(tmp_path):
    names = ["Area_1_office_1", "Area_2_hallway_3", "Area_5_office_7", "Area_5_lobby_1"]
    for i, name in enumerate(names):  # rooms of synthetic_room, as [N, 7] room files
        np.save(tmp_path / f"{name}.npy", SyntheticRooms("train", n_rooms=1, raw_points=3000,
                                                          seed=100 + i).raw(0))
    (tmp_path / "notes.txt").write_text("not a room")
    tc, tr, jc, jr = _flagged()
    for split, want_rooms in (("train", names[:2]), ("val", sorted(names[2:]))):
        kw = dict(split=split, test_area=5, loop=3, voxel_size=0.04, voxel_max=2000)
        got = ts3dis.S3DISDataset(str(tmp_path), coord_transform=tc, rgb_transform=tr, **kw)
        want = js3dis.S3DISDataset(str(tmp_path), coord_transform=jc, rgb_transform=jr, **kw)
        assert got.rooms == want.rooms == want_rooms
        assert len(got) == len(want) == 3 * len(want_rooms)
        for idx in (0, len(got) - 1):
            _assert_same(got.get(idx, rng=np.random.RandomState(idx + 20)),
                         want.get(idx, rng=np.random.RandomState(idx + 20)))
    assert ts3dis.S3DIS_LOOP == js3dis.S3DIS_LOOP


def test_seg_config_defaults_match_jax():
    tf = {f.name: f.default for f in dataclasses.fields(tts.SegConfig)}
    jf = {f.name: f.default for f in dataclasses.fields(jts.SegConfig)}
    # label_smoothing is the port's alone (PointNeXt's recipe); at its
    # default 0 the loss is the JAX package's weighted cross-entropy
    assert tf.pop("label_smoothing") == 0.0
    assert set(jf) == set(tf)  # pred_ignore0 too, since ScanNet was ported
    for name, value in tf.items():
        assert value == jf[name] or tuple(value) == tuple(jf[name]), name


def test_make_optimizer_builds_adamw_or_sgd():
    model = torch.nn.Linear(3, 2)
    adamw = tts.make_optimizer(model, tts.SegConfig())
    assert isinstance(adamw, torch.optim.AdamW)
    assert adamw.defaults["weight_decay"] == 1e-2 and adamw.defaults["lr"] == 6e-3
    sgd = tts.make_optimizer(model, tts.SegConfig(optimizer="SGD", momentum=0.8,
                                                  weight_decay=1e-4))
    assert isinstance(sgd, torch.optim.SGD)
    assert (sgd.defaults["momentum"], sgd.defaults["weight_decay"]) == (0.8, 1e-4)
    with pytest.raises(ValueError):
        tts.make_optimizer(model, tts.SegConfig(optimizer="Adam"))


def test_meters_match_jax():
    from repsurf_tpu.utils.logging import AverageMeter as JAverageMeter

    got, want = AverageMeter(), JAverageMeter()
    for v, n in ((1.5, 2), (3.0, 1), (0.25, 4)):
        got.update(v, n)
        want.update(v, n)
    assert (got.val, got.avg, got.sum, got.count) == (want.val, want.avg, want.sum, want.count)
    timer = StepTimer()
    timer.data_loaded()
    timer.step_done()
    assert timer.batch.count == timer.data.count == 1 and timer.eta(0) == "00:00:00"


@pytest.mark.parametrize("flag", [["--n_devices", "0"], ["--bn", "global_sync"],
                                  ["--workers", "-1"], ["--dataset", "ModelNet40"]])
def test_cli_refuses_unported_flags(flag):
    """Every flag of the JAX CLI is ported (tests/test_torch_scannet.py,
    test_torch_loader.py, test_torch_parallel.py run them); what is left to
    refuse is a value no package serves."""
    from repsurf_torch.cli import train_seg as cli

    with pytest.raises(SystemExit):
        cli.parse_args(flag)
    cli.parse_args([flag[0], {"--n_devices": "2", "--bn": "sync", "--workers": "2",
                              "--dataset": "ScanNet"}[flag[0]]])


def _constructor(state):
    return {k: v for k, v in state.items() if k.startswith(tts.FROZEN_SCOPE + ".")}


def test_cli_trains_validates_checkpoints_resumes_and_serves(tmp_path, monkeypatch):
    """``main()`` on two synthetic rooms of 4,000 raw points, batches padded
    to 2,048, a narrow model, validation every epoch, frozen from epoch 2:
    a 2-epoch run, its resume to epoch 3 equal to an unbroken 3-epoch run
    (losses, every parameter and buffer), the constructor bit-unmoved from
    epoch 2 on, --pretrain loading the weights alone, then the test CLI
    serving a room from the best checkpoint."""
    from repsurf_torch.cli import test_s3dis
    from repsurf_torch.cli import train_seg as cli

    monkeypatch.setitem(_REGISTRY, "repsurf.repsurf_umb_ssg",
                        lambda num_class=13, **kw: RepSurfSegmentor(num_class, **kw, **NARROW))
    base = ["--synthetic", "--synthetic_rooms", "2", "--synthetic_raw", "4000", "--voxel_max",
            "2048", "--batch_size", "2", "--batch_size_val", "2", "--loop", "1", "--min_val",
            "0", "--freeze_epoch", "1", "--device", "cpu"]
    a, u = str(tmp_path / "a"), str(tmp_path / "u")
    ckpt_dir = os.path.join(a, "S3DIS", "default", "checkpoints")
    first = cli.main([*base, "--epoch", "2", "--log_root", a])
    saved = torch.load(os.path.join(ckpt_dir, "best.pt"), weights_only=True)
    log = open(os.path.join(a, "S3DIS", "default", "logs", "train_seg.txt")).read()
    best_epochs = [int(ln.rsplit("(epoch ", 1)[1].split()[0]) for ln in log.splitlines()
                   if "best mIoU ->" in ln]
    assert best_epochs and saved["epoch"] == best_epochs[-1]
    assert saved["best_metric"] == first.best_iou > 0
    assert "frozen" not in next(ln for ln in log.splitlines() if "train epoch 1/2" in ln)
    assert "frozen" in next(ln for ln in log.splitlines() if "train epoch 2/2" in ln)
    # epoch 2 is frozen: the constructor the checkpoint holds is epoch 1's
    after_one = _constructor(saved["model"])
    init = _constructor(tts.build_model(tts.SegConfig(), torch.Generator().manual_seed(2000))
                        .state_dict())
    assert any(not torch.equal(after_one[k], init[k]) for k in after_one if "weight" in k)

    resumed = cli.main([*base, "--epoch", "3", "--log_root", a, "--resume", ckpt_dir])
    unbroken = cli.main([*base, "--epoch", "3", "--log_root", u])
    log = open(os.path.join(a, "S3DIS", "default", "logs", "train_seg.txt")).read()
    assert f"(epoch {saved['epoch']}, best" in log
    assert sorted(resumed.losses) == list(range(saved["epoch"] + 1, 4))
    assert resumed.losses[3] == unbroken.losses[3]
    got, want = resumed.model.state_dict(), unbroken.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    for k, v in after_one.items():  # frozen from epoch 2 on, across the resume
        if k.endswith(("weight", "bias")):
            assert torch.equal(got[k], v) and torch.equal(want[k], v), k

    pre = cli.main([*base, "--epoch", "0", "--log_root", str(tmp_path / "p"), "--pretrain",
                    os.path.join(ckpt_dir, "best.pt")])
    final = torch.load(os.path.join(ckpt_dir, "best.pt"), weights_only=True)
    assert all(torch.equal(pre.model.state_dict()[k], final["model"][k]) for k in final["model"])
    assert pre.optimizer.state_dict()["state"] == {} and pre.losses == {}

    miou, _, _ = test_s3dis.main(["--synthetic", "--synthetic_rooms", "1", "--synthetic_raw",
                                  "4000", "--voxel_max", "2048", "--device", "cpu",
                                  "--log_root", a])
    served = open(os.path.join(a, "S3DIS", "default", "logs", "test_s3dis.txt")).read()
    assert "checkpoint restored" in served and 0.0 <= miou <= 1.0
