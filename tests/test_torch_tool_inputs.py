"""The inputs and checks the port's tools share, on the CPU: the profilers'
batches and rooms bit-equal to the root bench.py's and the JAX tools'
(numpy in both), the device check, ``card_fields``, and the kernels'
launch counters left alone by whole CPU paths (the plain versions run)."""

import subprocess
import types

import numpy as np
import pytest
import torch

from repsurf_torch.bench import card_fields
from repsurf_torch.cli import common, knn_window_stats, profile_cls, profile_seg
from repsurf_torch.models import _REGISTRY, RepSurfSegmentor, get_model
from repsurf_torch.ops.kernels import kernel_launches
from repsurf_torch.train import eval_s3dis as te
from repsurf_torch.train import train_cls as ttc
from repsurf_torch.train import train_seg as tts
from repsurf_tpu.data.s3dis import pad_batch as j_pad_batch
from repsurf_tpu.data.synthetic_scene import synthetic_room as j_synthetic_room

from .test_torch_model import NARROW as CLS_NARROW
from .test_torch_seg import NARROW as SEG_NARROW

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [2048, 5000])
def test_seg_batch_equals_bench_py(n):
    """bench.py's call order on RandomState(0): room, colours, labels per
    sample, then pad_batch."""
    rng = np.random.RandomState(0)
    samples = [(j_synthetic_room(n, rng=rng), rng.rand(n, 3).astype(np.float32),
                rng.randint(0, 13, n).astype(np.int64)) for _ in range(2)]
    want = j_pad_batch(samples, n)
    got = common.seg_batch(n, 2)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_cls_points_equal_bench_py():
    want = np.random.RandomState(0).randn(64, 2048, 3).astype(np.float32)
    np.testing.assert_array_equal(profile_cls.cls_points(), want)


@pytest.mark.parametrize("n_scenes", [1, 2])
def test_synthetic_scenes_equal_the_jax_tools_rooms(n_scenes):
    """tools/bench_infer_s3dis.py's order on RandomState(0): per scene the
    room, then its colours."""
    raw = 1500
    rng = np.random.RandomState(0)
    want = []
    for _ in range(n_scenes):
        coord = j_synthetic_room(raw, rng=rng)
        want.append((coord, (rng.rand(raw, 3) * 255.0).astype(np.float32)))
    got = profile_seg.synthetic_scenes(n_scenes, raw)
    assert len(got) == n_scenes
    for (gc, gf), (wc, wf) in zip(got, want):
        assert gc.dtype == wc.dtype and gf.dtype == wf.dtype
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gf, wf)


def test_resolve_device_gives_the_cpu():
    assert common.resolve_device("cpu") == torch.device("cpu")


def test_tools_default_to_the_card_and_refuse_without_one(monkeypatch):
    for tool in (profile_seg, profile_cls, knn_window_stats):
        assert tool.parse_args([]).device == "cuda", tool.__name__
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.resolve_device("cuda")


def test_card_fields_on_the_cpu():
    assert card_fields(torch.device("cpu")) == {"device": "cpu", "power_limit": None}


def test_card_fields_splits_the_nvidia_smi_line(monkeypatch):
    """The name may hold commas; the limit is after the last one."""
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return types.SimpleNamespace(stdout="NVIDIA H100, 80GB HBM3, 700.00 W\n")

    monkeypatch.setattr(subprocess, "run", run)
    got = card_fields(types.SimpleNamespace(type="cuda", index=2))
    assert got == {"device": "NVIDIA H100, 80GB HBM3", "power_limit": "700.00 W"}
    assert calls == [["nvidia-smi", "--id=2", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]]


def seg_train():
    """A train step of the narrow segmentor on profile_seg's inputs at
    2 x 2,048 points."""
    cfg, model, opt, batch, w, gen = profile_seg.seg_train_setup(2048, 2, torch.device("cpu"))
    loss, _ = tts.train_step(model, opt, batch, w, cfg, generator=gen)
    return loss


def cls_eval():
    """A one-vote eval step of the narrow classifier on profile_cls's clouds."""
    cfg = ttc.ClsConfig(num_point=64, batch_size=4, num_votes=1)
    model = get_model("repsurf.repsurf_ssg_umb", generator=torch.Generator().manual_seed(0),
                      **CLS_NARROW).eval()
    points = torch.from_numpy(profile_cls.cls_points(4, 128))
    return ttc.eval_step(model, points, torch.tensor([0, 1, 2, 3]), cfg,
                         generator=torch.Generator().manual_seed(1))[0]


def scene_votes():
    """The votes of the narrow segmentor over a room of profile_seg's,
    chunks of 512 points in batches of 2."""
    cfg = tts.SegConfig(voxel_max=512)
    model = tts.build_model(cfg, generator=torch.Generator().manual_seed(0)).eval()

    def forward_fn(batch):
        with torch.no_grad():
            return model(batch["coord"], batch["feat"], batch["valid"])

    (coord, feat), = profile_seg.synthetic_scenes(1, 3000)
    assert len(te.scene_batches(coord, feat, cfg.voxel_size, cfg.voxel_max, 2)) > 1
    return te.scene_votes(forward_fn, coord, feat, cfg.num_class, voxel_size=cfg.voxel_size,
                          voxel_max=cfg.voxel_max, batch_size=2, data_norm=cfg.data_norm,
                          device="cpu")


@pytest.mark.parametrize("path", [seg_train, cls_eval, scene_votes],
                         ids=["seg_train_step", "cls_eval_step", "scene_votes"])
def test_cpu_paths_launch_no_kernel(path, monkeypatch):
    monkeypatch.setitem(_REGISTRY, "repsurf.repsurf_umb_ssg",
                        lambda num_class=13, **kw: RepSurfSegmentor(num_class, **kw,
                                                                    **SEG_NARROW))
    before = kernel_launches()
    out = torch.as_tensor(path())
    assert out.numel() > 0 and torch.isfinite(out.double()).all()
    assert kernel_launches() == before
