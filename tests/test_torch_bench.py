"""The port's bench (``repsurf_torch.bench``, ``cli/bench_infer_s3dis``,
``cli/bench_seg``) on the CPU: its inputs bit-equal to the root bench.py's
(numpy in both), each metric's line at a tiny size with a narrow model,
the staged device-compute vote path against ``predict_scene``, and the
null marker of a failed or timed-out inference child."""

import inspect
import json
import math

import numpy as np
import pytest
import torch

from repsurf_torch import bench
from repsurf_torch.cli import bench_infer_s3dis, bench_seg
from repsurf_torch.models import _REGISTRY, RepSurfClassifier, RepSurfSegmentor
from repsurf_torch.train import eval_s3dis as te
from repsurf_torch.train.train_seg import SegConfig, build_model
from repsurf_tpu.data.s3dis import pad_batch as j_pad_batch
from repsurf_tpu.data.synthetic_scene import synthetic_room as j_synthetic_room

from .test_torch_model import NARROW as CLS_NARROW
from .test_torch_seg import NARROW as SEG_NARROW

torch.set_num_threads(1)

LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "device", "power_limit", "launches"}
NEAR_TIE = 1e-9  # top-two vote gap: the two paths differ only in summation order


@pytest.fixture
def narrow(monkeypatch):
    """The narrow classifier and segmentor stand in for the registry's."""
    monkeypatch.setitem(_REGISTRY, "repsurf.repsurf_ssg_umb",
                        lambda num_class=15, **kw: RepSurfClassifier(num_class, **kw,
                                                                     **CLS_NARROW))
    monkeypatch.setitem(_REGISTRY, "repsurf.repsurf_umb_ssg",
                        lambda num_class=13, **kw: RepSurfSegmentor(num_class, **kw,
                                                                    **SEG_NARROW))


def _json_lines(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("n", [2048, 5000])
def test_seg_batch_equals_bench_py(n):
    """bench.py's call order on RandomState(0): room, colours, labels per
    sample, then pad_batch."""
    rng = np.random.RandomState(0)
    samples = [(j_synthetic_room(n, rng=rng), rng.rand(n, 3).astype(np.float32),
                rng.randint(0, 13, n).astype(np.int64)) for _ in range(2)]
    want = j_pad_batch(samples, n)
    got = bench.seg_batch(n, 2)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_cls_points_equal_bench_py():
    want = np.random.RandomState(0).randn(64, 2048, 3).astype(np.float32)
    np.testing.assert_array_equal(bench.cls_points(), want)


def test_bench_seg_line(narrow, capsys):
    line = bench.bench_seg(n=2048, steps=1, device="cpu")
    printed = _json_lines(capsys.readouterr().out)
    assert printed == [line]
    assert LINE_KEYS | {"first_step_s"} == set(line)
    assert line["metric"] == "s3dis_train_scenes_per_sec_per_chip"
    assert math.isfinite(line["value"]) and line["value"] > 0
    # value to 3 decimals, vs_baseline to 4: 0.0005 / 6.15 + 0.00005 apart at most
    assert abs(line["vs_baseline"] - line["value"] / 6.15) <= 1.32e-4
    assert line["device"] == "cpu" and line["power_limit"] is None
    assert all(v == 0 for v in line["launches"].values())  # plain versions on the CPU


def test_bench_cls_line(narrow, capsys):
    line = bench.bench_cls(batch=2, iters=1, device="cpu")
    assert _json_lines(capsys.readouterr().out) == [line]
    assert LINE_KEYS | {"vs_baseline_range"} == set(line)
    assert line["metric"] == "scanobjectnn_eval_clouds_per_sec_per_chip"
    assert math.isfinite(line["value"]) and line["value"] > 0
    lo, hi = line["vs_baseline_range"]
    assert lo <= line["vs_baseline"] <= hi


def test_cli_bench_seg_prints_the_one_name(narrow, monkeypatch, capsys):
    """tools/bench_seg.py's alias is not printed: the CLI's line is
    bench_seg's, under s3dis_train_scenes_per_sec_per_chip."""
    full = bench.bench_seg
    monkeypatch.setattr(bench_seg, "bench_seg", lambda device: full(n=2048, steps=1,
                                                                   device=device))
    line = bench_seg.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert line["metric"] == "s3dis_train_scenes_per_sec_per_chip"
    assert "samples_per_sec" not in out


def test_main_prints_seg_infer_cls_in_order(monkeypatch):
    order = []
    for name in ("bench_seg", "bench_infer", "bench_cls"):
        monkeypatch.setattr(bench, name, lambda device, name=name: order.append((name, device)))
    bench.main(["--device", "cpu"])
    assert order == [("bench_seg", "cpu"), ("bench_infer", "cpu"), ("bench_cls", "cpu")]


def test_entry_points_default_to_the_card_and_refuse_without_one():
    for fn in (bench.bench_seg, bench.bench_infer, bench.bench_cls):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    assert bench_infer_s3dis.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.resolve_device("cuda")


def test_staged_vote_path_matches_predict_scene(narrow):
    """device_compute's labels (every batch staged, index_add_ votes) equal
    predict_scene's (the host accumulation) on a small room with the same
    chunks, apart from vote ties."""
    cfg = SegConfig(voxel_max=1024)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0)).eval()

    def forward_fn(batch):
        with torch.no_grad():
            return model(batch["coord"], batch["feat"], batch["valid"])

    scenes = bench_infer_s3dis.synthetic_scenes(1, 3000)
    coord, feat = scenes[0]
    kw = dict(voxel_size=cfg.voxel_size, voxel_max=cfg.voxel_max, batch_size=2,
              data_norm=cfg.data_norm, device="cpu")
    assert len(te.scene_batches(coord, feat, cfg.voxel_size, cfg.voxel_max, 2)) > 1
    sps, labels = bench_infer_s3dis.device_compute(cfg, forward_fn, scenes, 2,
                                                   torch.device("cpu"))
    votes = te.scene_votes(forward_fn, coord, feat, cfg.num_class, **kw)
    want = te.predict_scene(forward_fn, coord, feat, cfg.num_class, **kw)
    top2 = np.sort(votes, axis=1)[:, -2:]
    near = (top2[:, 1] - top2[:, 0]) < NEAR_TIE
    assert sps > 0 and labels[0].shape == want.shape
    np.testing.assert_array_equal(labels[0][~near], want[~near])


def test_bench_infer_cli_line(narrow, capsys):
    bench_infer_s3dis.main(["--scenes", "1", "--raw", "1500", "--device", "cpu"])
    (line,) = _json_lines(capsys.readouterr().out)
    assert LINE_KEYS | {"device_compute_value", "status", "kernel_build_s"} == set(line)
    assert line["metric"] == "s3dis_infer_scenes_per_sec_per_chip" and line["status"] == "ok"
    assert line["value"] > 0 and line["device_compute_value"] > 0
    assert line["vs_baseline"] is None and line["kernel_build_s"] == 0.0


def _assert_marker(line, status):
    assert line["metric"] == "s3dis_infer_scenes_per_sec_per_chip"
    assert line["value"] is None and line["vs_baseline"] is None
    assert line["status"] == status
    assert len(line["stderr_tail"]) <= bench.STDERR_TAIL


def test_bench_infer_failed_child_gives_the_null_marker(capsys):
    """The child asked for a card where there is none exits 1: the marker
    carries its status and the tail of its stderr."""
    if torch.cuda.is_available():
        pytest.skip("the failing child needs a machine without a card")
    line = bench.bench_infer(scenes=1, timeout=300, device="cuda")
    _assert_marker(line, "subprocess-failed-rc1")
    assert "no CUDA device" in line["stderr_tail"]
    assert _json_lines(capsys.readouterr().out) == [line]


def test_bench_infer_timeout_gives_the_null_marker():
    line = bench.bench_infer(scenes=1, timeout=0.01, device="cpu")
    _assert_marker(line, "timeout")
