"""The readers of the program's spans (``harness/spans.py`` and the four
metrics that use it): on hand-made records, on a record with no program
spans (None, never 0), and on the host spans of a CPU trace of the program
itself, so that a renamed span fails here."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import common, spans, trace

METRICS = ("host_prep_ms.infer", "host_prep_pct.infer", "host_issue_pct.train",
           "host_issue_pct.serve")


def reader(name):
    return common.load_module(common.BENCH / "metrics" / f"{name}.py", name).read


def record(host_spans, window_s=1.0, units=2):
    return {"host_spans": host_spans, "window_s": window_s, "busy_s": 0.5,
            "units": [{"train": False, "votes": 1, "forwards": []}] * units}


def test_the_metrics_are_declared_for_the_cells_their_spans_are_in():
    declared = {m["name"]: m for m in json.loads((common.REPO / "BENCHMARK.json").read_text())
                ["per_layer"]}
    assert declared["host_prep_ms.infer"]["workloads"] == ["s3dis_scene_infer"]
    assert declared["host_prep_pct.infer"]["workloads"] == ["s3dis_scene_infer"]
    assert declared["host_issue_pct.train"]["workloads"] == ["s3dis_seg_train",
                                                             "scanobjectnn_cls_train"]
    assert declared["host_issue_pct.serve"]["workloads"] == ["scanobjectnn_cls_serve"]
    assert {declared[m]["source"] for m in METRICS} == {"device_trace"}


def test_readers_on_a_hand_made_record():
    rec = record([
        ["bench:cell", 0.0, 0.5], ["scene.prepare", 0.0, 0.3], ["scene.crop", 0.1, 0.1],
        ["bench:cell", 0.5, 0.5], ["scene.prepare", 0.5, 0.2],
        ["train.forward", 0.1, 0.05], ["train.backward", 0.2, 0.1], ["train.update", 0.3, 0.05],
        ["serve.sample", 0.6, 0.01], ["serve.forward", 0.62, 0.04],
    ], window_s=2.0, units=2)
    assert reader("host_prep_ms.infer")(rec) == pytest.approx(1e3 * 0.5 / 2)
    assert reader("host_prep_pct.infer")(rec) == pytest.approx(100 * 0.5 / 2.0)
    assert reader("host_issue_pct.train")(rec) == pytest.approx(100 * 0.2 / 2.0)
    assert reader("host_issue_pct.serve")(rec) == pytest.approx(100 * 0.05 / 2.0)


def test_a_span_nested_in_another_of_the_set_counts_once():
    rec = record([["train.update", 0.0, 0.4], ["train.forward", 0.1, 0.1],
                  ["train.backward", 0.3, 0.3]], window_s=1.0)
    assert spans.seconds(rec, spans.TRAIN_ISSUE) == pytest.approx(0.6)
    assert reader("host_issue_pct.train")(rec) == pytest.approx(60.0)


@pytest.mark.parametrize("host_spans", [[], [["bench:cell", 0.0, 1.0], ["aten::mm", 0.1, 0.2]]],
                         ids=["empty", "harness-only"])
def test_readers_give_none_without_program_spans(host_spans):
    for name in METRICS:
        assert reader(name)(record(host_spans)) is None, name


def test_readers_give_none_for_an_empty_span_or_no_units():
    assert reader("host_prep_pct.infer")(record([["scene.prepare", 0.0, 0.1]],
                                                window_s=0.0)) is None
    assert reader("host_prep_ms.infer")(record([["scene.prepare", 0.0, 0.1]], units=0)) is None


def padded(events):
    """A CPU trace's events between the traced span's spin kernels, with
    one device kernel inside, as ``trace.summarize`` takes them."""
    lo = min(e["ts"] for e in events if "ts" in e)
    hi = max(e["ts"] + e.get("dur", 0) for e in events if "ts" in e)
    pads = [{"ph": "X", "cat": "kernel", "name": "spin_kernel", "ts": lo - 100.0 + i, "dur": 0.5}
            for i in range(trace.PAD_KERNELS)]
    pads += [{"ph": "X", "cat": "kernel", "name": "spin_kernel", "ts": hi + 10.0 + i, "dur": 0.5}
             for i in range(trace.PAD_KERNELS)]
    work = {"ph": "X", "cat": "kernel", "name": "gemm", "ts": lo, "dur": 1.0}
    return pads[:trace.PAD_KERNELS] + events + [work] + pads[trace.PAD_KERNELS:]


def program_trace(tmp_path, run):
    """The record of a CPU trace of ``run()`` (the program at a tiny size)
    between the harness's labels, through ``trace.summarize``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench:cell"):
            run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    rec, why = trace.summarize(padded(events), 1, uniform=False)
    assert why == "whole"
    rec["units"] = [{"train": False, "votes": 1, "forwards": []}]
    return rec


def tiny_room():
    from benchmark.data.synthetic_scene import raw_room

    coord, rgb = raw_room(np.random.RandomState(4), 3000, (3.0, 2.5))[:2]
    return coord, rgb


def test_readers_on_the_programs_own_spans(tmp_path):
    """The program's spans as its CPU trace gives them: every reader finds
    its spans, none exceeds the span it is a share of."""
    from repsurf_torch.models import get_model
    from repsurf_torch.train import eval_s3dis, train_cls

    coord, rgb = tiny_room()
    cls_narrow = dict(sa_npoint=(32, 8), sa_nsample=(8, 16), sa_mlp=((8, 8, 16), (16, 16, 32)),
                      final_mlp=(32, 32, 64), head_hidden=(32, 16))
    model = get_model("repsurf.repsurf_ssg_umb", generator=torch.Generator().manual_seed(0),
                      **cls_narrow)
    cfg = train_cls.ClsConfig(num_point=64, batch_size=4, num_votes=2)
    optimizer = train_cls.make_optimizer(model, cfg)
    points = torch.from_numpy(np.random.RandomState(5).rand(4, 128, 3).astype(np.float32))
    target = torch.tensor([0, 1, 2, 3])

    def run():
        eval_s3dis.scene_votes(lambda b: torch.zeros(*b["coord"].shape[:2], 13), coord, rgb, 13,
                               voxel_size=0.1, voxel_max=512, batch_size=2, device="cpu")
        train_cls.train_step(model, optimizer, points, target, cfg,
                             generator=torch.Generator().manual_seed(1))
        model.eval()
        train_cls.eval_step(model, points, target, cfg, generator=torch.Generator().manual_seed(2))

    rec = program_trace(tmp_path, run)
    labels = {name for name, _, _ in rec["host_spans"]}
    assert set(spans.SCENE_PREP + spans.TRAIN_ISSUE + spans.SERVE_ISSUE) <= labels
    (prep,) = [d for name, _, d in rec["host_spans"] if name == "scene.prepare"]
    assert reader("host_prep_ms.infer")(rec) == pytest.approx(1e3 * prep)
    for name in METRICS[1:]:
        value = reader(name)(rec)
        assert value is not None and 0 < value <= 100, name
    total = sum(reader(name)(rec) for name in METRICS[1:])
    assert total <= 100 + 1e-9  # the three stages do not overlap
