"""The Point Transformer cell, ``s3dis_pt_train``: a whole run at a tiny
size on the CPU comes out correct, and not correct when the timed path
trains on half of each batch, leaves the weights unchanged, or when the
control (TF32 products) stands in for the program; the readers of its two
span metrics on hand-made records and on the program's own CPU trace."""

import copy
import importlib
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import common, runner, spans, training, trace
from benchmark.reference import models

CELL = "s3dis_pt_train"
METRICS = ("pt_attention_pct.train", "pt_transition_pct.train")

# The cell shrunk to two clouds of 2,048 points (the program's plain path).
# As for the other training cells (conftest.TINY), three AdamW steps at this
# size amplify rounding far more than at the cell's own, so the run gets
# limits of its own, set as the cell's are: 14 seeds of sound tiny runs on
# the CPU read loss, gradient and change gaps of at most 1.7e-2, 4.1e-3,
# 4.6e-2; the control (TF32 products) at least 1.4e-3, 0.53, 5.0e-2; half of
# each batch at least 1.5e-2, 1.04, 0.89; a state left unchanged reads 1.
# The gradient's gap separates them; the loss's cannot at this size.
TINY = {"traffic": {"batch": 2, "points": 2048},
        "cell": {"limits": {"loss_gap": 5e-2, "grad_gap": 5e-2, "change_gap": 0.2}}}


def _run(seed=2**31 + 11):
    return runner.run(CELL, seed, 0.5, False, device="cpu", overrides=copy.deepcopy(TINY))


def test_sound_run():
    result, checks = _run()
    assert result["correct"], checks
    spec = common.load_spec(CELL)
    assert set(result["metrics"]) == {m["name"] for m in spec.end_to_end} == {
        "setup_s", "train_samples_per_s"}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert [name for name, _, _ in checks] == ["loss_gap", "grad_gap", "change_gap"]


def _half(monkeypatch):
    from repsurf_torch.train import train_seg

    real = train_seg.train_step

    def step(model, optimizer, batch, *a, **k):
        h = batch["coord"].shape[0] // 2
        return real(model, optimizer, {n: v[:h] for n, v in batch.items()}, *a, **k)

    monkeypatch.setattr(train_seg, "train_step", step)


def _unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


@pytest.mark.parametrize("fault", [_half, _unchanged], ids=["half", "unchanged"])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result, checks = _run()
    assert not result["correct"], checks


def test_control_is_not_correct():
    """The reference with TF32 products in the program's place fails one of
    the tiny run's numbers."""
    spec = common.load_spec(CELL)
    for key, values in copy.deepcopy(TINY).items():
        getattr(spec, key).update(values)
    kind = importlib.import_module(f"benchmark.traffic.{spec.traffic['kind']}")
    state = kind.setup(runner.Context(spec, 78, "cpu"))
    kind.free(state)
    ref = kind.reference(state)
    ctl = kind.reference(state, prec=models.Precision(tf32=True))
    assert any(v > lim for _, v, lim in training.checks(ctl, ref, spec.cell["limits"]))


# -- the readers of the cell's span metrics ----------------------------------

def reader(name):
    return common.load_module(common.BENCH / "metrics" / f"{name}.py", name).read


def record(host_spans, window_s=1.0):
    return {"host_spans": host_spans, "window_s": window_s, "busy_s": 0.5,
            "units": [{"train": True, "votes": 1, "forwards": []}]}


def test_the_metrics_are_declared_for_the_cell():
    declared = {m["name"]: m for m in json.loads((common.REPO / "BENCHMARK.json").read_text())
                ["per_layer"]}
    for name in METRICS:
        assert declared[name]["workloads"] == [CELL]
        assert declared[name]["source"] == "device_trace"
        assert declared[name]["moves"] == "train_samples_per_s"
    assert declared["pt_attention_pct.train"]["layer"] == "model step"
    assert declared["pt_transition_pct.train"]["layer"] == "geometry and ops"


def test_readers_on_a_hand_made_record():
    rec = record([
        ["bench:s3dis_pt_train", 0.0, 1.0], ["train.forward", 0.0, 0.6],
        ["pt.attention", 0.1, 0.1], ["pt.attention", 0.3, 0.05], ["pt.down", 0.2, 0.05],
        ["pt.up", 0.4, 0.02], ["pt.up", 0.5, 0.03], ["aten::mm", 0.11, 0.01],
    ], window_s=2.0)
    assert reader("pt_attention_pct.train")(rec) == pytest.approx(100 * 0.15 / 2.0)
    assert reader("pt_transition_pct.train")(rec) == pytest.approx(100 * 0.10 / 2.0)


@pytest.mark.parametrize("host_spans", [[], [["bench:s3dis_pt_train", 0.0, 1.0],
                                             ["train.forward", 0.0, 0.5],
                                             ["aten::mm", 0.1, 0.2]]],
                         ids=["empty", "no-pt-spans"])
def test_readers_give_none_without_the_spans(host_spans):
    """The parent of these spans, or an umbrella model, has none of them:
    the metric is left out, never read as 0."""
    for name in METRICS:
        assert reader(name)(record(host_spans)) is None, name


def test_readers_give_none_for_an_empty_span():
    for name in METRICS:
        assert reader(name)(record([["pt.attention", 0.0, 0.1], ["pt.up", 0.0, 0.1]],
                                   window_s=0.0)) is None, name


def test_readers_on_the_programs_own_spans(tmp_path):
    """A CPU trace of the program's Point Transformer forward, between the
    harness's labels: both readers find their spans, each share within the
    span it is a share of, the two not overlapping."""
    from benchmark.tests.test_harness_spans import padded
    from repsurf_torch.train import train_seg

    conf = common.load_spec(CELL).config
    model = train_seg.build_model(train_seg.SegConfig(**conf["program"])).eval()
    g = torch.Generator().manual_seed(0)
    coord, feat = torch.rand(1, 1024, 3, generator=g), torch.rand(1, 1024, 3, generator=g)
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        with torch.profiler.record_function("bench:cell"):
            model(coord, feat, torch.tensor([1024]))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    rec, why = trace.summarize(padded(json.loads(path.read_text())["traceEvents"]), 1,
                               uniform=False)
    assert why == "whole"
    labels = [name for name, _, _ in rec["host_spans"]]
    assert labels.count("pt.attention") == sum(conf["arch"]["enc_blocks"])
    assert labels.count("pt.down") == 4 and labels.count("pt.up") == 5
    values = [reader(name)(rec) for name in METRICS]
    assert all(v is not None and 0 < v <= 100 for v in values), values
    assert sum(values) <= 100 + 1e-9
    assert spans.seconds(rec, ("pt.attention", "pt.down", "pt.up")) == pytest.approx(
        sum(spans.seconds(rec, labels) for labels in (("pt.attention",), ("pt.down", "pt.up"))))
