"""The readers of device time under the program's spans in a replayed
train step (``harness/graph_spans.py``)."""

import json

import pytest

from benchmark.harness import common, graph_spans

METRICS = {"pt_attention_device_pct.train": ("s3dis_pt_train", "model step"),
           "pt_transition_device_pct.train": ("s3dis_pt_train", "geometry and ops"),
           "pnx_aggregate_device_pct.train": ("s3dis_pnx_train", "model step"),
           "pnx_group_device_pct.train": ("s3dis_pnx_train", "geometry and ops")}
SECS = {"train.step": 0.25, "train.forward": 0.1, "pt.attention": 0.05, "pt.down": 0.01,
        "pt.up": 0.015, "pnx.aggregate": 0.04, "pnx.group": 0.01}
WANT = {"pt_attention_device_pct.train": 20.0, "pt_transition_device_pct.train": 10.0,
        "pnx_aggregate_device_pct.train": 16.0, "pnx_group_device_pct.train": 4.0}


def reader(name):
    return common.load_module(common.BENCH / "metrics" / f"{name}.py", name).read


@pytest.mark.parametrize("name", list(METRICS))
def test_the_metric_is_declared_for_its_cell(name):
    declared = {m["name"]: m for m in json.loads((common.REPO / "BENCHMARK.json").read_text())
                ["per_layer"]}
    cell, layer = METRICS[name]
    assert declared[name]["workloads"] == [cell]
    assert declared[name]["source"] == "program_span"
    assert declared[name]["moves"] == "train_samples_per_s"
    assert declared[name]["layer"] == layer


@pytest.mark.parametrize("name", list(METRICS))
def test_the_reader_shares_the_replayed_steps_device_time(name, monkeypatch):
    from repsurf_torch.train import step_graph

    monkeypatch.setattr(step_graph, "span_seconds", lambda: dict(SECS))
    assert reader(name)({}) == pytest.approx(WANT[name])


@pytest.mark.parametrize("secs", [{}, {"train.step": 0.2, "train.forward": 0.1},
                                  {"pt.attention": 0.1, "pnx.group": 0.1, "pt.up": 0.1,
                                   "pnx.aggregate": 0.1}],
                         ids=["no-replay", "no-model-spans", "no-step"])
@pytest.mark.parametrize("name", list(METRICS))
def test_the_reader_gives_none_when_nothing_was_timed(name, secs, monkeypatch):
    from repsurf_torch.train import step_graph

    monkeypatch.setattr(step_graph, "span_seconds", lambda: dict(secs))
    assert reader(name)({}) is None


@pytest.mark.parametrize("name", list(METRICS))
def test_a_program_without_span_seconds_gives_none(name, monkeypatch):
    from repsurf_torch.train import step_graph

    monkeypatch.delattr(step_graph, "span_seconds")
    assert graph_spans.seconds() == {}
    assert reader(name)({}) is None


def test_on_the_cpu_nothing_is_timed():
    assert graph_spans.seconds() == {}
    assert graph_spans.share_pct(("pt.attention",)) is None
