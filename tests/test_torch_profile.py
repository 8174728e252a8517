"""The checked-trace helpers (``repsurf_torch.utils.profiling``) and the
profiling CLIs (``cli/profile_seg``, ``cli/profile_cls``,
``cli/knn_window_stats``) on the CPU: the torn-trace detection on fake
``key_averages()`` lists, the retakes and the NaN after the last try, the
CPU tables, and each CLI at tiny widths."""

import math
from types import SimpleNamespace

import pytest
import torch

from repsurf_torch.cli import knn_window_stats, profile_cls, profile_seg
from repsurf_torch.models import _REGISTRY, RepSurfClassifier, RepSurfSegmentor
from repsurf_torch.utils import profiling

from .test_torch_model import NARROW as CLS_NARROW
from .test_torch_seg import NARROW as SEG_NARROW

torch.set_num_threads(1)


def ev(key, count, ms):
    """A fake averaged event: ``ms`` of device self time over ``count`` calls."""
    return SimpleNamespace(key=key, count=count, self_device_time_total=ms * 1e3,
                           self_cpu_time_total=0.0)


@pytest.fixture
def fresh_profiler(monkeypatch):
    """Counters of this test only, and no pause between retakes."""
    monkeypatch.setattr(profiling, "PROFILER", dict.fromkeys(profiling.PROFILER, 0))
    profiling.PROFILER["silent"] = False
    monkeypatch.setattr(profiling.time, "sleep", lambda s: None)
    return profiling.PROFILER


@pytest.fixture
def narrow(monkeypatch):
    monkeypatch.setitem(_REGISTRY, "repsurf.repsurf_ssg_umb",
                        lambda num_class=15, **kw: RepSurfClassifier(num_class, **kw,
                                                                     **CLS_NARROW))
    monkeypatch.setitem(_REGISTRY, "repsurf.repsurf_umb_ssg",
                        lambda num_class=13, **kw: RepSurfSegmentor(num_class, **kw,
                                                                    **SEG_NARROW))


def test_check_trace_finds_torn_events_and_skips_spin_kernels():
    events = [ev("void spin_kernel(long)", 64, 5.0), ev("fps_kernel", 6, 3.0),
              ev("knn_kernel", 5, 1.0), ev("memset (idle)", 7, 0.0)]
    rows, torn, pads = profiling.check_trace(events, reps=3)
    assert pads == 64
    assert [r[0] for r in rows] == ["fps_kernel", "knn_kernel"]  # no spin, no zero time
    assert torn == ["knn_kernel x5"]  # 5 calls is not a multiple of 3


def test_check_trace_reads_cpu_self_time():
    e = SimpleNamespace(key="aten::mm", count=4, self_device_time_total=0.0,
                        self_cpu_time_total=2500.0)
    rows, torn, _ = profiling.check_trace([e], reps=2, cpu=True)
    assert rows == [("aten::mm", 2.5, 4)] and torn == []


def test_empty_trace_is_retaken(fresh_profiler, monkeypatch):
    traces = iter([[], [ev("fps_kernel", 4, 2.0), ev("void spin_kernel", 64, 1.0)]])
    monkeypatch.setattr(profiling, "_take_trace", lambda fn, reps, cpu: (next(traces), 0.01))
    monkeypatch.setattr(profiling.torch.cuda, "synchronize", lambda: None)
    rows, wall = profiling.checked_trace(lambda: None, reps=2)
    assert rows == [("fps_kernel", 2.0, 4)] and wall == 0.01
    assert fresh_profiler["traces"] == 2 and fresh_profiler["retaken"] == 1
    assert fresh_profiler["pads_lost"] == 2 * profiling.PAD_KERNELS + 0  # the empty one


def test_no_whole_trace_gives_nan_then_one_try(fresh_profiler, monkeypatch):
    calls = []

    def torn(fn, reps, cpu):
        calls.append(1)
        return [ev("fps_kernel", 3, 2.0)], 0.01

    monkeypatch.setattr(profiling, "_take_trace", torn)
    monkeypatch.setattr(profiling.torch.cuda, "synchronize", lambda: None)
    split = profiling.device_split(lambda: None, {"fps": "fps_kernel"}, reps=2)
    assert all(math.isnan(v) for v in split.values()) and set(split) == {"fps", "other"}
    assert len(calls) == profiling.PROFILE_TRIES and fresh_profiler["silent"]
    assert fresh_profiler["given_up"] == 1
    table = profiling.op_table(lambda: None, reps=2)  # silent: one try only
    assert len(calls) == profiling.PROFILE_TRIES + 1
    assert table.rows is None and math.isnan(table.busy_ms)
    assert "not measured" in table.lines("x")[0]


def _work():
    a = torch.ones(64, 64)
    return (a @ a).sum() + torch.relu(a).mean()


def test_device_split_on_the_cpu(fresh_profiler):
    split = profiling.device_split(_work, {"mm": "aten::mm"}, reps=3, device="cpu")
    assert split["mm"] > 0 and split["other"] > 0
    assert fresh_profiler["traces"] == 1 and fresh_profiler["pads_lost"] == 0


def test_op_table_on_the_cpu(fresh_profiler):
    table = profiling.op_table(_work, reps=4, device="cpu")
    assert table.activity == "cpu"
    ms = [r[1] for r in table.rows]
    assert ms == sorted(ms, reverse=True) and "aten::mm" in [r[0] for r in table.rows]
    assert table.busy_ms == pytest.approx(sum(ms))
    assert all(r[2] == int(r[2]) for r in table.rows)  # whole calls a rep
    lines = table.lines("work", top=2)
    assert "CPU" in lines[0] and "idle share" in lines[0] and len(lines) == 3
    assert len(profiling.op_table(_work, reps=2, top=1, device="cpu").rows) == 1


def test_not_measured_as_null():
    assert profiling.not_measured_as_null({"a": [math.nan, 1.0], "b": math.nan}) == {
        "a": [None, 1.0], "b": None}


def test_difference_keeps_positive_rows():
    a = profiling.OpTable("cuda", [("x", 3.0, 2.0), ("y", 1.0, 1.0)], 4.0, 10.0)
    b = profiling.OpTable("cuda", [("y", 1.5, 1.0), ("x", 1.0, 1.0)], 2.5, 6.0)
    d = profile_seg.difference(a, b)
    assert d.rows == [("x", 2.0, 1.0)] and d.busy_ms == 2.0 and math.isnan(d.wall_ms)
    assert "idle share" not in d.lines("d")[0]


def test_profile_seg_prints_tables(narrow, fresh_profiler, monkeypatch, capsys):
    monkeypatch.setattr(profile_seg, "SCENE_REPS", 1)
    tables = profile_seg.main(["--steps", "1", "--top", "5", "--points", "1024", "--fwd",
                               "--scene", "1000", "--device", "cpu"])
    out = capsys.readouterr().out
    assert set(tables) == {"train", "forward", "train minus forward", "scene"}
    assert all(t.rows for t in tables.values())
    for label in ("== train step:", "== eval forward:", "== train step minus eval forward",
                  "== whole scene (predict_scene, 1000 raw points):"):
        assert label in out
    assert "train step (queued x1)" in out and "first step" in out


def test_profile_cls_ops_prints_a_table(narrow, fresh_profiler, monkeypatch, capsys):
    monkeypatch.setattr(profile_cls, "OPS_QUEUED", 2)
    monkeypatch.setattr(profile_cls, "OPS_REPS", 2)  # the CPU trace of FPS's loop is slow
    table = profile_cls.main(["--ops", "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert table.rows and "clouds/s" in out and "== cls eval pipeline:" in out


def test_profile_cls_stage_rows(narrow, monkeypatch, capsys):
    monkeypatch.setattr(profile_cls, "QUEUED", 2)
    monkeypatch.setattr(profile_cls, "PER_CALL", 2)
    rows = profile_cls.main(["--batch", "2", "--device", "cpu"])
    assert len(rows) == 15 and all(ms > 0 for ms in rows.values())
    assert any("no group_by_umbrella" in label for label in rows)


def test_knn_window_stats_sites(capsys):
    sites = knn_window_stats.main(["--points", "2048", "--device", "cpu"])
    assert [label.split()[0] for label, _ in sites] == ["umbrella", "sa1", "sa2", "fp1"]
    assert all(resolved is None for _, resolved in sites)  # no guard on the CPU
    assert "2048->512" in capsys.readouterr().out
