"""The record a traced run hands each per-layer metric's reader: the span's
device times and the host's labelled intervals, the cell's files and the
shapes of its units, so that a new metric is a new reader and nothing
else."""

import importlib

import pytest

from benchmark import work
from benchmark.harness import common, runner, trace
from benchmark.tests.conftest import tiny
from benchmark.work import fps as fps_work


def _events():
    """A traced span: 32 spin kernels either side, two units labelled on
    the host, an FPS kernel and a GEMM in each, one host label that began
    before the span."""
    ev, t = [], 0.0
    for _ in range(trace.PAD_KERNELS):
        ev.append({"ph": "X", "cat": "kernel", "name": "spin_kernel", "ts": t, "dur": 1.0})
        t += 1.0
    lo = t
    ev.append({"ph": "X", "cat": "user_annotation", "name": "earlier", "ts": lo - 10.0,
               "dur": 15.0})
    for _ in range(2):
        ev.append({"ph": "X", "cat": "user_annotation", "name": "bench:cell", "ts": t,
                   "dur": 100.0})
        ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": t + 1.0, "dur": 5.0})
        ev.append({"ph": "X", "cat": "kernel", "name": "fps_kernel<16>", "ts": t + 10.0,
                   "dur": 40.0})
        ev.append({"ph": "X", "cat": "kernel", "name": "gemm", "ts": t + 60.0, "dur": 20.0})
        t += 100.0
    for _ in range(trace.PAD_KERNELS):
        ev.append({"ph": "X", "cat": "kernel", "name": "spin_kernel", "ts": t, "dur": 1.0})
        t += 1.0
    return ev, lo


def test_span_keeps_host_labels_and_launch_counts():
    events, lo = _events()
    record, why = trace.summarize(events, 2, uniform=True)
    assert why == "whole"
    assert record["kernel_calls"] == {"fps_kernel<16>": 2, "gemm": 2}
    spans = record["host_spans"]
    assert [name for name, _, _ in spans] == ["bench:cell", "bench:cell", "earlier"]
    assert [t for _, t, _ in spans] == pytest.approx([0.0, 100e-6, 0.0])
    assert [d for _, _, d in spans] == pytest.approx([100e-6, 100e-6, 5e-6])
    assert record["busy_s"] == pytest.approx(120e-6)


def _fps_roofline_from_units(record):
    """A reader of the kind a later metric adds: its work from the cell's
    configuration and the units' shapes, its time from the trace."""
    arch = record["spec"]["config"]["arch"]
    calls = common.named("work", record["spec"]["config"]["work"]["fps"])
    bound = sum(fps_work.bound_s(calls(arch, f["valid"], u["train"], u["votes"]))
                for u in record["units"] for f in u["forwards"])
    seconds = sum(s for n, s in record["kernel_s"].items() if "fps_kernel" in n)
    return 100.0 * bound / seconds if seconds > 0 and bound > 0 else None


def _host_ms_per_unit(record):
    spans = [d for name, _, d in record["host_spans"] if name.startswith("bench:")]
    return 1e3 * sum(spans) / len(spans) if spans else None


@pytest.mark.parametrize("cell", ["s3dis_scene_infer", "scanobjectnn_cls_serve"])
def test_readers_compute_from_the_record(cell):
    """A tiny run's window completed with a span's device times: every
    per-layer reader of the cell, and readers written only against the
    record, read a number."""
    spec = common.load_spec(cell)
    for key, values in tiny(cell).items():
        (spec.config["infer"] if key == "infer" else getattr(spec, key)).update(values)
    kind = importlib.import_module(f"benchmark.traffic.{spec.traffic['kind']}")
    state = kind.setup(runner.Context(spec, 2**31 + 5, "cpu"))
    cycle = kind.cycle(state) if hasattr(kind, "cycle") else 1
    records, window_s = runner.run_window(kind, state, 0.2, "bench:cell", cycle)
    assert len(records) % cycle == 0
    record, _ = trace.summarize(_events()[0], 1, uniform=False)
    runner.add_work(record, kind, state, spec, [len(records) - 1], len(records) - 1, window_s)
    assert record["spec"]["config"]["name"] == spec.config["name"]
    assert record["work"] == work.of_units(spec.config, record["units"])
    for m in spec.per_layer:
        reader = common.load_module(common.BENCH / "metrics" / f"{m['name']}.py", m["name"])
        value = reader.read(record)
        assert value is None or value > 0, m["name"]
    assert _fps_roofline_from_units(record) == pytest.approx(
        100.0 * record["work"]["fps_bound_s"] / 80e-6)
    assert _host_ms_per_unit(record) == pytest.approx(0.1)


def test_scene_units_count_real_points():
    """A room's forwards count each chunk's real points; the padded size
    is kept beside them for readers of the program's launches.  (Each voxel
    pass takes one point of every voxel, so a room's chunks hold
    min(voxels, voxel_max) points; here voxel_max is above the room's
    voxels, and the chunks are padded up to a multiple of 4,096.)"""
    cell = "s3dis_scene_infer"
    spec = common.load_spec(cell)
    for key, values in tiny(cell).items():
        (spec.config["infer"] if key == "infer" else getattr(spec, key)).update(values)
    spec.config["infer"]["voxel_max"] = 8192
    kind = importlib.import_module(f"benchmark.traffic.{spec.traffic['kind']}")
    state = kind.setup(runner.Context(spec, 2**31 + 6, "cpu"))
    unit = kind.shapes(state, 0)
    assert all(n < f["points"] for f in unit["forwards"] for n in f["valid"])
    padded = [{"points": f["points"], "valid": [f["points"]] * len(f["valid"])}
              for f in unit["forwards"]]
    real = work.of_units(spec.config, [unit])
    full = work.of_units(spec.config, [dict(unit, forwards=padded)])
    assert 0 < real["model_flops"] < full["model_flops"]
    assert 0 < real["fps_bound_s"] < full["fps_bound_s"]
