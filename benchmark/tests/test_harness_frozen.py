"""Each frozen copy in the benchmark equals the program's original today."""

import subprocess
import types

import numpy as np
import pytest

from benchmark.data import synthetic_object, synthetic_scene
from benchmark.harness import common, roofline, trace


def test_synthetic_room_and_labels():
    from repsurf_torch.data import synthetic_scene as orig

    a = synthetic_scene.synthetic_room(5000, rng=np.random.RandomState(11))
    b = orig.synthetic_room(5000, rng=np.random.RandomState(11))
    assert np.array_equal(a, b)
    assert np.array_equal(synthetic_scene.label_room(a, (8.0, 8.0, 3.0)),
                          orig.label_room(b, (8.0, 8.0, 3.0)))


def test_raw_room_is_synthetic_rooms_raw():
    from repsurf_torch.data.synthetic_scene import SyntheticRooms

    coord, rgb, label = synthetic_scene.raw_room(np.random.RandomState(21), 4000)
    raw = SyntheticRooms(raw_points=4000, seed=21).raw(0)
    assert np.array_equal(coord, raw[:, :3]) and np.array_equal(rgb, raw[:, 3:6])
    assert np.array_equal(label, raw[:, 6].astype(np.int64))


def test_synthetic_objects():
    from repsurf_torch.data.synthetic_object import SyntheticObjects15

    a = synthetic_object.SyntheticObjects15("test", size=20, seed=31)
    b = SyntheticObjects15("test", size=20, seed=31)
    for i in (0, 7, 19):
        assert np.array_equal(a[i][0], b[i][0]) and a[i][1] == b[i][1]


def test_bound_and_peaks():
    import chip_smoke

    assert (roofline.PEAK_F32_FLOPS, roofline.PEAK_BYTES_PER_S) == (
        chip_smoke.PEAK_F32_FLOPS, chip_smoke.PEAK_BYTES_PER_S)
    for work in ((1e9, 1e6), (1e3, 1e9), (0.0, 0.0)):
        assert roofline.bound(*work) == chip_smoke.bound(*work)


def test_card_fields(monkeypatch):
    from repsurf_torch import bench

    fake = types.SimpleNamespace(stdout="NVIDIA H100 80GB HBM3, 700.00 W\n")
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: fake)
    dev = types.SimpleNamespace(type="cuda", index=0)
    assert common.card_fields(0) == bench.card_fields(dev)


def test_checked_trace_arithmetic():
    """The span's device times and torn test read as the program's
    ``check_trace`` reads the same kernels."""
    from repsurf_torch.utils.profiling import check_trace

    kernels = [("fps_kernel<20>", 3, 40.0), ("gemm", 6, 10.0), ("elementwise", 5, 2.0)]
    events, t = [], 0.0
    for _ in range(trace.PAD_KERNELS):
        events.append({"ph": "X", "cat": "kernel", "name": "spin_kernel", "ts": t, "dur": 1.0})
        t += 1.0
    t += 5.0
    for name, count, dur in kernels:
        for _ in range(count):
            events.append({"ph": "X", "cat": "kernel", "name": name, "ts": t, "dur": dur})
            t += dur + 1.0
    for _ in range(trace.PAD_KERNELS):
        events.append({"ph": "X", "cat": "kernel", "name": "spin_kernel", "ts": t, "dur": 1.0})
        t += 1.0
    averaged = [types.SimpleNamespace(key="spin_kernel", count=2 * trace.PAD_KERNELS,
                                      self_device_time_total=64.0)]
    averaged += [types.SimpleNamespace(key=n, count=c, self_device_time_total=c * d)
                 for n, c, d in kernels]
    for reps in (1, 3):
        rows, torn, pads = check_trace(averaged, reps)
        record, why = trace.summarize(events, reps, uniform=True)
        assert (record is None) == bool(torn)
        if record is not None:
            assert record["kernel_s"] == pytest.approx({n: ms / 1e3 for n, ms, _ in rows})
            assert abs(record["busy_s"] - sum(ms for _, ms, _ in rows) / 1e3) < 1e-12
        assert pads == 2 * trace.PAD_KERNELS
