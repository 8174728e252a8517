"""The PointNeXt cell, ``s3dis_pnx_train``: its crops (shapes, and a
density that fills a ball as S3DIS's 0.04 voxels do), its analytic work
against torch's FLOP counter and the program's FPS calls, a whole run at a
tiny size on the CPU that comes out correct, and not correct when the timed
path trains on half of each batch, leaves the weights unchanged, or when
the control (TF32 products) stands in for the program; the readers of its
two span metrics on hand-made records and on the program's own CPU
trace."""

import copy
import importlib
import json
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from benchmark.data.synthetic_scene import raw_room
from benchmark.harness import common, program, runner, spans, trace, training
from benchmark.reference import models
from benchmark.reference import pointnext as ref
from benchmark.traffic import seg_crop_train
from benchmark.work import fps as fps_work
from benchmark.work import pointnext as pnx_work

CELL = "s3dis_pnx_train"
METRICS = ("pnx_aggregate_pct.train", "pnx_group_pct.train")
CONF = common.load_spec(CELL).config
NARROW = {"width": 8}

# The cell shrunk to two crops of 2,048 points (the program's plain path).
# As for the other training cells (conftest.TINY), three AdamW steps at this
# size amplify rounding far more than at the cell's own, so the run gets
# limits of its own, set as the cell's are: 15 seeds of sound tiny runs on
# the CPU read loss, gradient and change gaps of at most 1.4e-2, 1.3e-3,
# 3.2e-2; the control (TF32 products, 5 seeds) at least 9.3e-3, 0.14,
# 2.5e-2; half of each batch at least 5.0e-2, 1.2, 0.30; a state left
# unchanged reads 1.  The gradient's gap separates them; the loss's and the
# change's cannot hold the control at this size.
TINY = {"traffic": {"batch": 2, "points": 2048},
        "cell": {"limits": {"loss_gap": 3e-2, "grad_gap": 1e-2, "change_gap": 0.1}}}


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
    reference = kind.reference(state)
    ctl = kind.reference(state, prec=models.Precision(tf32=True))
    assert any(v > lim for _, v, lim in training.checks(ctl, reference, spec.cell["limits"]))


# -- the crops -------------------------------------------------------------

class _Ctx:
    def __init__(self, **traffic):
        self.traffic = {**common.load_spec(CELL).traffic, **traffic}
        self.config = CONF
        self.seeds = common.Seeds.of(2**31 + 5)


def test_the_pool_holds_aligned_crops():
    pool = seg_crop_train.make_pool(_Ctx(batch=2, pool=2, points=4096))
    assert len(pool) == 2
    for b in pool:
        assert b["coord"].shape == (2, 4096, 3) and b["coord"].dtype == np.float32
        assert b["feat"].shape == (2, 4096, 3) and b["feat"].dtype == np.float32
        assert b["label"].shape == (2, 4096) and b["label"].dtype == np.int64
        assert b["valid"].tolist() == [4096, 4096]
        # x and y centred, z from the crop's lowest point
        assert np.abs(b["coord"][..., :2].mean(1)).max() < 1e-4
        assert (b["coord"][..., 2].min(1) == 0).all()
        assert np.isfinite(b["feat"]).all() and b["feat"].std() > 0
    # each crop is a different place of a different room
    assert not np.array_equal(pool[0]["coord"][0], pool[0]["coord"][1])


def _median_ball(coord, radius, queries=2000):
    """Median count of points within ``radius`` of the first ``queries``
    points of one cloud."""
    c = torch.from_numpy(coord)
    d2 = torch.cdist(c[:queries].double(), c.double()).square()
    return float((d2 <= radius ** 2).sum(1).double().median())


def test_a_crop_fills_a_ball_as_voxels_of_0_04_do():
    """At 0.04 voxels a ball of radius 0.1 holds 10-32 points (fewer than
    the 32 it takes, so most balls are short and searched to the end); a
    whole room of 24,000 points, as the 80,000-point cells sample theirs,
    holds 3-6."""
    rng = np.random.RandomState(3)
    coord, _, _ = seg_crop_train.crop(rng, *raw_room(rng, 220000), 24000, 0.04)
    assert 10 <= _median_ball(coord, 0.1) <= 32
    room, _, _ = raw_room(rng, 24000)
    assert _median_ball(room, 0.1) < 10


def test_voxel_first_keeps_the_first_point_of_each_voxel():
    coord = np.array([[0.01, 0.0, 0.0], [0.05, 0.0, 0.0], [0.02, 0.01, 0.0], [0.3, 0.3, 0.3],
                      [0.06, 0.0, 0.0]], np.float32)
    assert seg_crop_train.voxel_first(coord, 0.04).tolist() == [0, 1, 3]


# -- the analytic work -------------------------------------------------------

def _model(seed, **arch):
    from repsurf_torch.models import get_model

    net = get_model(CONF["model"], **NARROW, **arch)
    return program.init_weights(net, seed, CONF["init"]["weight_gain"], torch.device("cpu"))


def _clouds(seed, n=1024):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(2, n, 3, generator=g) * 2, torch.rand(2, n, 3, generator=g)


def counted(fn):
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("valid", [(1024, 1024), (1024, 700)], ids=["full", "padded"])
def test_flops_match_flop_counter_on_the_reference(valid):
    """Every Linear of the reference counted, each cloud at its own size
    (its rows at each stage valid // 4): a cloud's forward alone reads what
    ``pnx_flops`` counts for it."""
    arch = {**CONF["arch"], **NARROW}
    start = program.snapshot(_model(7))
    coord, feat = _clouds(5)

    def alone(b, v):
        c, f = coord[b:b + 1, :v], feat[b:b + 1, :v]
        plan = ref.pnx_plan(arch, c, None, train=False)
        return counted(lambda: ref.pnx_forward(start, arch, plan, f, False))

    assert sum(alone(b, v) for b, v in enumerate(valid)) == pnx_work.pnx_flops(arch, list(valid))


def test_flops_match_flop_counter_on_the_program():
    arch = {**CONF["arch"], **NARROW}
    net = _model(7).eval()
    coord, feat = _clouds(5)
    assert counted(lambda: net(coord, feat, torch.tensor([1024, 1024]))) == \
        pnx_work.pnx_flops(arch, [1024, 1024])


def test_flops_at_the_published_widths():
    """135.05 GFLOPs a forward of 24,000 points, 80 % of them in the 19
    aggregations; 84.33 at the 15,000 points of the paper's table (84.8)."""
    arch = CONF["arch"]
    assert pnx_work.pnx_flops(arch, [24000]) == 135054876672
    assert abs(pnx_work.pnx_flops(arch, [15000]) / 84.8e9 - 1) < 0.01


def test_fps_calls_are_the_programs(monkeypatch):
    """The FPS calls the program makes in a training forward, each cloud at
    its real size, against ``pnx_fps_calls``."""
    import repsurf_torch.nn.blocks as blocks

    made, real = [], blocks.farthest_point_sample

    def recorded(xyz, npoint, valid=None):
        made.append(fps_work.call([(int(v), int(v) // 4) for v in valid]))
        return real(xyz, npoint, valid=valid)

    monkeypatch.setattr(blocks, "farthest_point_sample", recorded)
    net = _model(3).train()
    coord, feat = _clouds(4)
    valid = (1024, 900)
    with torch.no_grad():
        net(coord, feat, torch.tensor(valid), generator=torch.Generator().manual_seed(0))
    assert made == pnx_work.pnx_fps_calls(CONF["arch"], list(valid), train=True)
    assert len(made) == 4


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.pointnext, "
            "benchmark.work.pointnext, benchmark.traffic.seg_crop_train; print(sorted("
            "{m.split('.')[0] for m in sys.modules} & {'repsurf_torch', 'repsurf_tpu', 'jax', "
            "'jaxlib', 'flax'}))" % str(common.REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


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
    assert declared["pnx_aggregate_pct.train"]["layer"] == "model step"
    assert declared["pnx_group_pct.train"]["layer"] == "geometry and ops"
    for name in ("train_samples_per_s",):
        entry = next(m for m in json.loads((common.REPO / "BENCHMARK.json").read_text())
                     ["end_to_end"] if m["name"] == name)
        assert CELL in entry["workloads"]
    for name in ("device_idle_pct.train", "mfu_pct.train", "fps_roofline_pct.train"):
        assert CELL in declared[name]["workloads"]
    assert CELL not in declared["host_issue_pct.train"]["workloads"]


def test_readers_on_a_hand_made_record():
    rec = record([
        ["bench:s3dis_pnx_train", 0.0, 1.0], ["train.forward", 0.0, 0.6],
        ["pnx.aggregate", 0.1, 0.1], ["pnx.group", 0.1, 0.04], ["pnx.aggregate", 0.3, 0.05],
        ["pnx.group", 0.3, 0.01], ["pnx.mlp", 0.35, 0.02], ["aten::mm", 0.11, 0.01],
    ], window_s=2.0)
    assert reader("pnx_aggregate_pct.train")(rec) == pytest.approx(100 * 0.15 / 2.0)
    assert reader("pnx_group_pct.train")(rec) == pytest.approx(100 * 0.05 / 2.0)


@pytest.mark.parametrize("host_spans", [[], [["bench:s3dis_pnx_train", 0.0, 1.0],
                                             ["train.forward", 0.0, 0.5],
                                             ["aten::mm", 0.1, 0.2]]],
                         ids=["empty", "no-pnx-spans"])
def test_readers_give_none_without_the_spans(host_spans):
    """The parent of these spans has none of them: the metric is left out,
    never read as 0."""
    for name in METRICS:
        assert reader(name)(record(host_spans)) is None, name


def test_readers_give_none_for_an_empty_span():
    for name in METRICS:
        assert reader(name)(record([["pnx.aggregate", 0.0, 0.1], ["pnx.group", 0.0, 0.1]],
                                   window_s=0.0)) is None, name


def test_readers_on_the_programs_own_spans(tmp_path):
    """A CPU trace of the program's PointNeXt forward, between the harness's
    labels: both readers find their spans (19 aggregations at the published
    depth), the group's share within the aggregation's."""
    from benchmark.tests.test_harness_spans import padded

    net = _model(0).eval()
    coord, feat = _clouds(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        with torch.profiler.record_function("bench:cell"):
            net(coord, feat, torch.tensor([1024, 1024]))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    rec, why = trace.summarize(padded(json.loads(path.read_text())["traceEvents"]), 1,
                               uniform=False)
    assert why == "whole"
    labels = [name for name, _, _ in rec["host_spans"]]
    blocks = CONF["arch"]["blocks"]
    assert labels.count("pnx.aggregate") == labels.count("pnx.group") == sum(blocks) - 1 == 19
    assert labels.count("pnx.mlp") == sum(blocks) - len(blocks) == 15
    aggregate, group = (reader(name)(rec) for name in METRICS)
    assert 0 < group < aggregate <= 100
    assert spans.seconds(rec, ("pnx.aggregate", "pnx.group")) == pytest.approx(
        spans.seconds(rec, ("pnx.aggregate",)))
