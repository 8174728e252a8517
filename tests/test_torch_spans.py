"""The port's spans (``utils/spans.py``) as a ``torch.profiler`` trace shows
them, on the CPU: a room's host stages, a train step's forward, backward
and update, PointNeXt's aggregations and block MLPs, a served request's
sample and forwards; and that the helper
enters no ``record_function`` while nothing records."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repsurf_torch.cli import test_s3dis as s3dis_cli
from repsurf_torch.data.synthetic_scene import SyntheticRooms
from repsurf_torch.models import SEG_RECIPES, get_model
from repsurf_torch.train import eval_s3dis as te
from repsurf_torch.train import train_cls as ttc
from repsurf_torch.train import train_seg as tts
from repsurf_torch.utils import spans

torch.set_num_threads(1)

NUM_CLASS = 13
VOXEL_SIZE, VOXEL_MAX, BATCH = 0.1, 512, 2
CLS_NARROW = dict(sa_npoint=(32, 8), sa_nsample=(8, 16), sa_mlp=((8, 8, 16), (16, 16, 32)),
                  final_mlp=(32, 32, 64), head_hidden=(32, 16))
SEG_NARROW = dict(sa_mlp=((8, 8, 16), (16, 16, 32), (32, 32, 32), (32, 32, 64)),
                  fp_mlp=((32, 32), (32, 32), (32, 16), (16, 16, 16)))


def traced(fn, tmp_path):
    """(fn(), the trace's program spans as (name, start us, end us) in
    order of start), from a CPU profiler's exported Chrome trace."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    found = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return out, sorted(found, key=lambda s: s[1])


def named(found, name):
    return [s for s in found if s[0] == name]


def inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def room():
    """A raw room of 3,000 points: coord, rgb."""
    data = SyntheticRooms("val", n_rooms=1, raw_points=3000, seed=3).raw(0)
    return data[:, :3], data[:, 3:6]


def zero_logits(batch):
    coord = batch["coord"]
    return torch.zeros(coord.shape[0], coord.shape[1], NUM_CLASS)


def scene_votes(accumulate):
    coord, feat = room()
    return te.scene_votes(zero_logits, coord, feat, NUM_CLASS, voxel_size=VOXEL_SIZE,
                          voxel_max=VOXEL_MAX, batch_size=BATCH, accumulate=accumulate,
                          device="cpu")


@pytest.mark.parametrize("accumulate", ["host", "device"])
def test_a_room_spans_its_host_stages_and_each_batch(accumulate, tmp_path):
    coord, feat = room()
    passes = te.voxel_passes(coord, VOXEL_SIZE)
    chunks = te.chunk_scene(coord, feat, passes, VOXEL_MAX, seed=1000)[0]
    crops = len(chunks) - sum(p.size <= VOXEL_MAX for p in passes)
    batches = te.scene_batches(coord, feat, VOXEL_SIZE, VOXEL_MAX, BATCH)
    assert crops > len(passes) and len(batches) > 1

    votes, found = traced(lambda: scene_votes(accumulate), tmp_path)
    (prepare,) = named(found, "scene.prepare")
    for stage in ("scene.voxel_passes", "scene.chunk", "scene.pad"):
        (s,) = named(found, stage)
        assert inside(s, prepare), stage
    (chunk,) = named(found, "scene.chunk")
    assert len(named(found, "scene.crop")) == crops
    assert all(inside(s, chunk) for s in named(found, "scene.crop"))
    for stage in ("scene.upload", "scene.forward", "scene.vote"):
        assert len(named(found, stage)) == len(batches), stage
        assert all(s[1] >= prepare[2] for s in named(found, stage)), stage
    np.testing.assert_array_equal(np.asarray(votes), np.asarray(scene_votes(accumulate)))


def seg_step():
    cfg = tts.SegConfig()
    model = get_model("repsurf.repsurf_umb_ssg", head_dropout=0.0, random_inv=False,
                      generator=torch.Generator().manual_seed(0), **SEG_NARROW)
    rs = np.random.RandomState(1)
    batch = {"coord": torch.from_numpy(rs.rand(2, 1024, 3).astype(np.float32)),
             "feat": torch.from_numpy(rs.rand(2, 1024, 3).astype(np.float32)),
             "label": torch.from_numpy(rs.randint(0, NUM_CLASS, (2, 1024))),
             "valid": torch.tensor([1024, 900], dtype=torch.int32)}
    weight = torch.ones(NUM_CLASS)
    optimizer = tts.make_optimizer(model, cfg)
    return lambda: tts.train_step(model, optimizer, batch, weight, cfg)


def cls_model():
    return get_model("repsurf.repsurf_ssg_umb", generator=torch.Generator().manual_seed(0),
                     **CLS_NARROW)


def cls_points():
    rs = np.random.RandomState(2)
    return torch.from_numpy((rs.rand(4, 128, 3) * 2 - 1).astype(np.float32))


def cls_step():
    cfg = ttc.ClsConfig(num_point=64, batch_size=4)
    model = cls_model()
    optimizer = ttc.make_optimizer(model, cfg)
    target = torch.tensor([0, 1, 2, 3])
    return lambda: ttc.train_step(model, optimizer, cls_points(), target, cfg,
                                  generator=torch.Generator().manual_seed(5))


@pytest.mark.parametrize("step", [seg_step, cls_step], ids=["seg", "cls"])
def test_train_steps_span_forward_backward_update_in_order(step, tmp_path):
    _, found = traced(step(), tmp_path)
    train = [s for s in found if s[0].startswith("train.")]
    assert [s[0] for s in train] == ["train.forward", "train.backward", "train.update"]
    assert all(a[2] <= b[1] for a, b in zip(train, train[1:]))


def test_a_pointnext_step_spans_each_aggregation_its_group_and_each_block_mlp(tmp_path):
    """A PointNeXt train step: ``pnx.aggregate`` once a local aggregation
    (a set abstraction's or a block's, 2 + 1 here), each holding one
    ``pnx.group`` and no ``pnx.mlp``; ``pnx.mlp`` once an inverted-residual
    block, after its aggregation; all inside ``train.forward``."""
    cfg = tts.SegConfig(model="pointnext.pointnext_xl",
                        **SEG_RECIPES["pointnext.pointnext_xl"])
    model = get_model(cfg.model, generator=torch.Generator().manual_seed(0), width=8,
                      blocks=(1, 2, 1), strides=(1, 4, 4))
    rs = np.random.RandomState(1)
    batch = {"coord": torch.from_numpy(rs.rand(2, 512, 3).astype(np.float32)),
             "feat": torch.from_numpy(rs.rand(2, 512, 3).astype(np.float32)),
             "label": torch.from_numpy(rs.randint(0, NUM_CLASS, (2, 512))),
             "valid": torch.tensor([512, 400], dtype=torch.int32)}
    optimizer = tts.make_optimizer(model, cfg)
    _, found = traced(lambda: tts.train_step(model, optimizer, batch, torch.ones(NUM_CLASS),
                                             cfg, generator=torch.Generator().manual_seed(2)),
                      tmp_path)
    aggregate, group, mlp = (named(found, n) for n in ("pnx.aggregate", "pnx.group",
                                                          "pnx.mlp"))
    assert (len(aggregate), len(group), len(mlp)) == (3, 3, 1)
    assert [sum(inside(g, a) for g in group) for a in aggregate] == [1, 1, 1]
    assert not any(inside(m, a) for m in mlp for a in aggregate)
    assert aggregate[1][2] <= mlp[0][1]  # the block's aggregation, then its MLP
    forward = named(found, "train.forward")
    assert all(inside(s, forward[0]) for s in aggregate + group + mlp)


def test_a_request_spans_its_sample_and_each_vote(tmp_path):
    cfg = ttc.ClsConfig(num_point=64, batch_size=4, num_votes=3)
    model = cls_model().eval()
    target = torch.tensor([0, 1, 2, 3])
    _, found = traced(lambda: ttc.eval_step(model, cls_points(), target, cfg,
                                            generator=torch.Generator().manual_seed(6)),
                      tmp_path)
    serve = [s for s in found if s[0].startswith("serve.")]
    assert [s[0] for s in serve] == ["serve.sample"] + ["serve.forward"] * cfg.num_votes
    assert all(a[2] <= b[1] for a, b in zip(serve, serve[1:]))


def test_a_span_enters_record_function_only_while_a_profiler_records(monkeypatch):
    entered = []

    def record_function(name):
        entered.append(name)
        return spans._NULL

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    assert spans.span("scene.prepare") is spans._NULL
    assert spans.span("train.update") is spans.span("serve.forward")
    with spans.span("scene.crop"):
        pass
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        spans.span("scene.crop")
    assert entered == ["scene.crop"]


class _ClockEvent:
    """Stands in for a CUDA timing event on the CPU: ``record`` reads a
    clock that each record advances by 1 ms."""

    clock = 0

    def __init__(self, enable_timing=False, external=False):
        assert enable_timing and external
        self.at = None

    def record(self):
        _ClockEvent.clock += 1
        self.at = _ClockEvent.clock

    def synchronize(self):
        assert self.at is not None

    def elapsed_time(self, end):
        return float(end.at - self.at)


def test_spans_inside_timing_record_event_pairs(monkeypatch):
    """Inside ``timing()`` a span records a pair of timing events, in the
    list in the order the spans open, nested ones too; outside it, even
    with the list kept, spans are as before.  ``device_seconds`` sums each
    name's pairs."""
    monkeypatch.setattr(torch.cuda, "Event", _ClockEvent)
    with spans.timing() as timed:
        with spans.span("pnx.aggregate"):       # clock 1 .. 4
            with spans.span("pnx.group"):       # 2 .. 3
                pass
        with spans.span("pnx.aggregate"):       # 5 .. 8
            with spans.span("pnx.group"):       # 6 .. 7
                pass
    assert [t.name for t in timed] == ["pnx.aggregate", "pnx.group"] * 2
    assert spans.span("pnx.group") is spans._NULL
    assert spans.device_seconds(timed) == {"pnx.aggregate": pytest.approx(6e-3),
                                           "pnx.group": pytest.approx(2e-3)}
    assert spans.device_seconds([]) == {}


def test_test_s3dis_profile_traces_the_first_scene(tmp_path, capsys):
    argv = ["--synthetic", "--synthetic_rooms", "2", "--synthetic_raw", "2000",
            "--voxel_max", "1024", "--device", "cpu", "--profile",
            "--log_root", str(tmp_path / "log")]
    s3dis_cli.main(argv)
    logs = tmp_path / "log" / "S3DIS" / "default" / "logs"
    (trace,) = logs.glob("trace_*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert names.count("scene.prepare") == 1  # the first of the two scenes
    assert "scene.forward" in names and "scene.voxel_passes" in names
    assert "profiler trace of scene 1" in (logs / "test_s3dis.txt").read_text()
    capsys.readouterr()
