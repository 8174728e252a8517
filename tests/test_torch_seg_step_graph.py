"""The segmentation train step's CUDA graph (``train_seg.train_step``
through ``train/step_graph.py``) on the CPU, with the capture stubbed as
``test_torch_step_graph.py`` stubs it (a stub graph runs the step when
replayed): replays equal to the eager steps in loss, IoU counts, parameters
and AdamW state; the key; a failed capture; the launch counters.  Each
test runs a narrow ``repsurf.repsurf_umb_ssg`` and a narrow Point
Transformer.

No JAX here: the port's step is held to its own eager step.
"""

import collections
import dataclasses
import warnings

import pytest
import torch

from repsurf_torch.models import get_model
from repsurf_torch.train import optim, step_graph
from repsurf_torch.train import train_seg as tts

torch.set_num_threads(1)

N, K = 1024, 13
MODELS = {
    "repsurf.repsurf_umb_ssg": dict(
        sa_mlp=((8, 8, 16), (16, 16, 32), (32, 32, 32), (32, 32, 64)),
        fp_mlp=((32, 32), (32, 32), (32, 16), (16, 16, 16))),
    "pointtransformer.pointtransformer": dict(planes=(16, 16, 32, 32, 64),
                                              enc_blocks=(1, 2, 2, 2, 2)),
}


def _leaves(nest):
    if isinstance(nest, torch.Tensor):
        return [nest]
    return [x for v in nest for x in _leaves(v)]


class _StubGraph:
    """Stands in for a captured graph on the CPU: a replay runs the
    captured function and writes its outputs into the static ones."""

    def __init__(self, fn, outputs):
        self.fn, self.outputs = fn, outputs

    def replay(self):
        for static, value in zip(_leaves(self.outputs), _leaves(self.fn())):
            static.copy_(value)


def _static_outputs():
    return torch.zeros(()), tuple(torch.zeros(K) for _ in range(3))


def _stub_capture(fn, generator, device):
    outputs = _static_outputs()
    return _StubGraph(fn, outputs), outputs, []


@pytest.fixture
def graphed(monkeypatch):
    """The graph path on the CPU: every step graphable, the warm-up on the
    current stream, the capture stubbed; the counts from zero."""
    monkeypatch.setattr(step_graph, "graphable", lambda inputs, optimizer: True)
    monkeypatch.setattr(step_graph, "_warm", lambda fn, device: fn())
    monkeypatch.setattr(step_graph, "_capture", _stub_capture)
    monkeypatch.setattr(step_graph, "counts", {"captures": 0, "replays": 0, "eager": 0})
    return step_graph


class _Generator(torch.Generator):
    """A CPU generator with the graph-safe state calls a CUDA generator has
    (``step_graph`` restores the generator after a failed capture)."""

    def clone_state(self):
        return self.get_state()

    def graphsafe_set_state(self, state):
        self.set_state(state)


def _model(name, seed=0):
    return get_model(name, generator=torch.Generator().manual_seed(seed), **MODELS[name])


def _batches(n, seed=0, points=N):
    """Batches of two clouds, the second padded, a few labels ignored."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        label = torch.randint(0, K, (2, points), generator=g)
        label[:, ::13] = 255
        out.append({"coord": torch.rand(2, points, 3, generator=g) * 2 - 1,
                    "feat": torch.rand(2, points, 3, generator=g),
                    "label": label,
                    "valid": torch.tensor([points, points - points // 5], dtype=torch.int32)})
    return out


def _weights(n, seed=0):
    g = torch.Generator().manual_seed(seed + 50)
    return [torch.rand(K, generator=g) + 0.5 for _ in range(n)]


def _run(step, name, batches, weights, cfg=None, freeze=False, seed=1):
    cfg = tts.SegConfig(model=name) if cfg is None else cfg
    model = _model(name)
    opt = tts.make_optimizer(model, cfg)
    gen = _Generator().manual_seed(seed)
    out = [step(model, opt, b, w, cfg, generator=gen, freeze=freeze)
           for b, w in zip(batches, weights)]
    return model, opt, gen, out


def _assert_same(a, b):
    """Losses and IoU counts, parameters and buffers, AdamW's moments and
    step counts, and the generators' states equal."""
    (ma, oa, ga, outs_a), (mb, ob, gb, outs_b) = a, b
    for x, y in zip(outs_a, outs_b):
        assert all(torch.equal(u, v) for u, v in zip(_leaves(x), _leaves(y)))
    sb = mb.state_dict()
    for k, v in ma.state_dict().items():
        assert torch.equal(v, sb[k]), k
    for pa, pb in zip(ma.parameters(), mb.parameters()):
        sa, st = oa.state[pa], ob.state[pb]
        assert sa.keys() == st.keys()
        assert all(torch.equal(sa[k], st[k]) for k in sa)
    assert torch.equal(ga.get_state(), gb.get_state())


@pytest.mark.parametrize("freeze", [False, True])
@pytest.mark.parametrize("name", list(MODELS))
def test_graph_replays_equal_the_eager_steps(graphed, name, freeze):
    """One eager step, one capture, then replays through the static
    buffers (each batch with class weights of its own): the losses, IoU
    counts, parameters, AdamW state and generator of the eager steps."""
    batches, weights = _batches(4), _weights(4)
    got = _run(tts.train_step, name, batches, weights, freeze=freeze)
    assert graphed.counts == {"captures": 1, "replays": 3, "eager": 1}
    want = _run(tts.eager_step, name, batches, weights, freeze=freeze)
    _assert_same(got, want)
    losses = [float(loss) for loss, _ in got[3]]
    assert len(set(losses)) == len(losses)  # copies, never the graph's buffers
    assert all(float(counts[2].sum()) > 0 for _, counts in got[3])


@pytest.mark.parametrize("change", ["same", "class_weight_values", "freeze", "cfg", "shape",
                                    "class_weight_layout", "lr"])
@pytest.mark.parametrize("name", list(MODELS))
def test_graph_key(graphed, name, change):
    """The same key reuses its capture, also with new class weights of the
    same layout; a new freeze, configuration, batch shape, class-weight
    layout or learning rate makes a new one, itself after one eager step."""
    cfg = tts.SegConfig(model=name)
    model = _model(name)
    opt = tts.make_optimizer(model, cfg)
    gen = torch.Generator().manual_seed(1)
    (w,) = _weights(1)
    for b in _batches(2, points=512):
        tts.train_step(model, opt, b, w, cfg, generator=gen)
    assert graphed.counts == {"captures": 1, "replays": 1, "eager": 1}
    (b,) = _batches(1, seed=9, points=768 if change == "shape" else 512)
    freeze = change == "freeze"
    if change == "class_weight_values":
        w = w * 2.0
    elif change == "class_weight_layout":
        w = w.double()
    elif change == "cfg":
        cfg = dataclasses.replace(cfg, pred_ignore0=True)
    elif change == "lr":
        optim.set_lr(opt, 0.5 * cfg.learning_rate)
    seen = []
    for _ in range(2):
        tts.train_step(model, opt, b, w, cfg, generator=gen, freeze=freeze)
        seen.append(dict(graphed.counts))
    if change in ("same", "class_weight_values"):
        assert seen == [{"captures": 1, "replays": 2, "eager": 1},
                        {"captures": 1, "replays": 3, "eager": 1}]
    else:
        assert seen == [{"captures": 1, "replays": 1, "eager": 2},
                        {"captures": 2, "replays": 2, "eager": 2}]


@pytest.mark.parametrize("name", list(MODELS))
def test_a_failed_capture_leaves_its_key_eager(graphed, monkeypatch, name):
    """A capture that raises: one warning, the step runs eagerly then and
    after, with the eager steps' results."""
    def refuse(fn, generator, device):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(graphed, "_capture", refuse)
    batches, weights = _batches(3), _weights(3)
    with pytest.warns(RuntimeWarning, match="runs eagerly for this key"):
        got = _run(tts.train_step, name, batches, weights)
    assert graphed.counts == {"captures": 0, "replays": 0, "eager": 3}
    _assert_same(got, _run(tts.eager_step, name, batches, weights))


@pytest.mark.parametrize("outcome", ["captured", "failed"])
@pytest.mark.parametrize("name", list(MODELS))
def test_launch_counters_count_the_launches_on_the_card(graphed, monkeypatch, name, outcome):
    """The kernel wrappers count a launch as they issue it (here a wrapped
    forward counts for them, since the CPU path launches no kernel); a
    capture issues launches that run only at the replays.  Over an eager
    step, a capture and replays, or over steps whose capture failed, the
    counters read a step's launches times the steps."""
    from repsurf_torch.ops.kernels.fps import fps
    from repsurf_torch.ops.kernels.knn_window import knn_window

    monkeypatch.setattr(fps, "launches", 0)
    monkeypatch.setattr(knn_window, "launches_by_k", collections.Counter())
    forward = tts.train_forward

    def counted_forward(model, batch, generator=None):
        fps.launches += 2
        knn_window.launches_by_k[16] += 3
        return forward(model, batch, generator)

    def capture(fn, generator, device):
        fn()  # the wrappers count what the capture records
        if outcome == "failed":
            raise RuntimeError("operation not permitted when stream is capturing")
        return _StubGraph(lambda: _static_outputs(), _static_outputs()), _static_outputs(), []

    monkeypatch.setattr(tts, "train_forward", counted_forward)
    monkeypatch.setattr(graphed, "_capture", capture)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        _run(tts.train_step, name, _batches(4, points=512), _weights(4))
    assert fps.launches == 8 and dict(knn_window.launches_by_k) == {16: 12}
    replays = 3 if outcome == "captured" else 0
    assert graphed.counts == {"captures": int(replays > 0), "replays": replays,
                              "eager": 4 - replays}


class _ClockEvent:
    """A CUDA timing event on the CPU: each record advances a clock by
    1 ms."""

    clock = 0

    def __init__(self, enable_timing=False, external=False):
        self.at = None

    def record(self):
        _ClockEvent.clock += 1
        self.at = _ClockEvent.clock

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.at - self.at)


class _NoGraph:
    """A CUDA graph on the CPU: the capture runs the step, a replay does
    nothing (its outputs stay the capture's)."""

    def register_generator_state(self, generator):
        pass

    def capture_begin(self):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


SPANS = {"repsurf.repsurf_umb_ssg": set(),
         "pointtransformer.pointtransformer": {"pt.attention", "pt.down", "pt.up"}}


@pytest.mark.parametrize("name", list(MODELS))
def test_a_capture_times_the_spans_a_replay_runs(monkeypatch, name):
    """The capture itself (its CUDA calls stood in for) times every span
    of the step on the card, and the whole step as ``train.step``:
    ``span_seconds`` reads them after a replay, the model's spans nested in
    the step's, and reads nothing after a step that was not a replay."""
    monkeypatch.setattr(step_graph, "graphable", lambda inputs, optimizer: True)
    monkeypatch.setattr(step_graph, "_warm", lambda fn, device: fn())
    monkeypatch.setattr(step_graph, "_side_stream", lambda device: None)
    monkeypatch.setattr(step_graph, "counts", {"captures": 0, "replays": 0, "eager": 0})
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _NoGraph)
    monkeypatch.setattr(torch.cuda, "Event", _ClockEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    cfg = tts.SegConfig(model=name)
    model = _model(name)
    opt = tts.make_optimizer(model, cfg)
    gen = _Generator().manual_seed(1)
    (w,) = _weights(1)
    b0, b1 = _batches(2, points=512)
    tts.train_step(model, opt, b0, w, cfg, generator=gen)
    assert step_graph.span_seconds() == {}
    tts.train_step(model, opt, b1, w, cfg, generator=gen)
    assert step_graph.counts == {"captures": 1, "replays": 1, "eager": 1}
    secs = step_graph.span_seconds()
    assert set(secs) == {"train.step", "train.forward", "train.backward",
                         "train.update"} | SPANS[name]
    assert all(v > 0 for v in secs.values())
    assert secs["train.step"] > secs["train.forward"] + secs["train.backward"] \
        + secs["train.update"]
    assert secs["train.forward"] > sum(secs[n] for n in SPANS[name])
    (b2,) = _batches(1, points=768)
    tts.train_step(model, opt, b2, w, cfg, generator=gen)  # a new key: eager
    assert step_graph.span_seconds() == {}


@pytest.mark.parametrize("name", list(MODELS))
def test_cpu_train_step_is_the_eager_step(name):
    """On the CPU nothing is graphable: train_step is the eager step with
    torch's own AdamW (not capturable there) and counts no step."""
    batches, weights = _batches(2, points=512), _weights(2)
    before = dict(step_graph.counts)
    got = _run(tts.train_step, name, batches, weights)
    assert step_graph.counts == before
    assert not got[1].param_groups[0]["capturable"]
    _assert_same(got, _run(tts.eager_step, name, batches, weights))
