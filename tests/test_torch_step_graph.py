"""The classification train step's CUDA graph (``train/step_graph.py``) on
the CPU: the eager path unchanged, the graph's keys, captures and replays
with the capture stubbed (a stub graph runs the step when replayed), the
losses returned, and the two host copies taken off the step's path.

No JAX here: the port's step is held to itself and to torch's own Adam.
"""

import collections
import math
import warnings

import numpy as np
import pytest
import torch

from repsurf_torch.geometry.polar import ieee_div
from repsurf_torch.models import get_model
from repsurf_torch.nn.layers import Dropout
from repsurf_torch.nn.losses import smooth_cls_loss
from repsurf_torch.ops import kernels
from repsurf_torch.ops.kernels import kernel_launches
from repsurf_torch.train import optim, step_graph
from repsurf_torch.train import train_cls as ttc

torch.set_num_threads(1)

NARROW = dict(sa_npoint=(32, 8), sa_nsample=(8, 16), sa_mlp=((8, 8, 16), (16, 16, 32)),
              final_mlp=(32, 32, 64), head_hidden=(32, 16))
CFG = ttc.ClsConfig(num_point=64, batch_size=4)


def _model(seed=0, **kw):
    return get_model("repsurf.repsurf_ssg_umb", generator=torch.Generator().manual_seed(seed),
                     **NARROW, **kw)


def _batches(n, batch=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [(torch.rand(batch, 128, 3, generator=g) * 2 - 1,
             torch.randint(0, 15, (batch,), generator=g)) for _ in range(n)]


class _StubGraph:
    """Stands in for a captured graph on the CPU: a replay runs the
    captured function and writes its outputs into the static ones."""

    def __init__(self, fn, outputs):
        self.fn, self.outputs = fn, outputs

    def replay(self):
        for static, value in zip(self.outputs, self.fn()):
            static.copy_(value)


def _stub_capture(fn, generator, device):
    outputs = (torch.zeros(()), torch.zeros((), dtype=torch.int64))
    return _StubGraph(fn, outputs), outputs, []


@pytest.fixture
def graphed(monkeypatch):
    """The graph path on the CPU: every step graphable, the warm-up on the
    current stream, the capture stubbed; the counts from zero."""
    monkeypatch.setattr(step_graph, "graphable", lambda points, optimizer: True)
    monkeypatch.setattr(step_graph, "_warm", lambda fn, device: fn())
    monkeypatch.setattr(step_graph, "_capture", _stub_capture)
    monkeypatch.setattr(step_graph, "counts", {"captures": 0, "replays": 0, "eager": 0})
    return step_graph


def _run(step, batches, model=None, opt=None, seed=1, cfg=CFG):
    model = _model() if model is None else model
    opt = ttc.make_optimizer(model, cfg) if opt is None else opt
    gen = torch.Generator().manual_seed(seed)
    out = [step(model, opt, p, t, cfg, generator=gen) for p, t in batches]
    return model, opt, out


def _assert_same(a, b):
    (ma, _, outs_a), (mb, _, outs_b) = a, b
    for (la, ca), (lb, cb) in zip(outs_a, outs_b):
        assert torch.equal(la, lb) and torch.equal(ca, cb)
    sb = mb.state_dict()
    for k, v in ma.state_dict().items():
        assert torch.equal(v, sb[k]), k


def test_cpu_train_step_is_the_eager_step_with_torch_adam():
    """On the CPU nothing is graphable: train_step runs forward, loss,
    backward and torch's own Adam (not capturable there) as before, and
    counts no step."""
    batches = _batches(3)
    before = dict(step_graph.counts)
    assert not step_graph.graphable({"points": batches[0][0], "target": batches[0][1]},
                                    ttc.make_optimizer(_model(), CFG))
    got = _run(ttc.train_step, batches)

    def old_step(model, opt, points, target, cfg, generator):
        logp = ttc.train_forward(model, points, cfg, generator)
        loss = smooth_cls_loss(logp, target)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach(), (logp.detach().argmax(-1) == target).sum()

    model = _model()
    adam = torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    _assert_same(got, _run(old_step, batches, model, adam))
    assert step_graph.counts == before
    assert not got[1].param_groups[0]["capturable"]


def test_graph_path_replays_the_eager_steps(graphed):
    """One eager step, one capture, then replays through the static
    buffers: the same losses, counts and parameters as the eager steps."""
    batches = _batches(5)
    _assert_same(_run(ttc.train_step, batches), _run(ttc.eager_step, batches))
    assert graphed.counts == {"captures": 1, "replays": 4, "eager": 1}


@pytest.mark.parametrize("change", ["same", "lr", "shape", "optimizer", "generator", "signs",
                                    "load_state_dict"])
def test_graph_key(graphed, change):
    """The same key reuses its capture; a new rate, input shape, optimizer,
    generator, signs or optimizer state make a new one, itself after one
    eager step."""
    model = _model()
    opt = ttc.make_optimizer(model, CFG)
    gen = torch.Generator().manual_seed(1)
    for p, t in _batches(3):
        ttc.train_step(model, opt, p, t, CFG, generator=gen)
    assert graphed.counts == {"captures": 1, "replays": 2, "eager": 1}
    (p, t), = _batches(1, batch=2 if change == "shape" else 4, seed=9)
    signs = None
    if change == "lr":
        optim.set_lr(opt, 0.5e-3)
    elif change == "optimizer":
        opt = ttc.make_optimizer(model, CFG)
    elif change == "generator":
        gen = torch.Generator().manual_seed(1)
    elif change == "signs":
        signs = torch.ones(4)
    elif change == "load_state_dict":
        opt.load_state_dict(opt.state_dict())
    for _ in range(3):
        ttc.train_step(model, opt, p, t, CFG, generator=gen, signs=signs)
    if change == "same":
        assert graphed.counts == {"captures": 1, "replays": 5, "eager": 1}
    else:
        assert graphed.counts == {"captures": 2, "replays": 4, "eager": 2}


def test_a_new_key_replaces_the_optimizers_graph(graphed):
    """An optimizer holds the graph of its latest key alone: going back to
    an earlier key is a new eager step and a new capture."""
    model = _model()
    opt = ttc.make_optimizer(model, CFG)
    gen = torch.Generator().manual_seed(1)
    for lr in (1e-3, 0.7e-3, 1e-3):
        optim.set_lr(opt, lr)
        for p, t in _batches(2):
            ttc.train_step(model, opt, p, t, CFG, generator=gen)
    assert graphed.counts == {"captures": 3, "replays": 3, "eager": 3}
    key, entry = graphed._GRAPHS[opt]
    assert entry.graph is not None and ("lr", 1e-3) in key[-1][0]


def test_a_failed_capture_leaves_its_key_eager(graphed, monkeypatch):
    """A capture that raises: the step runs eagerly then and after, with
    the eager steps' results."""
    def refuse(fn, generator, device):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(graphed, "_capture", refuse)
    signs = torch.tensor([1.0, -1.0, 1.0, -1.0])
    batches = _batches(4)

    def run(step):
        model = _model(head_dropout=0.0)
        opt = ttc.make_optimizer(model, CFG)
        out = [step(model, opt, p, t, CFG, signs=signs) for p, t in batches]
        return model, opt, out

    with pytest.warns(RuntimeWarning, match="runs eagerly for this key"):
        graphed_run = run(ttc.train_step)
    _assert_same(graphed_run, run(ttc.eager_step))
    assert graphed.counts == {"captures": 0, "replays": 0, "eager": 4}


@pytest.mark.parametrize("outcome", ["captured", "failed"])
def test_launch_counters_count_the_launches_on_the_card(graphed, monkeypatch, outcome):
    """A wrapper counts a launch as it issues it; a capture issues
    launches that run only at the replays.  Over an eager step, a capture
    and replays, or over steps whose capture failed, the counters read the
    launches that ran: a step's count times the steps."""
    from repsurf_torch.ops.kernels.batch_norm import batch_norm
    from repsurf_torch.ops.kernels.fps import fps

    monkeypatch.setattr(fps, "launches", 0)
    monkeypatch.setattr(fps, "launches_by_shape", collections.Counter())
    monkeypatch.setattr(batch_norm, "launches", dict.fromkeys(batch_norm.launches, 0))

    def step(points=None, target=None):
        fps.launches += 1
        fps.launches_by_shape["4x128->64"] += 1
        batch_norm.launches["stats"] += 3
        return points.sum(), target.sum()

    def capture(fn, generator, device):
        fn()  # the wrappers count what the capture records
        if outcome == "failed":
            raise RuntimeError("operation not permitted when stream is capturing")
        return (_StubGraph(lambda: (), ()), (torch.zeros(()), torch.zeros((), dtype=torch.int64)),
                [])

    monkeypatch.setattr(graphed, "_capture", capture)
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(model.parameters())
    points, target = _batches(1)[0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for _ in range(5):
            step_graph.run(step, model, opt, {"points": points, "target": target})
    assert fps.launches == 5 and dict(fps.launches_by_shape) == {"4x128->64": 5}
    assert batch_norm.launches == {"stats": 15, "normalize": 0, "backward": 0, "eval": 0}
    replays = 4 if outcome == "captured" else 0
    assert graphed.counts == {"captures": int(replays > 0), "replays": replays,
                              "eager": 5 - replays}


def test_train_epoch_averages_each_steps_own_loss(graphed, monkeypatch):
    """Replayed steps return losses of their own, never the graph's
    buffer: the epoch's mean is the mean of distinct per-step losses, the
    eager epoch's."""
    from repsurf_torch.data.scanobjectnn import SyntheticClouds

    data = SyntheticClouds(n_samples=16, n_points=128, seed=0)
    seen = []
    real = ttc.train_step

    def recording(*args, **kw):
        out = real(*args, **kw)
        seen.append(out[0])
        return out

    monkeypatch.setattr(ttc, "train_step", recording)

    def epoch():
        model = _model()
        opt = ttc.make_optimizer(model, CFG)
        return ttc.train_epoch(model, opt, data, CFG, 0, torch.Generator().manual_seed(2),
                               rng=np.random.RandomState(0))

    graph_loss, graph_acc = epoch()
    assert graphed.counts == {"captures": 1, "replays": 3, "eager": 1}
    losses = [float(x) for x in seen]
    assert len(set(losses)) == len(losses) == 4
    assert graph_loss == pytest.approx(sum(losses) / 4, rel=1e-6)
    monkeypatch.setattr(graphed, "graphable", lambda points, optimizer: False)
    assert epoch() == (graph_loss, graph_acc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ieee_div_and_dropout_equal_their_host_copy_forms(dtype):
    """The divisors filled on the device give the old torch.tensor forms'
    bits."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(64, 33, 3, generator=g) * 10).to(dtype)
    for c in (math.pi, 2 * math.pi, 3.0, math.sqrt(3.0), 0.6, 1e-3):
        assert torch.equal(ieee_div(x, c), x / torch.tensor(c, dtype=dtype))
    drop = Dropout(0.4).train()
    for p in (0.4, 0.5, 0.1):
        drop.p = p
        got = drop(x, generator=torch.Generator().manual_seed(3))
        keep = 1.0 - p
        mask = torch.rand(x.shape, generator=torch.Generator().manual_seed(3)) < keep
        assert torch.equal(got, torch.where(mask, x / torch.tensor(keep, dtype=dtype), 0.0))


def test_kernel_launches_carry_the_step_graph():
    counts = kernel_launches()["step_graph"]
    assert set(counts) == {"captures", "replays", "eager"}
    assert all(isinstance(v, int) for v in counts.values())
    assert counts == step_graph.counts is kernels.step_graph
    assert counts is not step_graph.counts  # a copy, as the other counters


def test_add_launches_takes_back_and_adds_again(monkeypatch):
    """``launches_since`` holds only what moved; ``add_launches`` with
    -1 restores the counters, with 2 counts the launches twice more."""
    from repsurf_torch.ops.kernels.ball_group import ball_group_feature
    from repsurf_torch.ops.kernels.umbrella import umbrella_features_kernel as umbrella

    monkeypatch.setattr(ball_group_feature, "launches_by_channels",
                        collections.Counter({13: 2}))
    monkeypatch.setattr(umbrella, "launches", {"tq": 1, "full": 0, "slab": 0})
    before = kernels.launch_counts()
    ball_group_feature.launches_by_channels[13] += 1
    ball_group_feature.launches_by_channels[141] += 1
    umbrella.launches["tq"] += 2
    delta = kernels.launches_since(before)
    assert sorted((a, d) for _, a, d in delta) == [
        ("launches", {"tq": 2}), ("launches_by_channels", {13: 1, 141: 1})]
    kernels.add_launches(delta, -1)
    assert kernels.launches_since(before) == []
    kernels.add_launches(delta, 2)
    assert dict(ball_group_feature.launches_by_channels) == {13: 4, 141: 2}
    assert umbrella.launches == {"tq": 5, "full": 0, "slab": 0}
