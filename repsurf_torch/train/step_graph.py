"""A training step captured once as a CUDA graph and replayed
(``train_cls.train_step``).

The step's work (the forward with its kernels and random draws, the loss,
the backward and the optimizer's update) is hundreds of short launches,
issued by Python and autograd.  Replaying a captured graph issues them as
one launch, with the same kernels and the same arithmetic.

``run`` keeps the graph of an optimizer's latest key; a new key replaces
it, since a graph holds a step's activations and gradients in its own
memory pool.  The key is what the step can observe: the model and the
optimizer (neither kept alive by the graph: graphs hang off the optimizer in
a weak dictionary, the model is weakly referenced), the
generator, the inputs' shapes, dtypes and device, whether signs are given,
the step's configuration and every scalar hyperparameter of each parameter
group, so a ``set_lr`` between epochs gives a new capture rather than a
graph that keeps the old rate; an optimizer's ``load_state_dict`` (new
state tensors) also gives a new capture.  For a key:

* the first call runs the step eagerly, on the capture's side stream: it
  makes the optimizer's state, cuBLAS's handles and autograd's buffers;
* the second captures the step into the graph's static buffers (the
  gradients included), then replays it;
* every later call copies its inputs into those buffers on the device and
  replays.  The returned (loss, correct) are copies, never the buffers.

The generator is registered with the graph (torch's graph-safe generator
state), so a replay draws what the eager step would and advances the
generator as far.  A capture that fails (a host read inside the step, say)
restores the generator, warns, and leaves its key eager; it never stops
training.

The kernel wrappers count a launch as they issue it, and a capture issues
launches that run only at the replays: the capture's counts are taken back
and each replay adds them again (``ops.kernels.add_launches``), so the
launch counters stay counts of launches on the card.

``graphable`` says where this applies: CUDA inputs, no process group, an
optimizer whose every group is ``capturable`` (``optim.make_adam`` on CUDA
parameters outside a process group).
``counts`` (``captures``, ``replays``, ``eager``: CUDA steps run without a
graph) is ``ops.kernels.step_graph``, read by ``kernel_launches()``.
"""

import warnings
import weakref

import torch

from ..ops.kernels import add_launches, launch_counts, launches_since
from ..ops.kernels import step_graph as counts
from ..utils.spans import span

_GRAPHS = weakref.WeakKeyDictionary()  # optimizer -> (key, _Entry)
_STREAMS = {}  # device index -> the side stream of warm-ups and captures


def graphable(points, optimizer):
    """Whether ``run`` may capture a step on ``points``."""
    if not points.is_cuda:
        return False
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return False
    return all(g.get("capturable", False) for g in optimizer.param_groups)


def _hyperparameters(optimizer):
    scalar = (bool, int, float, str, tuple, type(None))
    return tuple(tuple((k, v) for k, v in sorted(g.items())
                       if k != "params" and isinstance(v, scalar))
                 for g in optimizer.param_groups)


def _layout(t):
    return None if t is None else (tuple(t.shape), t.dtype)


def _key(model, optimizer, points, target, generator, signs, config):
    return (id(model), None if generator is None else id(generator), points.device,
            _layout(points), _layout(target), _layout(signs), config,
            _hyperparameters(optimizer))


class _Entry:
    """One key's state: eager until captured; then the graph, its static
    inputs and outputs."""

    def __init__(self, model, optimizer, generator):
        self.model = weakref.ref(model)
        self.state = optimizer.state  # the graph updates these tensors
        self.generator = generator  # held: the key names it by id
        self.graph = None
        self.failed = False
        self.launches = []  # the kernel launches a replay runs (launches_since)

    def replay(self, model, points, target, signs):
        with span("train.forward"):
            model.train()
            self.points.copy_(points)
            self.target.copy_(target)
            if signs is not None:
                self.signs.copy_(signs)
            self.graph.replay()
            add_launches(self.launches)
            return self.loss.clone(), self.correct.clone()


def _side_stream(device):
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(index)
    return _STREAMS[index]


def _warm(fn, device):
    """``fn()`` eagerly on the side stream, ordered after and before the
    current stream's work."""
    side, current = _side_stream(device), torch.cuda.current_stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = fn()
    current.wait_stream(side)
    return out


def _capture(fn, generator, device):
    """Capture ``fn()`` on the side stream -> (graph, its outputs)."""
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    torch.cuda.synchronize(device)
    with torch.cuda.stream(_side_stream(device)):
        graph.capture_begin()
        try:
            out = fn()
        finally:
            graph.capture_end()
    return graph, out


def _try_capture(entry, step, model, optimizer, points, target, generator, signs):
    entry.points, entry.target = points.clone(), target.clone()
    entry.signs = None if signs is None else signs.clone()
    saved = None if generator is None else generator.clone_state()
    optimizer.zero_grad(set_to_none=True)  # the backward makes them in the graph's pool
    before = launch_counts()
    try:
        entry.graph, (entry.loss, entry.correct) = _capture(
            lambda: step(model, optimizer, entry.points, entry.target, generator=generator,
                         signs=entry.signs),
            generator, points.device)
    except RuntimeError as e:
        add_launches(launches_since(before), -1)  # issued, never run
        warnings.warn(f"a CUDA graph capture of the train step failed; the step runs "
                      f"eagerly for this key: {e}", RuntimeWarning, stacklevel=4)
        entry.failed, entry.graph = True, None
        entry.points = entry.target = entry.signs = None
        if saved is not None:
            generator.graphsafe_set_state(saved)
        optimizer.zero_grad(set_to_none=True)
        return
    entry.launches = launches_since(before)
    add_launches(entry.launches, -1)  # they run at the replays
    counts["captures"] += 1


def run(step, model, optimizer, points, target, generator=None, signs=None, config=None):
    """``step(model, optimizer, points, target, generator=, signs=) ->
    (loss, correct)``, run eagerly, captured or replayed as the module
    docstring says; ``config`` (hashable) is the rest of what ``step``
    computes from."""
    key = _key(model, optimizer, points, target, generator, signs, config)
    held, entry = _GRAPHS.get(optimizer, (None, None))
    if held != key or entry.model() is not model or entry.state is not optimizer.state:
        _GRAPHS[optimizer] = key, _Entry(model, optimizer, generator)
        counts["eager"] += 1
        return _warm(lambda: step(model, optimizer, points, target, generator=generator,
                                  signs=signs), points.device)
    if entry.graph is None and not entry.failed:
        _try_capture(entry, step, model, optimizer, points, target, generator, signs)
    if entry.failed:
        counts["eager"] += 1
        return step(model, optimizer, points, target, generator=generator, signs=signs)
    counts["replays"] += 1
    return entry.replay(model, points, target, signs)
