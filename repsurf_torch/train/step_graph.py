"""A training step captured once as a CUDA graph and replayed
(``train_cls.train_step``, ``train_seg.train_step``).

The step's work (the forward with its kernels and random draws, the loss,
the backward and the optimizer's update) is hundreds of short launches,
issued by Python and autograd.  Replaying a captured graph issues them as
one launch, with the same kernels and the same arithmetic.

A step is ``step(**inputs)``, the model, optimizer and generator bound
in it: ``inputs`` a flat mapping of names to tensors (None for one not
given), its result any nest of tuples and lists of tensors.  Where
``graphable`` does not hold, ``run`` is the step.  ``run`` keeps the graph of an
optimizer's latest key; a new key replaces it, since a graph holds a
step's activations and gradients in its own memory pool.  The key is what
the step can observe: the model and the optimizer (neither kept alive by
the graph: graphs hang off the optimizer in a weak dictionary, the model is
weakly referenced), the generator, each input's name, shape, dtype and
device, the step's configuration and every scalar hyperparameter of each
parameter group, so a ``set_lr`` between epochs gives a new capture rather
than a graph that keeps the old rate; an optimizer's ``load_state_dict``
(new state tensors) also gives a new capture.  For a key:

* the first call runs the step eagerly, on the capture's side stream: it
  makes the optimizer's state, cuBLAS's handles and autograd's buffers;
* the second frees the blocks the allocator caches (the eager step's
  activations), so that the graph's pool can take them, captures the step
  into the graph's static buffers (the gradients included), then replays
  it;
* every later call copies its inputs into those buffers on the device and
  replays.  The returned tensors are copies, never the buffers.

The generator is registered with the graph (torch's graph-safe generator
state), so a replay draws what the eager step would and advances the
generator as far.  A capture that fails (a host read inside the step, say)
restores the generator, warns, and leaves its key eager; it never stops
training.

A replay issues none of the spans inside the step (``utils/spans.py``),
so the capture times them on the card: it runs the step in
``spans.timing()`` and within a ``train.step`` span of its own, and
``span_seconds`` reads the latest replay's device seconds under each
span's name (the whole step's under ``train.step``).

The kernel wrappers count a launch as they issue it, and a capture issues
launches that run only at the replays: the capture's counts are taken back
and each replay adds them again (``ops.kernels.add_launches``), so the
launch counters stay counts of launches on the card.

``graphable`` says where this applies: CUDA inputs, no process group, an
optimizer whose every group is ``capturable`` (``optim.make_adam`` and
``optim.make_adamw`` on CUDA parameters outside a process group).
``counts`` (``captures``, ``replays``, ``eager``: CUDA steps run without a
graph) is ``ops.kernels.step_graph``, read by ``kernel_launches()``.
"""

import warnings
import weakref

import torch

from ..ops.kernels import add_launches, launch_counts, launches_since
from ..ops.kernels import step_graph as counts
from ..utils.spans import device_seconds, span, timing

_GRAPHS = weakref.WeakKeyDictionary()  # optimizer -> (key, _Entry)
_STREAMS = {}  # device index -> the side stream of warm-ups and captures
_latest = None  # the event pairs of the latest step on the card, when it was a replay


def graphable(inputs, optimizer):
    """Whether ``run`` may capture a step on ``inputs`` (names to tensors
    or None)."""
    if not all(t.is_cuda for t in inputs.values() if t is not None):
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
    return None if t is None else (tuple(t.shape), t.dtype, t.device)


def _key(model, optimizer, inputs, generator, config):
    return (id(model), None if generator is None else id(generator),
            tuple((name, _layout(t)) for name, t in sorted(inputs.items())), config,
            _hyperparameters(optimizer))


def _device(inputs):
    return next(t.device for t in inputs.values() if t is not None)


def _clone(nest):
    """A copy of a nest of tuples and lists of tensors."""
    if isinstance(nest, torch.Tensor):
        return nest.clone()
    return type(nest)(_clone(v) for v in nest)


class _Entry:
    """One key's state: eager until captured; then the graph, its static
    inputs and outputs."""

    def __init__(self, model, optimizer, generator):
        self.model = weakref.ref(model)
        self.state = optimizer.state  # the graph updates these tensors
        self.generator = generator  # held: the key names it by id
        self.graph = None
        self.failed = False
        self.inputs = self.outputs = None
        self.launches = []  # the kernel launches a replay runs (launches_since)
        self.timed = []  # the captured spans' event pairs (spans.timing)

    def replay(self, model, inputs):
        with span("train.forward"):
            model.train()
            for name, t in inputs.items():
                if t is not None:
                    self.inputs[name].copy_(t)
            self.graph.replay()
            add_launches(self.launches)
            return _clone(self.outputs)


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
    """Capture ``fn()`` on the side stream, its spans timed -> (graph, its
    outputs, the spans' event pairs).  The blocks the allocator caches are
    freed first: the graph's pool takes its memory from the card, and a
    step's activations held twice, cached and in the pool, may not fit."""
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    with torch.cuda.stream(_side_stream(device)), timing() as timed:
        graph.capture_begin()
        try:
            with span("train.step"):
                out = fn()
        finally:
            graph.capture_end()
    return graph, out, timed


def _try_capture(entry, step, model, optimizer, inputs, generator):
    entry.inputs = {name: None if t is None else t.clone() for name, t in inputs.items()}
    saved = None if generator is None else generator.clone_state()
    optimizer.zero_grad(set_to_none=True)  # the backward makes them in the graph's pool
    before = launch_counts()
    try:
        entry.graph, entry.outputs, entry.timed = _capture(
            lambda: step(**entry.inputs), generator, _device(inputs))
    except RuntimeError as e:
        add_launches(launches_since(before), -1)  # issued, never run
        warnings.warn(f"a CUDA graph capture of the train step failed; the step runs "
                      f"eagerly for this key: {e}", RuntimeWarning, stacklevel=4)
        entry.failed, entry.graph = True, None
        entry.inputs = entry.outputs = None
        if saved is not None:
            generator.graphsafe_set_state(saved)
        optimizer.zero_grad(set_to_none=True)
        return
    entry.launches = launches_since(before)
    add_launches(entry.launches, -1)  # they run at the replays
    counts["captures"] += 1


def run(step, model, optimizer, inputs, generator=None, config=None):
    """``step(**inputs)`` -> a nest of tensors: run eagerly, captured or
    replayed as the module docstring says where ``graphable`` holds, else
    just run.  ``step`` updates ``model`` with ``optimizer`` and draws from
    ``generator``; ``config`` (hashable) is the rest of what it computes
    from."""
    global _latest
    if not graphable(inputs, optimizer):
        return step(**inputs)
    _latest = None
    key = _key(model, optimizer, inputs, generator, config)
    held, entry = _GRAPHS.get(optimizer, (None, None))
    if held != key or entry.model() is not model or entry.state is not optimizer.state:
        _GRAPHS[optimizer] = key, _Entry(model, optimizer, generator)
        counts["eager"] += 1
        return _warm(lambda: step(**inputs), _device(inputs))
    if entry.graph is None and not entry.failed:
        _try_capture(entry, step, model, optimizer, inputs, generator)
    if entry.failed:
        counts["eager"] += 1
        return step(**inputs)
    counts["replays"] += 1
    _latest = entry.timed  # not the entry: that would keep its graph's pool
    return entry.replay(model, inputs)


def span_seconds():
    """{span name: device seconds} of the latest train step on the card
    when it was a replay (``train.step`` the whole step), else {}.  Waits
    for the replay to end."""
    return {} if _latest is None else device_seconds(_latest)
